"""T5 / UMT5 encoder config (port of
fastvideo_tpu/configs/models/encoders/t5.py). Wan's UMT5-XXL arrives through
the checkpoint's config.json (d_model 4096, d_ff 10240, 64 heads, 24
layers, gated-gelu, a relative attention bias in every layer)."""

from __future__ import annotations

import dataclasses

from fastvideo_tpu_torch.configs.models.base import (EncoderArchConfig,
                                                     ModelConfig)

# HF T5/UMT5 checkpoint names -> the port's module paths
T5_PARAM_NAMES_MAPPING: dict[str, str] = {
    r"^shared\.weight$": r"shared.weight",
    r"^encoder\.block\.(\d+)\.layer\.0\.SelfAttention\.(q|k|v|o)\.(.*)$":
    r"blocks.\1.self_attn.\2.\3",
    r"^encoder\.block\.(\d+)\.layer\.0\.SelfAttention\.relative_attention_bias\.(.*)$":
    r"blocks.\1.self_attn.relative_attention_bias.\2",
    r"^encoder\.block\.(\d+)\.layer\.0\.layer_norm\.(.*)$":
    r"blocks.\1.self_attn_layer_norm.\2",
    r"^encoder\.block\.(\d+)\.layer\.1\.DenseReluDense\.(wi_0|wi_1|wi|wo)\.(.*)$":
    r"blocks.\1.ff.\2.\3",
    r"^encoder\.block\.(\d+)\.layer\.1\.layer_norm\.(.*)$":
    r"blocks.\1.ff_layer_norm.\2",
    r"^encoder\.final_layer_norm\.(.*)$": r"final_layer_norm.\1",
}


@dataclasses.dataclass
class T5ArchConfig(EncoderArchConfig):
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"
    is_gated_act: bool = False
    dense_act_fn: str = "relu"
    pad_token_id: int = 0
    eos_token_id: int = 1
    text_len: int = 512
    # UMT5: every layer carries its own relative attention bias
    is_umt5: bool = False

    def __post_init__(self):
        if self.feed_forward_proj.startswith("gated-"):
            self.is_gated_act = True
            self.dense_act_fn = self.feed_forward_proj.split("-", 1)[1]
        elif self.feed_forward_proj:
            self.dense_act_fn = self.feed_forward_proj
        if self.dense_act_fn == "gelu_new":
            self.dense_act_fn = "gelu_pytorch_tanh"


@dataclasses.dataclass
class T5Config(ModelConfig):
    arch_config: T5ArchConfig = dataclasses.field(default_factory=T5ArchConfig)
    param_names_mapping: dict[str, str] = dataclasses.field(
        default_factory=lambda: dict(T5_PARAM_NAMES_MAPPING))
