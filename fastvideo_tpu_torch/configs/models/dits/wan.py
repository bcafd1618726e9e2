"""Wan DiT architecture config (port of
fastvideo_tpu/configs/models/dits/wan.py). Defaults are the 14B sizes; the
checkpoint's config.json resizes them. The causal Wan reads three more
fields: ``local_attn_size``, ``sink_size`` and ``num_frames_per_block``;
AnyFlow's dual-timestep branch four more (``r_embedder*``)."""

from __future__ import annotations

import dataclasses

from fastvideo_tpu_torch.configs.models.base import DiTArchConfig, ModelConfig

# diffusers WanTransformer3DModel checkpoint names -> the port's module
# paths. The port's PatchEmbed3D holds the 5-D conv weight itself, so
# ``patch_embedding.*`` needs no rule (the JAX package maps it to
# ``patch_embedding.proj.*``); names already in the port's layout pass
# through unchanged.
WAN_PARAM_NAMES_MAPPING: dict[str, str] = {
    r"^condition_embedder\.text_embedder\.linear_1\.(.*)$":
    r"condition_embedder.text_embedder.fc_in.\1",
    r"^condition_embedder\.text_embedder\.linear_2\.(.*)$":
    r"condition_embedder.text_embedder.fc_out.\1",
    r"^condition_embedder\.time_embedder\.linear_1\.(.*)$":
    r"condition_embedder.time_embedder.mlp.fc_in.\1",
    r"^condition_embedder\.time_embedder\.linear_2\.(.*)$":
    r"condition_embedder.time_embedder.mlp.fc_out.\1",
    r"^condition_embedder\.delta_embedder\.linear_1\.(.*)$":
    r"condition_embedder.delta_embedder.mlp.fc_in.\1",
    r"^condition_embedder\.delta_embedder\.linear_2\.(.*)$":
    r"condition_embedder.delta_embedder.mlp.fc_out.\1",
    r"^condition_embedder\.time_proj\.(.*)$":
    r"condition_embedder.time_modulation.linear.\1",
    r"^blocks\.(\d+)\.attn1\.to_q\.(.*)$": r"blocks.\1.to_q.\2",
    r"^blocks\.(\d+)\.attn1\.to_k\.(.*)$": r"blocks.\1.to_k.\2",
    r"^blocks\.(\d+)\.attn1\.to_v\.(.*)$": r"blocks.\1.to_v.\2",
    r"^blocks\.(\d+)\.attn1\.to_out\.0\.(.*)$": r"blocks.\1.to_out.\2",
    r"^blocks\.(\d+)\.attn1\.norm_q\.(.*)$": r"blocks.\1.norm_q.\2",
    r"^blocks\.(\d+)\.attn1\.norm_k\.(.*)$": r"blocks.\1.norm_k.\2",
    r"^blocks\.(\d+)\.attn2\.to_out\.0\.(.*)$": r"blocks.\1.attn2.to_out.\2",
    r"^blocks\.(\d+)\.ffn\.net\.0\.proj\.(.*)$": r"blocks.\1.ffn.fc_in.\2",
    r"^blocks\.(\d+)\.ffn\.net\.2\.(.*)$": r"blocks.\1.ffn.fc_out.\2",
    r"^blocks\.(\d+)\.norm2\.(.*)$":
    r"blocks.\1.self_attn_residual_norm.norm.\2",
}

# Official (non-diffusers) LoRA layer names -> diffusers names, applied
# before the main mapping.
WAN_LORA_PARAM_NAMES_MAPPING: dict[str, str] = {
    r"^blocks\.(\d+)\.self_attn\.q\.(.*)$": r"blocks.\1.attn1.to_q.\2",
    r"^blocks\.(\d+)\.self_attn\.k\.(.*)$": r"blocks.\1.attn1.to_k.\2",
    r"^blocks\.(\d+)\.self_attn\.v\.(.*)$": r"blocks.\1.attn1.to_v.\2",
    r"^blocks\.(\d+)\.self_attn\.o\.(.*)$": r"blocks.\1.attn1.to_out.0.\2",
    r"^blocks\.(\d+)\.cross_attn\.q\.(.*)$": r"blocks.\1.attn2.to_q.\2",
    r"^blocks\.(\d+)\.cross_attn\.k\.(.*)$": r"blocks.\1.attn2.to_k.\2",
    r"^blocks\.(\d+)\.cross_attn\.v\.(.*)$": r"blocks.\1.attn2.to_v.\2",
    r"^blocks\.(\d+)\.cross_attn\.o\.(.*)$": r"blocks.\1.attn2.to_out.0.\2",
    r"^blocks\.(\d+)\.ffn\.0\.(.*)$": r"blocks.\1.ffn.fc_in.\2",
    r"^blocks\.(\d+)\.ffn\.2\.(.*)$": r"blocks.\1.ffn.fc_out.\2",
}


@dataclasses.dataclass
class WanArchConfig(DiTArchConfig):
    patch_size: tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    num_attention_heads: int = 40
    attention_head_dim: int = 128
    in_channels: int = 16
    out_channels: int = 16
    text_dim: int = 4096
    freq_dim: int = 256
    ffn_dim: int = 13824
    num_layers: int = 40
    cross_attn_norm: bool = True
    qk_norm: str = "rms_norm_across_heads"
    eps: float = 1e-6
    image_dim: int | None = None
    added_kv_proj_dim: int | None = None
    rope_max_seq_len: int = 1024
    rope_theta: float = 10000.0
    # causal Wan: latent frames an attention window holds (-1: the default
    # of 21 that ``init_caches`` takes), frames of it frozen as a sink, and
    # latent frames generated per autoregressive block
    local_attn_size: int = -1
    sink_size: int = 0
    num_frames_per_block: int = 3
    # AnyFlow dual-timestep (t, r) conditioning: a second time embedder
    # (``delta_embedder``) whose output is fused into temb
    r_embedder: bool = False
    r_embedder_fusion: str = "additive"  # or "gated"
    r_embedder_gate_value: float = 0.25
    r_embedder_deltatime_type: str = "r"  # or "t-r"

    @property
    def hidden_size(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def num_channels_latents(self) -> int:
        return self.out_channels


@dataclasses.dataclass
class WanVideoConfig(ModelConfig):
    arch_config: WanArchConfig = dataclasses.field(
        default_factory=WanArchConfig)
    param_names_mapping: dict[str, str] = dataclasses.field(
        default_factory=lambda: dict(WAN_PARAM_NAMES_MAPPING))
    lora_param_names_mapping: dict[str, str] = dataclasses.field(
        default_factory=lambda: dict(WAN_LORA_PARAM_NAMES_MAPPING))
