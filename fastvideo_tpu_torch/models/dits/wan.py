"""Wan DiT, text- and image-to-video (port of
fastvideo_tpu/models/dits/wan.py): Wan2.1, and Wan2.2's, whose TI2V and
Lucy Edit forms take a timestep per token (``timestep`` [B, S]) and so a
modulation per token.

With ``image_dim`` and ``added_kv_proj_dim`` set (the I2V checkpoints) the
condition embedder projects the CLIP image tokens (``image_embedder``) and
puts them in front of the text context, and each block's cross-attention
attends the first 257 context tokens through its own K/V projections and
the rest through the text ones, the two outputs summed.

Module names follow the JAX package, so the port's ``state_dict()`` keys
are the torch-layout keys that ``fastvideo_tpu.models.loader.export`` writes.
The AdaLN modulation runs in fp32 with bf16 activations. The blocks'
self-attention takes the backend selected when the model is built
(FLASH_ATTN, SLIDING_TILE_ATTN, SLA_ATTN or VIDEO_SPARSE_ATTN). With the
VIDEO_SPARSE_ATTN backend the blocks carry ``to_gate_compress`` and the
whole transformer runs in tile-major token order: the permutation is
applied once after patch embedding (with the RoPE tables) and undone once
before the output projection. On a token grid with no exact tile that order
is the padded one: the padded slots enter as zeros (tokens and RoPE
tables), collect bias terms as they pass the blocks, are zeroed again by
the backend before every attention, and are dropped by the final untiling.

``gradient_checkpointing`` (set by the trainer) runs each block under
``torch.utils.checkpoint`` when grad is enabled: the block's activations
are recomputed in the backward, as JAX wraps each block in
``jax.checkpoint``. The checkpointed block is bound to the forward context
of the forward (``bind_forward_context``), so its recompute picks the same
VSA tiles on whatever thread autograd runs it. With
``gradient_checkpointing_policy = "ops"`` (``selective_checkpointing="ops"``)
the checkpoint keeps the outputs of the matmuls (``aten.mm`` /
``aten.addmm``: the linears, JAX's ``dots_with_no_batch_dims_saveable``)
and recomputes the rest of the block, attention included.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.utils.checkpoint
from torch import nn

from fastvideo_tpu_torch.attention import DistributedAttention, LocalAttention
from fastvideo_tpu_torch.attention.backends.vsa import resolve_vsa_tile
from fastvideo_tpu_torch.attention.selector import resolve_backend_name
from fastvideo_tpu_torch.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu_torch.forward_context import bind_forward_context
from fastvideo_tpu_torch.layers.embeddings import (ModulateProjection,
                                                   PatchEmbed3D,
                                                   TimestepEmbedder,
                                                   unpatchify)
from fastvideo_tpu_torch.layers.linear import Linear
from fastvideo_tpu_torch.layers.mlp import MLP
from fastvideo_tpu_torch.layers.norm import (FP32LayerNorm,
                                             LayerNormScaleShift, RMSNorm,
                                             ScaleResidual,
                                             ScaleResidualLayerNormScaleShift)
from fastvideo_tpu_torch.layers.rotary import get_rotary_pos_embed_wan
from fastvideo_tpu_torch.ops.vsa import (tile_tokens, tile_tokens_exact,
                                         untile_tokens, untile_tokens_exact)


# the matmuls whose outputs "ops" keeps: the linears (a 2-D product, or a
# flattened 3-D input, with or without bias)
SAVED_UNDER_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def checkpoint_policy_kwargs(policy: str | None) -> dict:
    """``torch.utils.checkpoint.checkpoint``'s extra arguments for a remat
    policy: none for None (recompute the whole block), a selective context
    that saves :data:`SAVED_UNDER_OPS` for "ops"."""
    if policy is None:
        return {}
    if policy != "ops":
        raise ValueError(f"unknown remat policy {policy!r}")
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, list(SAVED_UNDER_OPS))}


class WanImageEmbedding(nn.Module):
    """CLIP image feature projector: fp32 LayerNorm, GELU MLP, fp32
    LayerNorm, cast back to the input dtype."""

    def __init__(self, in_features: int, out_features: int, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = FP32LayerNorm(in_features, **kw)
        self.ff = MLP(in_features, in_features, out_features, act_type="gelu",
                      **kw)
        self.norm2 = FP32LayerNorm(out_features, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm2(self.ff(self.norm1(x))).to(x.dtype)


class WanTimeTextImageEmbedding(nn.Module):
    """Time, text and (with ``image_embed_dim``) image conditioning.

    With ``r_embedder`` (AnyFlow's dual-timestep branch) a second
    ``TimestepEmbedder``, ``delta_embedder``, embeds r (or t - r) and is
    fused into temb by a fixed gate g: ``additive`` temb + g delta, or
    ``gated`` (1 - g) temb + g delta."""

    def __init__(self, dim: int, time_freq_dim: int, text_embed_dim: int,
                 image_embed_dim: int | None = None, *,
                 r_embedder: bool = False, r_embedder_fusion: str = "additive",
                 r_embedder_gate_value: float = 0.25,
                 r_embedder_deltatime_type: str = "r", device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.time_embedder = TimestepEmbedder(
            dim, frequency_embedding_size=time_freq_dim, act_layer="silu",
            **kw)
        if r_embedder:
            if r_embedder_fusion not in ("additive", "gated"):
                raise ValueError(f"bad r_embedder_fusion {r_embedder_fusion}")
            if r_embedder_deltatime_type not in ("r", "t-r"):
                raise ValueError("bad r_embedder_deltatime_type "
                                 f"{r_embedder_deltatime_type}")
        self.delta_embedder = (TimestepEmbedder(
            dim, frequency_embedding_size=time_freq_dim, act_layer="silu",
            **kw) if r_embedder else None)
        self.r_fusion = r_embedder_fusion
        self.r_gate = float(r_embedder_gate_value)
        self.r_deltatime_type = r_embedder_deltatime_type
        self.time_modulation = ModulateProjection(dim, factor=6,
                                                  act_layer="silu", **kw)
        self.text_embedder = MLP(text_embed_dim, dim, dim, bias=True,
                                 act_type="gelu_pytorch_tanh", **kw)
        self.image_embedder = (WanImageEmbedding(image_embed_dim, dim, **kw)
                               if image_embed_dim is not None else None)

    def forward(self, timestep: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                encoder_hidden_states_image: torch.Tensor | None = None,
                timestep_seq_len: int | None = None,
                r_timestep: torch.Tensor | None = None):
        """(temb, its 6-way modulation, the text context, the image
        context or None). With ``timestep_seq_len`` the timesteps are per
        token (B * seq_len of them) and temb is [B, seq_len, C].
        ``r_timestep`` reaches temb only when the branch exists."""
        temb = self.time_embedder(timestep, timestep_seq_len)
        if self.delta_embedder is not None and r_timestep is not None:
            delta_input = (r_timestep if self.r_deltatime_type == "r" else
                           timestep - r_timestep)
            delta = self.delta_embedder(delta_input, timestep_seq_len)
            if self.r_fusion == "gated":
                temb = (1.0 - self.r_gate) * temb + self.r_gate * delta
            else:
                temb = temb + self.r_gate * delta
        image = None
        if encoder_hidden_states_image is not None:
            if self.image_embedder is None:
                raise ValueError("image embeds passed to a DiT without an "
                                 "image_embedder (image_dim is unset)")
            image = self.image_embedder(encoder_hidden_states_image)
        return (temb, self.time_modulation(temb),
                self.text_embedder(encoder_hidden_states), image)


@torch.no_grad()
def init_delta_from_time(model: nn.Module) -> None:
    """The AnyFlow copy rule: ``delta_embedder`` starts as a copy of
    ``time_embedder`` (a checkpoint without delta weights leaves it
    unloaded)."""
    ce = model.condition_embedder
    ce.delta_embedder.load_state_dict(
        {k: v.detach().clone() for k, v in
         ce.time_embedder.state_dict().items()}, strict=True, assign=True)


class WanT2VCrossAttention(nn.Module):
    """Text cross-attention (FLASH_ATTN, or TORCH_SDPA where that is the
    selected backend, as in JAX)."""

    def __init__(self, dim: int, num_heads: int, eps: float = 1e-6, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.to_q = Linear(dim, dim, **kw)
        self.to_k = Linear(dim, dim, **kw)
        self.to_v = Linear(dim, dim, **kw)
        self.to_out = Linear(dim, dim, **kw)
        self.norm_q = RMSNorm(dim, eps=eps, **kw)
        self.norm_k = RMSNorm(dim, eps=eps, **kw)
        self.attn = LocalAttention(num_heads, self.head_dim,
                                   supported_backends=("FLASH_ATTN",
                                                       "TORCH_SDPA"))

    def qkv(self, x: torch.Tensor, context: torch.Tensor):
        b = x.shape[0]
        n, d = self.num_heads, self.head_dim
        q = self.norm_q(self.to_q(x)).reshape(b, -1, n, d)
        k = self.norm_k(self.to_k(context)).reshape(b, -1, n, d)
        v = self.to_v(context).reshape(b, -1, n, d)
        return q, k, v

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        out = self.attn(*self.qkv(x, context))
        return self.to_out(out.reshape(*out.shape[:2], -1))


class WanI2VCrossAttention(WanT2VCrossAttention):
    """Cross-attention over [257 image tokens | text]: the image tokens
    through ``add_k_proj`` / ``add_v_proj`` (K RMS-normed by
    ``norm_added_k``), the text through the T2V projections; the two
    attention outputs summed before ``to_out``. The split is at 257 tokens
    whatever the image context's length, as in the JAX package."""

    NUM_IMAGE_TOKENS = 257

    def __init__(self, dim: int, num_heads: int, eps: float = 1e-6, *,
                 device=None, dtype=None):
        super().__init__(dim, num_heads, eps, device=device, dtype=dtype)
        kw = dict(device=device, dtype=dtype)
        self.add_k_proj = Linear(dim, dim, **kw)
        self.add_v_proj = Linear(dim, dim, **kw)
        self.norm_added_k = RMSNorm(dim, eps=eps, **kw)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        nimg = self.NUM_IMAGE_TOKENS
        context_img, context_txt = context[:, :nimg], context[:, nimg:]
        b = x.shape[0]
        n, d = self.num_heads, self.head_dim
        q, k, v = self.qkv(x, context_txt)
        k_img = self.norm_added_k(self.add_k_proj(context_img)).reshape(
            b, -1, n, d)
        v_img = self.add_v_proj(context_img).reshape(b, -1, n, d)
        out = self.attn(q, k, v) + self.attn(q, k_img, v_img)
        return self.to_out(out.reshape(b, -1, n * d))


class WanTransformerBlock(nn.Module):
    """AdaLN DiT block: self-attention, text cross-attention, FFN."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int,
                 qk_norm: str = "rms_norm_across_heads", eps: float = 1e-6,
                 added_kv_proj_dim: int | None = None, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dim = dim
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.norm1 = FP32LayerNorm(dim, eps, elementwise_affine=False, **kw)
        self.to_q = Linear(dim, dim, **kw)
        self.to_k = Linear(dim, dim, **kw)
        self.to_v = Linear(dim, dim, **kw)
        self.to_out = Linear(dim, dim, **kw)
        if qk_norm != "rms_norm_across_heads":
            raise ValueError(f"Unsupported qk_norm: {qk_norm}")
        self.norm_q = RMSNorm(dim, eps=eps, **kw)
        self.norm_k = RMSNorm(dim, eps=eps, **kw)
        self.attn1 = DistributedAttention(num_heads, head_dim)
        self.self_attn_residual_norm = ScaleResidualLayerNormScaleShift(
            dim, eps=eps, elementwise_affine=True, **kw)
        cross_cls = (WanI2VCrossAttention if added_kv_proj_dim is not None
                     else WanT2VCrossAttention)
        self.attn2 = cross_cls(dim, num_heads, eps=eps, **kw)
        self.cross_attn_residual_norm = ScaleResidualLayerNormScaleShift(
            dim, eps=eps, elementwise_affine=False, **kw)
        self.ffn = MLP(dim, ffn_dim, act_type="gelu_pytorch_tanh", **kw)
        self.mlp_residual = ScaleResidual()
        self.scale_shift_table = nn.Parameter(
            torch.randn(1, 6, dim, device=device, dtype=torch.float32) /
            dim**0.5)

    def gate_compress(self, norm_hidden: torch.Tensor) -> torch.Tensor | None:
        return None

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: torch.Tensor, temb: torch.Tensor,
                freqs_cis: tuple[torch.Tensor, torch.Tensor],
                kv_valid: int | None = None,
                grid: tuple[int, int, int] | None = None,
                pre_tiled: bool = False) -> torch.Tensor:
        """temb: [B, 6, C] modulation, or [B, S, 6, C] per token (Wan2.2
        TI2V); fp32 math."""
        orig_dtype = hidden_states.dtype
        b = hidden_states.shape[0]
        n, d = self.num_heads, self.dim // self.num_heads
        if temb.ndim == 4:
            e = self.scale_shift_table.float()[None] + temb.float()
            mods = [e[:, :, i] for i in range(6)]  # each [B, S, C]
        else:
            e = self.scale_shift_table.float() + temb.float()
            mods = [e[:, i:i + 1] for i in range(6)]  # each [B, 1, C]
        shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = mods

        # 1. self-attention
        norm_hidden = self.norm1.norm_f32(hidden_states)
        norm_hidden = (norm_hidden * (1.0 + scale_msa) + shift_msa).to(
            orig_dtype)
        q = self.norm_q(self.to_q(norm_hidden)).reshape(b, -1, n, d)
        k = self.norm_k(self.to_k(norm_hidden)).reshape(b, -1, n, d)
        v = self.to_v(norm_hidden).reshape(b, -1, n, d)
        attn_out = self.attn1(q, k, v, freqs_cis=freqs_cis, kv_valid=kv_valid,
                              grid=grid, gate=self.gate_compress(norm_hidden),
                              pre_tiled=pre_tiled)
        attn_out = self.to_out(attn_out.reshape(b, -1, self.dim))
        norm_hidden, hidden_states = self.self_attn_residual_norm(
            hidden_states, attn_out, gate_msa, 0.0, 0.0)

        # 2. cross-attention (gate 1)
        attn_out = self.attn2(norm_hidden, encoder_hidden_states)
        norm_hidden, hidden_states = self.cross_attn_residual_norm(
            hidden_states, attn_out, 1.0, c_shift, c_scale)

        # 3. feed-forward
        ff = self.ffn(norm_hidden)
        hidden_states = self.mlp_residual(hidden_states, ff, c_gate)
        return hidden_states.to(orig_dtype)


class WanTransformerBlockVSA(WanTransformerBlock):
    """VSA block: adds the ``to_gate_compress`` projection that gates the
    compression branch."""

    def __init__(self, dim: int, ffn_dim: int, num_heads: int,
                 qk_norm: str = "rms_norm_across_heads", eps: float = 1e-6,
                 added_kv_proj_dim: int | None = None, *, device=None,
                 dtype=None):
        super().__init__(dim, ffn_dim, num_heads, qk_norm, eps,
                         added_kv_proj_dim, device=device, dtype=dtype)
        self.to_gate_compress = Linear(dim, dim, device=device, dtype=dtype)

    def gate_compress(self, norm_hidden: torch.Tensor) -> torch.Tensor:
        b = norm_hidden.shape[0]
        return self.to_gate_compress(norm_hidden).reshape(
            b, -1, self.num_heads, self.dim // self.num_heads)


class WanTransformer3DModel(nn.Module):
    """Top-level Wan DiT: [B, C, T, H, W] latents -> flow prediction."""

    # a subclass with its own block class (the causal Wan) never runs in
    # the VSA tile-major order
    block_cls: type[WanTransformerBlock] | None = None
    # grown by arch overrides, possibly absent from a checkpoint
    optional_checkpoint_prefixes = ("condition_embedder.delta_embedder.",)

    def __init__(self, config: WanArchConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = config
        inner_dim = config.num_attention_heads * config.attention_head_dim
        self.inner_dim = inner_dim
        self.patch_embedding = PatchEmbed3D(config.in_channels, inner_dim,
                                            config.patch_size, **kw)
        self.condition_embedder = WanTimeTextImageEmbedding(
            inner_dim, config.freq_dim, config.text_dim, config.image_dim,
            r_embedder=config.r_embedder,
            r_embedder_fusion=config.r_embedder_fusion,
            r_embedder_gate_value=config.r_embedder_gate_value,
            r_embedder_deltatime_type=config.r_embedder_deltatime_type, **kw)
        self.vsa_tiled_order = (self.block_cls is None and
                                resolve_backend_name() == "VIDEO_SPARSE_ATTN")
        block_cls = self.block_cls or (WanTransformerBlockVSA
                                       if self.vsa_tiled_order else
                                       WanTransformerBlock)
        self.blocks = nn.ModuleList([
            block_cls(inner_dim, config.ffn_dim, config.num_attention_heads,
                      config.qk_norm, config.eps, config.added_kv_proj_dim,
                      **kw)
            for _ in range(config.num_layers)
        ])
        self.norm_out = LayerNormScaleShift(inner_dim, eps=config.eps,
                                            elementwise_affine=False, **kw)
        self.proj_out = Linear(inner_dim,
                               config.out_channels * math.prod(
                                   config.patch_size), **kw)
        self.scale_shift_table = nn.Parameter(
            torch.randn(1, 2, inner_dim, device=device, dtype=torch.float32) /
            inner_dim**0.5)
        # set by the trainer: recompute each block in the backward; with the
        # policy "ops" keep the matmul outputs (None: recompute everything)
        self.gradient_checkpointing = False
        self.gradient_checkpointing_policy = None

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                timestep: torch.Tensor,
                encoder_hidden_states_image: torch.Tensor | None = None,
                r_timestep: torch.Tensor | None = None) -> torch.Tensor:
        """hidden_states [B, C, T, H, W]; timestep [B], or [B, S] per token
        (S the patch grid's tokens in raster order: Wan2.2 TI2V, Lucy Edit),
        fp32. ``encoder_hidden_states_image`` [B, N, image_dim]: the CLIP
        image tokens of an I2V model. ``r_timestep`` [B]: AnyFlow's
        flow-map target time, read only when the config enables
        ``r_embedder``. Per-token modulation follows the tokens into VSA's
        tile-major order."""
        cfg = self.config
        _, _, t, h, w = hidden_states.shape
        pt, ph, pw = cfg.patch_size
        grid = (t // pt, h // ph, w // pw)
        cos, sin = get_rotary_pos_embed_wan(grid, cfg.attention_head_dim,
                                            cfg.rope_theta,
                                            device=hidden_states.device)
        x = self.patch_embedding(hidden_states)  # [B, S, C]
        pre_tiled = self.vsa_tiled_order
        if pre_tiled:
            tile, exact = resolve_vsa_tile(grid)
            tile_fn = tile_tokens_exact if exact else tile_tokens
            untile_fn = untile_tokens_exact if exact else untile_tokens
            x = tile_fn(x, grid, tile)
            cos = tile_fn(cos[None], grid, tile)[0]
            sin = tile_fn(sin[None], grid, tile)[0]

        ts_seq_len = timestep.shape[1] if timestep.ndim == 2 else None
        if ts_seq_len is not None:
            timestep = timestep.reshape(-1)
        temb, timestep_proj, context, image = self.condition_embedder(
            timestep, encoder_hidden_states, encoder_hidden_states_image,
            timestep_seq_len=ts_seq_len, r_timestep=r_timestep)
        if ts_seq_len is not None:
            timestep_proj = timestep_proj.reshape(*timestep_proj.shape[:2], 6,
                                                  -1)  # [B, S, 6, C]
            if pre_tiled:
                timestep_proj = tile_fn(timestep_proj, grid, tile)
                temb = tile_fn(temb, grid, tile)
        else:
            timestep_proj = timestep_proj.reshape(timestep_proj.shape[0], 6,
                                                  -1)
        if image is not None:
            context = torch.cat([image, context], dim=1)
        context = context.to(x.dtype)
        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        remat_kw = checkpoint_policy_kwargs(self.gradient_checkpointing_policy)
        for block in self.blocks:
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    bind_forward_context(block), x, context, timestep_proj,
                    (cos, sin), None, grid=grid, pre_tiled=pre_tiled,
                    use_reentrant=False, **remat_kw)
            else:
                x = block(x, context, timestep_proj, (cos, sin), None,
                          grid=grid, pre_tiled=pre_tiled)

        if temb.ndim == 3:  # [B, S, C] per token
            e = self.scale_shift_table.float()[None] + temb.float()[:, :, None]
            x = self.norm_out(x, e[:, :, 0], e[:, :, 1])
        else:
            e = self.scale_shift_table.float() + temb.float()[:, None]
            x = self.norm_out(x, e[:, 0:1], e[:, 1:2])
        if pre_tiled:
            x = untile_fn(x, grid, tile)
        x = self.proj_out(x)
        return unpatchify(x, *grid, cfg.patch_size, cfg.out_channels)

