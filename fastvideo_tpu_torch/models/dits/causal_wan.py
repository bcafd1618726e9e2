"""Causal Wan: the block-autoregressive DiT with rolling KV caches (port of
fastvideo_tpu/models/dits/causal_wan.py), for self-forcing streaming.

A layer's cache is a dict of fixed-size buffers: ``sink_k``/``sink_v``
[B, sink_tokens, H, D], written while the stream is inside the sink region
(by absolute position) and then frozen, and a rolling window ``k``/``v``
[B, W, H, D] that shifts left by a block and appends it at the end. Empty
window slots sit at the front and are masked by the ``valid`` count; window
slots whose absolute position falls inside the sink region are masked too,
so each token is attended once. Keys are cached after RoPE, at absolute
positions (``start_frame``). ``valid`` and ``global_end`` are host ints.

The denoise passes of a block read the caches and leave them as they were;
only the clean commit pass (t = 0) writes them. :func:`cached_self_attention`
never writes its input cache: it returns the new buffers (new tensors: the
rolling shift is a concatenation, no overlapping in-place copy), and
``forward_block(update_caches=True)`` swaps each layer's buffers for them
as it goes, so the commit holds one layer's second copy at a time, never a
second cache.

Attention over the cache takes the flash kernels where the JAX package
takes its Pallas kv-mask kernel: at least 1,024 keys in the buffers (their
length, not the valid count) and a head dim that is a multiple of 128.
Elsewhere it is the dense softmax, plain PyTorch here as it is XLA in JAX.
The mask is never arbitrary: it keeps the sink slots written so far and a
suffix of the window, two contiguous ranges whose bounds are host ints. So
attention under it is attention over the valid keys gathered into one
tensor (a masked key weighs exactly 0), and that is the route under
autograd (the grad route, :func:`context_attention` on
:func:`cache_context`): the flash branch then runs ``flash_attention``
over the gathered keys (K1 forward, K6 backward), the dense branch the
dense softmax over them. A pass without a gradient keeps the kv-mask
kernel K5 on the whole buffers (:func:`cached_self_attention`), as JAX
routes it (K5 has no backward and refuses grad). This is a route, not a
fallback: a CUDA tensor launches a kernel on either branch or raises.

``forward_block`` sends every pass with grad on, and every pass on fresh
caches (``kv_caches=None``, which are not allocated: the score models'
full-clip passes attend their own valid tokens only, on the branch the
buffers' length picks), through the gathered context; under
``gradient_checkpointing`` each block then runs under
``torch.utils.checkpoint`` with the cache's valid keys gathered before it
(new tensors in the activations' dtype), so the saved inputs are those
keys and never the cache buffers, which the rollout goes on to replace.
The cross-attention over the cached text K/V goes through K1.

``train_forward`` is the full-sequence forward of diffusion-forcing and
teacher-forcing training (the ``dfsft`` / ``tfsft`` methods): per-frame
timesteps, per-token modulation, and the self-attention under K1 struct's
chunk-causal or teacher-forcing mask (K6 struct in the backward).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from fastvideo_tpu_torch.layers.embeddings import unpatchify
from fastvideo_tpu_torch.layers.rotary import (apply_rotary_emb,
                                               get_rotary_pos_embed_wan)
from fastvideo_tpu_torch.models.dits.wan import (WanTransformer3DModel,
                                                 WanTransformerBlock)
# after the DiT, which imports the attention package that forward_context
# needs first
from fastvideo_tpu_torch.forward_context import bind_forward_context
from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.parallel import get_tp_size
from fastvideo_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_kv_mask)

NEG_INF = float(torch.finfo(torch.float32).min)
# the window in latent frames when local_attn_size is -1
SLIDING_WINDOW_NUM_FRAMES = 21
# the smallest key count that takes K5, as in the JAX package
FLASH_MIN_KEYS = 1024


def init_layer_cache(batch_size: int, window_tokens: int, sink_tokens: int,
                     num_heads: int, head_dim: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device=None) -> dict:
    """``window_tokens`` is the whole attention budget; the sink lives
    inside it, so the rolling part holds window_tokens - sink_tokens."""
    def z(n):
        return torch.zeros((batch_size, n, num_heads, head_dim), dtype=dtype,
                           device=device)

    roll = max(window_tokens - sink_tokens, 0)
    return {"k": z(roll), "v": z(roll), "sink_k": z(sink_tokens),
            "sink_v": z(sink_tokens), "valid": 0, "global_end": 0}


def _append_rolling(buf: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Shift left by len(new) and append new at the end, as a new tensor."""
    n = new.shape[1]
    if n >= buf.shape[1]:
        return new[:, -buf.shape[1]:]
    return torch.cat([buf[:, n:], new.to(buf.dtype)], dim=1)


def _dense_attention(q, k, v, ok, scale):
    """``jax.nn.dot_product_attention`` with a [S_kv] bias of 0 / NEG_INF
    (none where ``ok`` is None): fp32 logits and softmax, the probabilities
    in the key dtype."""
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if ok is not None:
        logits = logits + torch.where(ok, 0.0, NEG_INF)[None, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(k.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _flash_branch(keys: int, q: torch.Tensor) -> bool:
    """JAX's rule: the kv-mask flash kernel at >= FLASH_MIN_KEYS keys in
    the buffers and a head dim that is a multiple of 128."""
    return keys >= FLASH_MIN_KEYS and q.shape[-1] % 128 == 0


def valid_ranges(window: int, sink_cap: int, valid: int, start: int,
                 n: int) -> tuple[int, int, int, int]:
    """The mask of a pass of ``n`` tokens on a cache whose window has
    ``window`` slots (``valid`` filled), whose sink has ``sink_cap`` and
    whose stream has reached ``start``, as ranges: the old sink slots it
    keeps ``[0, s_old)``, the old window slots it keeps ``[w_old,
    window)`` (the shift moves slot s to s - n), and the pass's own tokens
    it attends, ``[0, a)`` (written to the sink) and ``[lo, n)`` (in the
    window)."""
    global_end = start + n
    s_end = min(global_end, sink_cap)
    w_start = window - min(valid + n, window)
    if sink_cap > 0:
        # window slots whose absolute position lies in the sink region
        w_start = max(w_start, window + sink_cap - global_end)
    w_start = min(w_start, window)
    return (min(start, s_end), min(w_start + n, window),
            max(s_end - start, 0), max(w_start - window + n, 0))


def cache_context(cache: dict, n: int, dtype: torch.dtype) -> dict:
    """What a pass of ``n`` tokens attends in ``cache`` besides its own
    tokens, gathered: ``k`` / ``v`` [B, m, H, D] (new tensors of
    ``dtype``, the kept sink slots then the kept window slots; None when
    m is 0), ``new`` the ranges ``(a, lo)`` of its own tokens it attends
    (:func:`valid_ranges`) and ``keys`` the buffers' length, which picks
    the branch."""
    window, sink_cap = cache["k"].shape[1], cache["sink_k"].shape[1]
    s_old, w_old, a, lo = valid_ranges(window, sink_cap, cache["valid"],
                                       cache["global_end"], n)
    ctx = {"k": None, "v": None, "new": (a, lo), "keys": window + sink_cap}
    if s_old or w_old < window:
        for key, sink, win in (("k", "sink_k", "k"), ("v", "sink_v", "v")):
            ctx[key] = torch.cat([cache[sink][:, :s_old],
                                  cache[win][:, w_old:]], dim=1).to(dtype)
    return ctx


def fresh_context(window_tokens: int, sink_tokens: int, n: int) -> dict:
    """:func:`cache_context` of a fresh cache of ``window_tokens`` (the
    sink inside it), which is never allocated: no old keys."""
    window = max(window_tokens - sink_tokens, 0)
    _, _, a, lo = valid_ranges(window, sink_tokens, 0, 0, n)
    return {"k": None, "v": None, "new": (a, lo),
            "keys": window + sink_tokens}


def context_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      ctx: dict, scale: float) -> torch.Tensor:
    """Attention of a pass over its valid keys: ``ctx``'s gathered cache
    keys, then the ranges of the pass's own ``k`` / ``v`` that it attends
    (with no old key and all its own, ``k`` and ``v`` themselves). On the
    flash branch, under grad ``flash_attention`` (K1 and K6), else K5 with
    every key valid; on the dense branch the dense softmax."""
    a, lo = ctx["new"]
    n = k.shape[1]

    def gather(old, new):
        parts = [] if old is None else [old]
        if a:
            parts.append(new[:, :a])
        if lo < n:
            parts.append(new[:, lo:] if lo else new)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    keys = gather(ctx["k"], k).to(q.dtype)
    vals = gather(ctx["v"], v).to(q.dtype)
    if not _flash_branch(ctx["keys"], q):
        return _dense_attention(q, keys, vals, None, scale)
    if _build.needs_grad(q, keys, vals):
        return flash_attention(q, keys, vals, scale=scale)
    everything = torch.ones(keys.shape[1], dtype=torch.bool, device=q.device)
    return flash_attention_kv_mask(q, keys, vals, everything, scale=scale)


def _commit(cache: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
    """The cache after a pass of ``k`` / ``v``: new buffers, the input
    cache left as it was."""
    n = k.shape[1]
    sink_cap = cache["sink_k"].shape[1]
    if sink_cap > 0:
        # sink slot j takes new token (j - start) when 0 <= j - start < n:
        # an exact gather and select by absolute position
        src_idx = (torch.arange(sink_cap, device=k.device) -
                   cache["global_end"])
        in_range = ((src_idx >= 0) & (src_idx < n))[None, :, None, None]
        gather = src_idx.clamp(0, n - 1)
        sink_k = torch.where(in_range, k[:, gather].to(cache["sink_k"].dtype),
                             cache["sink_k"])
        sink_v = torch.where(in_range, v[:, gather].to(cache["sink_v"].dtype),
                             cache["sink_v"])
    else:
        sink_k, sink_v = cache["sink_k"], cache["sink_v"]
    return dict(cache, k=_append_rolling(cache["k"], k),
                v=_append_rolling(cache["v"], v),
                valid=min(cache["valid"] + n, cache["k"].shape[1]),
                global_end=cache["global_end"] + n, sink_k=sink_k,
                sink_v=sink_v)


def cached_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cache: dict, scale: float
                          ) -> tuple[torch.Tensor, dict]:
    """q/k/v [B, n, H, D] (already roped). Returns (out, new cache); the
    input cache is left as it was. This is the pass without grad: on the
    flash branch K5, which refuses grad; a pass under grad attends through
    ``context_attention(q, k, v, cache_context(cache, n, dtype), scale)``,
    as ``forward_block`` routes it."""
    new = _commit(cache, k, v)
    window = new["k"].shape[1]
    sink_cap = new["sink_k"].shape[1]
    dev = q.device
    # window slots [0, window - valid) are empty; sink slots past
    # min(global_end, sink_cap) are empty; window slots whose absolute
    # position lies in the sink region are attended through the sink
    win_pos = torch.arange(window, device=dev)
    win_ok = win_pos >= (window - new["valid"])
    if sink_cap > 0:
        abs_pos = new["global_end"] - window + win_pos
        win_ok = win_ok & (abs_pos >= sink_cap)
        sink_ok = torch.arange(sink_cap, device=dev) < min(new["global_end"],
                                                           sink_cap)
        keys = torch.cat([new["sink_k"], new["k"]], dim=1)
        vals = torch.cat([new["sink_v"], new["v"]], dim=1)
        ok = torch.cat([sink_ok, win_ok])
    else:
        keys, vals, ok = new["k"], new["v"], win_ok

    if _flash_branch(keys.shape[1], q):
        out = flash_attention_kv_mask(q, keys.to(q.dtype), vals.to(q.dtype),
                                      ok, scale=scale)
    else:
        out = _dense_attention(q, keys.to(q.dtype), vals.to(q.dtype), ok,
                               scale)
    return out, new


class CausalWanTransformerBlock(WanTransformerBlock):
    """Wan block with cached causal self-attention and cached text K/V."""

    def _causal(self, hidden_states: torch.Tensor, temb: torch.Tensor,
                freqs_cis: tuple[torch.Tensor, torch.Tensor], attend,
                kx: torch.Tensor, vx: torch.Tensor) -> torch.Tensor:
        """The block with ``attend(q, k, v, scale)`` as its
        self-attention."""
        orig_dtype = hidden_states.dtype
        b = hidden_states.shape[0]
        n, d = self.num_heads, self.dim // self.num_heads
        e = self.scale_shift_table.float() + temb.float()
        shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = (
            e[:, i:i + 1] for i in range(6))

        norm_hidden = self.norm1.norm_f32(hidden_states)
        norm_hidden = (norm_hidden * (1.0 + scale_msa) + shift_msa).to(
            orig_dtype)
        q = self.norm_q(self.to_q(norm_hidden)).reshape(b, -1, n, d)
        k = self.norm_k(self.to_k(norm_hidden)).reshape(b, -1, n, d)
        v = self.to_v(norm_hidden).reshape(b, -1, n, d)
        cos, sin = freqs_cis
        q = apply_rotary_emb(q, cos, sin)
        k = apply_rotary_emb(k, cos, sin)
        attn_out = attend(q, k, v, d**-0.5)
        attn_out = self.to_out(attn_out.reshape(b, -1, self.dim))
        norm_hidden, hidden_states = self.self_attn_residual_norm(
            hidden_states, attn_out, gate_msa, 0.0, 0.0)

        # cross-attention over the cached text K/V
        ca = self.attn2
        qx = ca.norm_q(ca.to_q(norm_hidden)).reshape(b, -1, n, d)
        x_out = flash_attention(qx, kx.to(qx.dtype), vx.to(qx.dtype))
        attn_out = ca.to_out(x_out.reshape(b, -1, self.dim))
        norm_hidden, hidden_states = self.cross_attn_residual_norm(
            hidden_states, attn_out, 1.0, c_shift, c_scale)

        ff = self.ffn(norm_hidden)
        hidden_states = self.mlp_residual(hidden_states, ff, c_gate)
        return hidden_states.to(orig_dtype)

    def causal_forward(self, hidden_states: torch.Tensor,
                       temb: torch.Tensor,
                       freqs_cis: tuple[torch.Tensor, torch.Tensor],
                       kv_cache: dict, crossattn_cache: dict
                       ) -> tuple[torch.Tensor, dict]:
        """The block on ``kv_cache``: (out, the new cache)."""
        new: dict = {}

        def attend(q, k, v, scale):
            out, cache = cached_self_attention(q, k, v, kv_cache, scale)
            new.update(cache)
            return out

        out = self._causal(hidden_states, temb, freqs_cis, attend,
                           crossattn_cache["k"], crossattn_cache["v"])
        return out, new

    def context_forward(self, hidden_states: torch.Tensor,
                        temb: torch.Tensor,
                        freqs_cis: tuple[torch.Tensor, torch.Tensor],
                        ctx_k: torch.Tensor | None,
                        ctx_v: torch.Tensor | None, new: tuple[int, int],
                        keys: int, kx: torch.Tensor,
                        vx: torch.Tensor) -> torch.Tensor:
        """The block on a gathered context (:func:`cache_context`'s fields
        as arguments, so that a checkpoint saves them); writes no cache."""
        ctx = {"k": ctx_k, "v": ctx_v, "new": new, "keys": keys}
        return self._causal(
            hidden_states, temb, freqs_cis,
            lambda q, k, v, scale: context_attention(q, k, v, ctx, scale),
            kx, vx)


class CausalWanTransformer3DModel(WanTransformer3DModel):
    """Block-autoregressive Wan. Its parameters are the Wan DiT's."""

    block_cls = CausalWanTransformerBlock

    def __init__(self, config, *, device=None, dtype=None):
        # its cached attention and the block passes below hold every head;
        # under sp it runs whole on each rank, as the JAX model does
        if get_tp_size() > 1:
            raise NotImplementedError(
                "the causal Wan under tensor parallelism (tp > 1) is not "
                "ported")
        super().__init__(config, device=device, dtype=dtype)

    # -- caches -------------------------------------------------------------

    def cache_tokens(self, frame_seqlen: int) -> tuple[int, int]:
        """(window, sink) of a layer's cache in tokens; the sink lies
        inside the window."""
        cfg = self.config
        frames = (cfg.local_attn_size if cfg.local_attn_size != -1 else
                  SLIDING_WINDOW_NUM_FRAMES)
        return frames * frame_seqlen, cfg.sink_size * frame_seqlen

    def init_caches(self, batch_size: int, frame_seqlen: int,
                    dtype: torch.dtype = torch.bfloat16,
                    device=None) -> list[dict]:
        cfg = self.config
        window, sink = self.cache_tokens(frame_seqlen)
        return [init_layer_cache(batch_size, window, sink,
                                 cfg.num_attention_heads,
                                 cfg.attention_head_dim, dtype, device)
                for _ in range(cfg.num_layers)]

    def precompute_crossattn_caches(self, encoder_hidden_states: torch.Tensor,
                                    dtype: torch.dtype | None = None
                                    ) -> list[dict]:
        """Each layer's text K/V, once per prompt: the context is the same
        for every block and denoise step."""
        ctx = self.condition_embedder.text_embedder(encoder_hidden_states)
        if dtype is not None:
            ctx = ctx.to(dtype)
        b = ctx.shape[0]
        caches = []
        for block in self.blocks:
            ca = block.attn2
            n, d = block.num_heads, block.dim // block.num_heads
            caches.append({"k": ca.norm_k(ca.to_k(ctx)).reshape(b, -1, n, d),
                           "v": ca.to_v(ctx).reshape(b, -1, n, d)})
        return caches

    # -- block forward ------------------------------------------------------

    def forward_block(self, hidden_states: torch.Tensor,
                      encoder_hidden_states: torch.Tensor,
                      timestep: torch.Tensor, kv_caches: list[dict] | None,
                      crossattn_caches: list[dict] | None = None,
                      start_frame: int = 0,
                      freqs_cis: tuple[torch.Tensor,
                                       torch.Tensor] | None = None,
                      *, update_caches: bool = True
                      ) -> tuple[torch.Tensor, list[dict] | None]:
        """One autoregressive block: hidden_states [B, C, Tb, H, W] ->
        (pred [B, C, Tb, H, W], kv_caches). With ``update_caches`` (the
        commit pass) each layer's cache dict takes its new buffers as the
        layer runs; without it (a denoise pass) the caches are only read.
        ``kv_caches=None`` is a pass on fresh caches, which are not
        allocated. Without ``crossattn_caches`` the text K/V are projected
        here, as ``precompute_crossattn_caches`` does once per prompt.

        A pass with grad on, or on fresh caches, runs each block on its
        gathered context (:func:`cache_context`, :func:`fresh_context`),
        under ``torch.utils.checkpoint`` bound to the forward's context
        when ``gradient_checkpointing`` is set; such a pass writes no
        cache. A pass without grad on caches runs
        :func:`cached_self_attention`."""
        cfg = self.config
        _, _, t, h, w = hidden_states.shape
        pt, ph, pw = cfg.patch_size
        grid = (t // pt, h // ph, w // pw)
        grad = torch.is_grad_enabled()
        remat = self.gradient_checkpointing and grad
        if update_caches and (kv_caches is None or grad):
            raise ValueError("a pass that writes the caches needs caches and "
                             "runs without grad (torch.no_grad())")
        if freqs_cis is None:
            freqs_cis = get_rotary_pos_embed_wan(
                grid, cfg.attention_head_dim, cfg.rope_theta,
                start_frame=start_frame, device=hidden_states.device)
        x = self.patch_embedding(hidden_states)
        n = x.shape[1]

        ce = self.condition_embedder
        temb = ce.time_embedder(timestep.reshape(-1))
        timestep_proj = ce.time_modulation(temb)
        timestep_proj = timestep_proj.reshape(timestep_proj.shape[0], 6, -1)
        if crossattn_caches is None:
            crossattn_caches = self.precompute_crossattn_caches(
                encoder_hidden_states, x.dtype)

        for i, block in enumerate(self.blocks):
            ca = crossattn_caches[i]
            if kv_caches is not None and not grad:
                x, new_cache = block.causal_forward(x, timestep_proj,
                                                    freqs_cis, kv_caches[i],
                                                    ca)
                if update_caches:
                    kv_caches[i].update(new_cache)
                del new_cache
                continue
            ctx = (fresh_context(*self.cache_tokens(grid[1] * grid[2]), n)
                   if kv_caches is None else
                   cache_context(kv_caches[i], n, x.dtype))
            args = (x, timestep_proj, freqs_cis, ctx["k"], ctx["v"],
                    ctx["new"], ctx["keys"], ca["k"], ca["v"])
            del ctx
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    bind_forward_context(block.context_forward), *args,
                    use_reentrant=False)
            else:
                x = block.context_forward(*args)
            del args

        e = self.scale_shift_table.float() + temb.float()[:, None]
        x = self.norm_out(x, e[:, 0:1], e[:, 1:2])
        x = self.proj_out(x)
        out = unpatchify(x, *grid, cfg.patch_size, cfg.out_channels)
        return out, kv_caches

    # -- full-sequence training forward ---------------------------------------

    def train_forward(self, hidden_states: torch.Tensor,
                      encoder_hidden_states: torch.Tensor,
                      timestep: torch.Tensor,
                      clean_x: torch.Tensor | None = None,
                      aug_t: torch.Tensor | None = None) -> torch.Tensor:
        """Blockwise-causal full-sequence forward of diffusion-forcing and
        teacher-forcing training: hidden_states [B, C, T, H, W], timestep
        [B, gt] per latent frame -> the prediction [B, C, T, H, W].

        With ``clean_x`` the sequence is ``[clean | noisy]`` under the
        teacher-forcing mask and only the noisy half's prediction is
        returned; the clean tokens' modulation comes from ``aug_t`` [B, gt]
        (default zeros), and clean frame i shares noisy frame i's rope
        position. The output modulation comes from the noisy timesteps.
        With ``gradient_checkpointing`` (and grad enabled) each block runs
        under ``torch.utils.checkpoint``, bound to the forward's context."""
        cfg = self.config
        b, _, t, h, w = hidden_states.shape
        pt, ph, pw = cfg.patch_size
        grid = (t // pt, h // ph, w // pw)
        gt, fs = grid[0], grid[1] * grid[2]
        seq_len = gt * fs
        if timestep.ndim != 2 or timestep.shape[1] != gt:
            raise ValueError(f"timestep must be [B, {gt}] per latent frame, "
                             f"got {tuple(timestep.shape)}")
        chunk_tokens = cfg.num_frames_per_block * fs
        dev = hidden_states.device
        cos, sin = get_rotary_pos_embed_wan(grid, cfg.attention_head_dim,
                                            cfg.rope_theta, device=dev)
        x = self.patch_embedding(hidden_states)  # [B, S, C]

        ce = self.condition_embedder

        def modulation(ts):  # [B, gt] -> per-token temb, [B, S, 6, C]
            tok = ts.float().repeat_interleave(fs, dim=1).reshape(-1)
            temb = ce.time_embedder(tok, seq_len)
            return temb, ce.time_modulation(temb).reshape(b, seq_len, 6, -1)

        temb, timestep_proj = modulation(timestep)
        context = ce.text_embedder(encoder_hidden_states).to(x.dtype)

        tf_clean_len = 0
        if clean_x is not None:
            tf_clean_len = seq_len
            if aug_t is None:
                aug_t = torch.zeros_like(timestep)
            _, proj_clean = modulation(aug_t)
            x = torch.cat([self.patch_embedding(clean_x), x], dim=1)
            timestep_proj = torch.cat([proj_clean, timestep_proj], dim=1)
            del proj_clean
            cos, sin = torch.cat([cos, cos]), torch.cat([sin, sin])

        remat = self.gradient_checkpointing and torch.is_grad_enabled()
        for block in self.blocks:
            args = (block, x, context, timestep_proj, (cos, sin),
                    chunk_tokens, tf_clean_len)
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    bind_forward_context(_masked_block_forward), *args,
                    use_reentrant=False)
            else:
                x = _masked_block_forward(*args)

        if clean_x is not None:
            x = x[:, seq_len:]
        e = self.scale_shift_table.float()[None] + temb.float()[:, :, None]
        x = self.norm_out(x, e[:, :, 0], e[:, :, 1])
        x = self.proj_out(x)
        return unpatchify(x, *grid, cfg.patch_size, cfg.out_channels)


def _masked_block_forward(block: CausalWanTransformerBlock,
                          hidden_states: torch.Tensor,
                          encoder_hidden_states: torch.Tensor,
                          temb: torch.Tensor,
                          freqs_cis: tuple[torch.Tensor, torch.Tensor],
                          chunk_tokens: int,
                          tf_clean_len: int) -> torch.Tensor:
    """A block over the full sequence under a structural flash mask: the
    self-attention is K1 struct (the chunk-causal mask, or the
    teacher-forcing one when ``tf_clean_len`` > 0), computed from the chunk
    geometry inside the kernel, so no [S, S] mask is ever built. ``temb``
    is the per-token modulation [B, S, 6, C]; the cross-attention is the
    block's own (K1 over the text keys)."""
    orig_dtype = hidden_states.dtype
    b = hidden_states.shape[0]
    n, d = block.num_heads, block.dim // block.num_heads
    e = block.scale_shift_table.float()[None] + temb.float()
    shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = (
        e[:, :, i] for i in range(6))

    norm_hidden = block.norm1.norm_f32(hidden_states)
    norm_hidden = (norm_hidden * (1.0 + scale_msa) + shift_msa).to(
        orig_dtype)
    q = block.norm_q(block.to_q(norm_hidden)).reshape(b, -1, n, d)
    k = block.norm_k(block.to_k(norm_hidden)).reshape(b, -1, n, d)
    v = block.to_v(norm_hidden).reshape(b, -1, n, d)
    cos, sin = freqs_cis
    q = apply_rotary_emb(q, cos, sin)
    k = apply_rotary_emb(k, cos, sin)
    attn_out = flash_attention(q, k, v, scale=d**-0.5,
                               chunk_tokens=chunk_tokens,
                               tf_clean_len=tf_clean_len)
    attn_out = block.to_out(attn_out.reshape(b, -1, block.dim))
    norm_hidden, hidden_states = block.self_attn_residual_norm(
        hidden_states, attn_out, gate_msa, 0.0, 0.0)

    attn_out = block.attn2(norm_hidden, encoder_hidden_states)
    norm_hidden, hidden_states = block.cross_attn_residual_norm(
        hidden_states, attn_out, 1.0, c_shift, c_scale)

    ff = block.ffn(norm_hidden)
    hidden_states = block.mlp_residual(hidden_states, ff, c_gate)
    return hidden_states.to(orig_dtype)


EntryClass = CausalWanTransformer3DModel
