"""The port's causal Wan ``train_forward`` (diffusion forcing and teacher
forcing, the full-sequence training forward under K1 struct's masks; on the
CPU their plain versions) against the JAX one, whose flash attention runs
through its plain softmax under the kernel's structural mask
(``test_torch_jax_reference.py``; the kernels themselves are held in
interpret mode by ``test_torch_flash_struct_mask.py``), on JAX weights
carried across by ``state_dict_from_jax``: outputs, and parameter
gradients of a scalar loss against ``jax.grad``.
Then JAX's own checks of the same forward, on the port: it equals running
the chunks one by one through ``forward_block`` with rolling caches, and
teacher forcing leaves chunk 0 as it is. fp32 on both sides."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu.models.dits import causal_wan as jcw
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.registry import resolve_model_cls
from fastvideo_tpu_torch.ops import _build

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_jax_reference import jax_plain_attention  # noqa: E402,F401
from test_torch_wan_dit import jax_params, numpy_model  # noqa: E402
from utils import TINY_DIT  # noqa: E402

torch.set_num_threads(2)

# fp32 on both sides: summation order only
ATOL, RTOL = 5e-5, 1e-4
# chunks of 2 latent frames; latents [1, 4, 6, 8, 12]: a token grid
# (6, 4, 6), 24 tokens a frame, 3 chunks of 48 (JAX's flash tiles are 128
# rows: chunk borders fall inside them), 144 tokens (288 with teacher
# forcing)
CAUSAL = dict(num_frames_per_block=2, local_attn_size=-1, sink_size=0)
LATENTS = (1, 4, 6, 8, 12)
T_CHUNKS = (800.0, 350.0, 60.0)


@pytest.fixture(scope="module")
def models():
    # the blocks build their (unused) self-attention backend from the
    # environment, which other tests may leave set
    mp = pytest.MonkeyPatch()
    mp.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    try:
        cfg = dict(TINY_DIT, **CAUSAL)
        arch = {k: tuple(v) if isinstance(v, list) else v
                for k, v in cfg.items()}
        jmodel = numpy_model(lambda: jcw.CausalWanTransformer3DModel(
            WanArchConfig(**arch), param_dtype=jnp.float32,
            rngs=nnx.Rngs(0)), seed=3)
        cls, arch_cls = resolve_model_cls("CausalWanTransformer3DModel")
        tmodel = cls(arch_cls(**arch), dtype=torch.float32)
        tmodel.load_state_dict(state_dict_from_jax(jax_params(jmodel)),
                               strict=True)
        return jmodel, tmodel
    finally:
        mp.undo()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    noisy, clean = (rng.standard_normal(LATENTS).astype(np.float32)
                    for _ in range(2))
    embeds = rng.standard_normal((1, 7, TINY_DIT["text_dim"])).astype(
        np.float32)
    t_frame = np.repeat(np.asarray([T_CHUNKS], np.float32),
                        CAUSAL["num_frames_per_block"], axis=1)
    aug_t = np.repeat(np.asarray([[0.0, 120.0, 40.0]], np.float32),
                      CAUSAL["num_frames_per_block"], axis=1)
    return noisy, clean, embeds, t_frame, aug_t


# diffusion forcing; teacher forcing with the default (zero) and with
# noise-augmented clean timesteps
MODES = {"df": (False, False), "tf": (True, False), "tf_aug_t": (True, True)}


def _args(mode, seed=0):
    noisy, clean, embeds, t_frame, aug_t = _inputs(seed)
    with_clean, with_aug = MODES[mode]
    kw = {}
    if with_clean:
        kw["clean_x"] = clean
    if with_aug:
        kw["aug_t"] = aug_t
    return (noisy, embeds, t_frame), kw


@pytest.mark.parametrize("mode", list(MODES))
def test_train_forward_matches_jax(models, mode, jax_plain_attention):
    jmodel, tmodel = models
    args, kw = _args(mode)
    want = np.asarray(jmodel.train_forward(
        *map(jnp.asarray, args), **{k: jnp.asarray(v) for k, v in
                                    kw.items()}))
    before = dict(_build.PLAIN_CALLS)
    with torch.no_grad():
        got = tmodel.train_forward(
            *map(torch.from_numpy, args),
            **{k: torch.from_numpy(v) for k, v in kw.items()})
    # every block's self-attention took K1 struct
    assert (_build.PLAIN_CALLS["flash_fwd_struct"] -
            before["flash_fwd_struct"]) == TINY_DIT["num_layers"]
    assert got.shape == LATENTS
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", ["df", "tf_aug_t"])
def test_gradients_match_jax_grad(models, mode, jax_plain_attention):
    """Parameter gradients of sum(out * g): within 1e-4 relative L2 over
    the model and 1e-3 per tensor (fp32, summation order only)."""
    jmodel, tmodel = models
    args, kw = _args(mode, seed=1)
    g = np.random.default_rng(2).standard_normal(LATENTS).astype(np.float32)
    graphdef, params, rest = nnx.split(jmodel, nnx.Param, ...)
    jargs = tuple(map(jnp.asarray, args))
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}

    def jloss(p):
        model = nnx.merge(graphdef, p, rest)
        return jnp.sum(model.train_forward(*jargs, **jkw) * g)

    jgrads = state_dict_from_jax(jax.tree.map(
        np.asarray, jax.grad(jloss)(params).to_pure_dict()))
    tmodel.zero_grad(set_to_none=True)
    before = dict(_build.PLAIN_CALLS)
    out = tmodel.train_forward(*map(torch.from_numpy, args),
                               **{k: torch.from_numpy(v)
                                  for k, v in kw.items()})
    (out * torch.from_numpy(g)).sum().backward()
    for name in ("flash_bwd_struct_dq", "flash_bwd_struct_dkv"):
        assert (_build.PLAIN_CALLS[name] - before[name]) == \
            TINY_DIT["num_layers"]
    tgrads = {n: p.grad for n, p in tmodel.named_parameters()}
    flat_t = torch.cat([tgrads[n].flatten() for n in jgrads])
    flat_j = torch.cat([jgrads[n].flatten() for n in jgrads])
    assert (flat_t - flat_j).norm() / flat_j.norm() < 1e-4
    for n, w in jgrads.items():
        assert (tgrads[n] - w).norm() <= 1e-3 * w.norm() + 1e-6, n
    tmodel.zero_grad(set_to_none=True)


def test_gradient_checkpointing_gives_the_same_gradients(models):
    """Each block under torch.utils.checkpoint: the same gradients as
    without, and the same output (fp32, the same operations)."""
    _, tmodel = models
    args, kw = _args("tf", seed=4)
    results = []
    for remat in (False, True):
        tmodel.gradient_checkpointing = remat
        tmodel.zero_grad(set_to_none=True)
        out = tmodel.train_forward(*map(torch.from_numpy, args),
                                   **{k: torch.from_numpy(v)
                                      for k, v in kw.items()})
        out.square().mean().backward()
        results.append((out.detach(), [p.grad.clone() for p in
                                       tmodel.parameters()]))
    tmodel.gradient_checkpointing = False
    tmodel.zero_grad(set_to_none=True)
    torch.testing.assert_close(results[1][0], results[0][0], atol=0, rtol=0)
    for a, b in zip(results[1][1], results[0][1]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_train_forward_matches_streaming(models):
    """The blockwise-causal mask shows each chunk exactly what the
    autoregressive rollout shows it: train_forward with per-chunk
    timesteps equals forward_block chunk by chunk with rolling caches
    (JAX tests/models/test_causal_train_forward.py, on the port)."""
    _, tmodel = models
    noisy, _, embeds, t_frame, _ = _inputs(5)
    chunk = CAUSAL["num_frames_per_block"]
    fs = (LATENTS[3] // 2) * (LATENTS[4] // 2)
    with torch.no_grad():
        full = tmodel.train_forward(torch.from_numpy(noisy),
                                    torch.from_numpy(embeds),
                                    torch.from_numpy(t_frame))
        caches = tmodel.init_caches(1, fs, dtype=torch.float32)
        outs = []
        for i, tc in enumerate(T_CHUNKS):
            blk = torch.from_numpy(noisy[:, :, i * chunk:(i + 1) * chunk])
            pred, caches = tmodel.forward_block(
                blk, torch.from_numpy(embeds), torch.full((1,), tc), caches,
                start_frame=i * chunk)
            outs.append(pred)
    stream = torch.cat(outs, dim=2)
    assert (full - stream).abs().max().item() < 2e-4


def test_teacher_forcing_first_chunk_matches_df(models):
    """Chunk 0 has no clean context, so teacher forcing cannot change it;
    later chunks do see the clean context (JAX's own check, on the port)."""
    _, tmodel = models
    noisy, clean, embeds, _, _ = _inputs(6)
    t_frame = torch.full((1, LATENTS[2]), 500.0)
    chunk = CAUSAL["num_frames_per_block"]
    with torch.no_grad():
        df = tmodel.train_forward(torch.from_numpy(noisy),
                                  torch.from_numpy(embeds), t_frame)
        tf = tmodel.train_forward(torch.from_numpy(noisy),
                                  torch.from_numpy(embeds), t_frame,
                                  clean_x=torch.from_numpy(clean))
    assert (df[:, :, :chunk] - tf[:, :, :chunk]).abs().max().item() < 1e-5
    assert (df[:, :, chunk:] - tf[:, :, chunk:]).abs().max().item() > 1e-4


def test_train_forward_wants_per_frame_timesteps(models):
    _, tmodel = models
    noisy, _, embeds, _, _ = _inputs(7)
    with pytest.raises(ValueError, match="per latent frame"):
        tmodel.train_forward(torch.from_numpy(noisy),
                             torch.from_numpy(embeds), torch.zeros(1))
