"""The port's diffusion-forcing (``dfsft``) and teacher-forcing (``tfsft``)
SFT against the JAX ``DiffusionForcingPipeline`` on a 2-layer causal Wan
with narrow widths: the Gaussian timestep weights and the timestep index
range, the loss given JAX's own draws for every combination of
``precondition_outputs`` and ``teacher_forcing``, one training step
(loss, gradients, grad_norm and the parameters after AdamW), the chunk-size
check, and both methods through the training entry point on a tiny causal
checkpoint."""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import fastvideo_tpu.parallel as par
from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu.fastvideo_args import TrainingArgs as JTrainingArgs
from fastvideo_tpu.models.dits.causal_wan import (
    CausalWanTransformer3DModel as JCausalWan)
from fastvideo_tpu.models.schedulers.flow_match_euler import (
    FlowMatchEulerDiscreteScheduler)
from fastvideo_tpu.training.methods import fine_tuning as jft
from fastvideo_tpu_torch.entrypoints.cli.train import build_from_config
from fastvideo_tpu_torch.fastvideo_args import TrainingArgs
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.loader.safetensors_io import save_file
from fastvideo_tpu_torch.models.registry import resolve_model_cls
from fastvideo_tpu_torch.models.schedulers.flow_match_euler import (
    FlowMatchEulerDiscreteScheduler as TorchScheduler)
from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.training.methods import (NOT_PORTED,
                                                  resolve_method)
from fastvideo_tpu_torch.training import training_pipeline as ttp
from fastvideo_tpu_torch.training.methods import fine_tuning as tft
from fastvideo_tpu_torch.training.run_config import (ModelSpec,
                                                     TrainRunConfig)

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_training import _assert_adamw_params_close  # noqa: E402
from test_torch_wan_dit import jax_params, numpy_model  # noqa: E402
from utils import TINY_DIT  # noqa: E402

torch.set_num_threads(2)

CAUSAL = dict(num_frames_per_block=2, local_attn_size=-1, sink_size=0)
# [B, C, T, H, W]: 5 latent frames of (4, 4) tokens, 3 chunks of 2 frames
# (the last one cut at T)
LATENTS = (1, 4, 5, 8, 8)
EMBEDS = (1, 7, TINY_DIT["text_dim"])
LR = 1e-3


def _arch():
    cfg = dict(TINY_DIT, **CAUSAL)
    return {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}


def _jax_model():
    return numpy_model(lambda: JCausalWan(WanArchConfig(**_arch()),
                                          param_dtype=jnp.float32,
                                          rngs=nnx.Rngs(0)), seed=5)


@pytest.fixture(scope="module")
def jmodel():
    return _jax_model()


def _schedulers():
    js, ts = FlowMatchEulerDiscreteScheduler(shift=3.0), TorchScheduler(
        shift=3.0)
    js.set_timesteps(1000)
    ts.set_timesteps(1000)
    return js, ts


def _torch_model(jmodel):
    cls, arch_cls = resolve_model_cls("CausalWanTransformer3DModel")
    model = cls(arch_cls(**_arch()), dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(jax_params(jmodel)),
                          strict=True)
    return model


def _pipes(jmodel, monkeypatch, **kw):
    """The JAX and the port's pipelines on the same weights (the port's on
    the CPU)."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    par.destroy_mesh()
    js, ts = _schedulers()
    jargs = JTrainingArgs(num_gpus=1, dp_size=1, learning_rate=LR,
                          max_grad_norm=1.0, seed=0, output_dir="")
    jpipe = jft.DiffusionForcingPipeline(jmodel, js, jargs, **kw)
    targs = TrainingArgs(device="cpu", learning_rate=LR, max_grad_norm=1.0,
                         seed=0, output_dir="")
    tpipe = tft.DiffusionForcingPipeline(_torch_model(jmodel), ts, targs,
                                         **kw)
    return jpipe, tpipe


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(LATENTS).astype(np.float32),
            rng.standard_normal(EMBEDS).astype(np.float32))


def _jax_draws(key, pipe):
    """The draws of the JAX ``loss_fn`` from its key: the noise key, then
    the timestep key, split from it; an index per (batch, chunk)."""
    noise_key, t_key = jax.random.split(key)
    lo, hi = pipe._timestep_index_range()
    chunks = -(-LATENTS[2] // pipe.chunk_size)
    idx = jax.random.randint(t_key, (LATENTS[0], chunks), lo, hi)
    noise = jax.random.normal(noise_key, LATENTS, jnp.float32)
    return torch.from_numpy(np.array(idx)), torch.from_numpy(
        np.array(noise))


@pytest.mark.parametrize("n", [1000, 7, 2])
def test_gaussian_timestep_weights_match_jax(n):
    got = tft.gaussian_timestep_weights(n)
    np.testing.assert_allclose(got, jft.gaussian_timestep_weights(n),
                               rtol=1e-6, atol=1e-7)
    assert got.dtype == np.float32


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.2, 0.8), (0.5, 0.5),
                                   (0.999, 1.0), (0.9, 0.1)])
def test_timestep_index_range_matches_jax(lo, hi):
    js, ts = _schedulers()
    want = jft.DiffusionForcingPipeline._timestep_index_range(
        types.SimpleNamespace(scheduler=js, min_timestep_ratio=lo,
                              max_timestep_ratio=hi))
    got = tft.DiffusionForcingPipeline._timestep_index_range(
        types.SimpleNamespace(scheduler=ts, min_timestep_ratio=lo,
                              max_timestep_ratio=hi))
    assert got == want


@pytest.mark.parametrize("teacher_forcing", [False, True],
                         ids=["dfsft", "tfsft"])
@pytest.mark.parametrize("precondition", [True, False],
                         ids=["x0", "velocity"])
def test_loss_matches_jax(jmodel, monkeypatch, precondition,
                          teacher_forcing):
    """The loss of one micro-batch given JAX's draws. bf16 compute on both
    sides, rounded at different places (XLA against PyTorch elementwise):
    within 1e-2 relative."""
    kw = dict(precondition_outputs=precondition,
              teacher_forcing=teacher_forcing)
    jpipe, tpipe = _pipes(jmodel, monkeypatch, **kw)
    latents, embeds = _batch(1)
    key = jax.random.PRNGKey(3)
    want = jpipe._make_loss_fn()(jpipe.state.params, None,
                                 jnp.asarray(latents), jnp.asarray(embeds),
                                 key)
    before = dict(_build.PLAIN_CALLS)
    with torch.no_grad():
        got = tpipe.loss(torch.from_numpy(latents), torch.from_numpy(embeds),
                         *_jax_draws(key, tpipe))
    assert (_build.PLAIN_CALLS["flash_fwd_struct"] -
            before["flash_fwd_struct"]) == TINY_DIT["num_layers"]
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-2)
    par.destroy_mesh()


def test_one_step_matches_jax(monkeypatch):
    """One tfsft step (the diffusion-forcing draws and loss with the
    teacher-forcing forward) against JAX's train_one_step given its
    draws: loss within
    1e-2 and grad_norm within 2e-2 relative (bf16 compute), and the
    parameters after AdamW by the rule of the SFT test (every element
    within 2 lr; within 2e-6 where both sides' gradients agree in sign and
    are at least 1e-5)."""
    # a model of its own: the JAX step donates its parameters
    jpipe, tpipe = _pipes(_jax_model(), monkeypatch, teacher_forcing=True)
    latents, embeds = _batch(2)
    # the JAX step's keys: split(rng, accum + 1), micro-batch 0 takes [1]
    draws = _jax_draws(jax.random.split(jpipe.state.rng, 2)[1], tpipe)
    monkeypatch.setattr(tpipe, "draw", lambda shape: draws)
    grads = {}

    def capture(params, max_norm, _clip=ttp.clip_grad_norm):
        # the raw gradients, before clipping scales them
        grads.update({n: p.grad.clone() for n, p in
                      tpipe.transformer.named_parameters()})
        return _clip(params, max_norm)

    monkeypatch.setattr(ttp, "clip_grad_norm", capture)

    def jloss(params):
        return jpipe._make_loss_fn()(params, None, jnp.asarray(latents),
                                     jnp.asarray(embeds),
                                     jax.random.split(jpipe.state.rng, 2)[1])

    # jitted, as the step computes them
    jgrads = state_dict_from_jax(jax.tree.map(np.asarray, jax.jit(
        jax.grad(jloss))(jpipe.state.params).to_pure_dict()))
    jout = jpipe.train_one_step(latents[None], embeds[None])
    tout = tpipe.train_one_step(latents[None], embeds[None])
    assert tout["step"] == jout["step"] == 1
    np.testing.assert_allclose(tout["loss"], jout["loss"], rtol=1e-2)
    np.testing.assert_allclose(tout["grad_norm"], jout["grad_norm"],
                               rtol=2e-2)
    flat_t = torch.cat([grads[n].flatten() for n in jgrads])
    flat_j = torch.cat([jgrads[n].flatten() for n in jgrads])
    assert (flat_t - flat_j).norm() / flat_j.norm() < 3e-2
    jparams = state_dict_from_jax(jax.tree.map(
        np.asarray, jpipe.state.params.to_pure_dict()))
    _assert_adamw_params_close(tpipe.transformer.state_dict(), jparams,
                               grads, jgrads, LR,
                               clip=min(1.0, 1.0 / jout["grad_norm"]))
    par.destroy_mesh()


def test_chunk_size_must_match_the_model(jmodel, monkeypatch):
    """A chunk size other than the model's num_frames_per_block raises in
    both, before anything is built."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    js, ts = _schedulers()
    with pytest.raises(ValueError, match="num_frames_per_block"):
        jft.DiffusionForcingPipeline(jmodel, js, JTrainingArgs(), chunk_size=3)
    with pytest.raises(ValueError, match="num_frames_per_block"):
        tft.DiffusionForcingPipeline(_torch_model(jmodel), ts,
                                     TrainingArgs(device="cpu"), chunk_size=3)


@pytest.fixture
def causal_checkpoint(tmp_path, jmodel):
    """A diffusers-style directory whose ``transformer/`` is the tiny causal
    Wan, written with the port's own safetensors writer."""
    tdir = tmp_path / "CausalWan-tiny" / "transformer"
    tdir.mkdir(parents=True)
    (tdir / "config.json").write_text(json.dumps(
        dict(TINY_DIT, **CAUSAL, _class_name="CausalWanTransformer3DModel")))
    save_file(state_dict_from_jax(jax_params(jmodel)),
              str(tdir / "model.safetensors"))
    return str(tdir.parent)


@pytest.mark.parametrize("method", ["dfsft", "tfsft"])
def test_build_from_config_then_train(causal_checkpoint, monkeypatch,
                                      method):
    """Both methods resolve and build through the training entry point on
    a causal checkpoint (loaded trainable), take method_config, and train
    two steps over the CPU: finite losses, moved parameters, and every
    block's self-attention on K1 struct / K6 struct (twice forward under
    full remat)."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    assert method not in NOT_PORTED
    assert resolve_method(method).name == method
    cfg = TrainRunConfig(
        method=method,
        model=ModelSpec(pretrained_model_path=causal_checkpoint),
        training=dict(device="cpu", learning_rate=LR, seed=0, output_dir="",
                      selective_checkpointing="full", max_train_steps=2),
        method_config=dict(chunk_size=2, min_timestep_ratio=0.1,
                           precondition_outputs=False))
    m, loader = build_from_config(cfg)
    assert loader is None
    pipe = m.pipeline
    assert type(pipe.transformer).__name__ == "CausalWanTransformer3DModel"
    assert pipe.teacher_forcing == (method == "tfsft")
    assert pipe.transformer.gradient_checkpointing
    assert not pipe.precondition_outputs
    assert pipe._timestep_index_range() == (100, 1000)
    start = [p.detach().clone() for p in pipe.params]
    rows = []
    pipe.tracker = types.SimpleNamespace(
        log=lambda metrics, step: rows.append(metrics))
    before = dict(_build.PLAIN_CALLS)
    m.train([tuple(x[None] for x in _batch(s)) for s in (3, 4)])
    layers = TINY_DIT["num_layers"]
    calls = {n: _build.PLAIN_CALLS[n] - before[n] for n in before}
    assert calls["flash_fwd_struct"] == 2 * 2 * layers
    assert calls["flash_bwd_struct_dq"] == calls["flash_bwd_struct_dkv"] \
        == 2 * layers
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in rows)
    assert all(not torch.equal(a, b) for a, b in zip(start, pipe.params))
