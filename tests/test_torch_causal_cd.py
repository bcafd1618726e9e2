"""The port's causal consistency distillation against the JAX package:
``SelfForcingFlowMatchScheduler`` (its sigma, timestep and training-weight
tables, ``step``, ``add_noise``, ``add_noise_high``, ``training_target``
and ``training_weight``), two ``CausalCDPipeline`` steps on the tiny
causal Wan given JAX's draws (the loss, the first update's gradients, the
student's and the EMA's parameters; the EMA moving only from
``ema_start_step``; the teacher untouched; no clipping), and
``causal_cd`` through ``build_from_config`` on a Parquet shard."""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvideo_tpu.parallel as par
from fastvideo_tpu.training.methods import causal_cd as jcd
from fastvideo_tpu_torch.entrypoints.cli.train import build_from_config
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.schedulers.scheduling_self_forcing_flow_match import (  # noqa: E501
    SelfForcingFlowMatchScheduler as TorchScheduler)
from fastvideo_tpu_torch.training.methods import NOT_PORTED, resolve_method
from fastvideo_tpu_torch.training.methods import causal_cd as tcd
from fastvideo_tpu_torch.training.run_config import load_train_config

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_dmd2 import _assert_grads_close, _loss_fn  # noqa: E402
from test_torch_dmd2 import _params  # noqa: E402
from test_torch_self_forcing import (EMBEDS, LATENT, LR,  # noqa: E402
                                     assert_params_close, causal_checkpoint,
                                     jax_args, jax_models, normal,
                                     torch_args, torch_model, train_config,
                                     write_shard)
from test_torch_training import _assert_adamw_params_close  # noqa: E402

torch.set_num_threads(2)

assert causal_checkpoint  # a fixture of this module too

# the module (a package ``__init__`` may shadow the name)
JScheduler = importlib.import_module(
    "fastvideo_tpu.models.schedulers.scheduling_self_forcing_flow_match"
).SelfForcingFlowMatchScheduler

SCHEDULERS = [
    dict(num_inference_steps=48, shift=5.0, sigma_min=0.0, sigma_max=1.0,
         extra_one_step=True),
    dict(num_inference_steps=4, shift=5.0, sigma_min=0.0, sigma_max=1.0,
         extra_one_step=True, training=True),
    dict(num_inference_steps=1000, shift=3.0, training=True),
    dict(num_inference_steps=7, shift=1.0, inverse_timesteps=True),
    dict(num_inference_steps=9, shift=2.0, reverse_sigmas=True,
         training=True),
]


@pytest.mark.parametrize("i", range(len(SCHEDULERS)))
def test_scheduler_matches_jax(i):
    """The tables bit for bit; the Euler step (also at the last index and
    to_final), the forward and high-noise corruptions and the training
    weight of per-sample timesteps off the grid, within fp32 rounding."""
    kw = SCHEDULERS[i]
    js, ts = JScheduler(**kw), TorchScheduler(**kw)
    np.testing.assert_array_equal(ts.sigmas, np.asarray(js.sigmas))
    np.testing.assert_array_equal(ts.timesteps, np.asarray(js.timesteps))
    if kw.get("training"):
        np.testing.assert_array_equal(ts.linear_timesteps_weights,
                                      js.linear_timesteps_weights)
        assert np.isfinite(ts.linear_timesteps_weights).all()
    rng = np.random.default_rng(i)
    shape = (3, 4, 2, 4, 4)
    x, v, n = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    steps = js.timesteps
    t = np.array([steps[0] + 0.3, steps[len(steps) // 2] - 0.2,
                  steps[-2] + 0.1], np.float32)
    t_last = np.array([steps[-1]] * 3, np.float32)
    tx, tv, tn = (torch.from_numpy(a) for a in (x, v, n))
    for tt, final in ((t, False), (t, True), (t_last, False)):
        want = js.step(jnp.asarray(v), jnp.asarray(tt), jnp.asarray(x),
                       to_final=final).prev_sample
        got = ts.step(tv, torch.from_numpy(tt), tx,
                      to_final=final).prev_sample
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        ts.add_noise(tx, tn, torch.from_numpy(t)).numpy(),
        np.asarray(js.add_noise(jnp.asarray(x), jnp.asarray(n),
                                jnp.asarray(t))), rtol=1e-6, atol=1e-6)
    high = np.array([steps[0]] * 3, np.float32)
    bound = np.array([steps[-1]] * 3, np.float32)
    if not (kw.get("reverse_sigmas") or kw.get("inverse_timesteps")):
        np.testing.assert_allclose(
            ts.add_noise_high(tx, tn, torch.from_numpy(high),
                              torch.from_numpy(bound)).numpy(),
            np.asarray(js.add_noise_high(jnp.asarray(x), jnp.asarray(n),
                                         jnp.asarray(high),
                                         jnp.asarray(bound))),
            rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        ts.training_target(tx, tn, torch.from_numpy(t)).numpy(),
        np.asarray(js.training_target(jnp.asarray(x), jnp.asarray(n), t)))
    if kw.get("training"):
        np.testing.assert_array_equal(
            ts.training_weight(torch.from_numpy(t)).numpy(),
            np.asarray(js.training_weight(jnp.asarray(t))))


N_GRID = 6
EMA_DECAY = 0.5


def test_two_steps_match_jax(monkeypatch):
    """Two steps at ema_start_step 1 under FLASH_ATTN given JAX's draws:
    the loss within 1e-2 relative; step 0's gradients against JAX's and
    the parameters after its unclipped AdamW update by the SFT test's
    rule; the student after each step within the DMD2 test's bars; the
    EMA equal to the student's start after step 0 and to JAX's EMA after
    step 1; the teacher bit for bit."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    par.destroy_mesh()
    jstudent, jteacher = jax_models((0, 1))
    tstudent, tteacher = (torch_model(m) for m in (jstudent, jteacher))
    start = {k: v.clone() for k, v in tstudent.state_dict().items()}
    teacher0 = {k: v.clone() for k, v in tteacher.state_dict().items()}
    kw = dict(discrete_cd_n=N_GRID, guidance_scale=3.0, ema_decay=EMA_DECAY,
              ema_start_step=1, flow_shift=5.0)
    jpipe = jcd.CausalCDPipeline(jstudent, jteacher, jax_args(), **kw)
    tpipe = tcd.CausalCDPipeline(tstudent, tteacher, torch_args(), **kw)
    np.testing.assert_array_equal(tpipe.sigmas, np.asarray(jpipe.sigmas))
    assert tstudent.gradient_checkpointing
    grads = {}
    step_fn = tpipe.optimizer.step

    def keep(*a, **k):
        grads.setdefault("first", {n: p.grad.detach().clone()
                                   for n, p in tstudent.named_parameters()
                                   if p.grad is not None})
        return step_fn(*a, **k)

    monkeypatch.setattr(tpipe.optimizer, "step", keep)
    rng = np.random.default_rng(4)
    latents = rng.standard_normal((1,) + LATENT).astype(np.float32)
    embeds = rng.standard_normal((1,) + EMBEDS).astype(np.float32)
    key = jpipe.rng
    for step in range(2):
        key, sub = jax.random.split(key)
        idx_key, noise_key = jax.random.split(sub)
        idx = int(jax.random.randint(idx_key, (), 0, N_GRID - 1))
        draws = {"idx": idx, "noise": normal(noise_key, LATENT)}
        monkeypatch.setattr(tpipe, "draw", lambda shape, d=draws: d)
        s0 = jpipe.student_params
        jout = jpipe.train_one_step(latents, embeds)
        tout = tpipe.train_one_step(latents, embeds)
        assert set(jout) <= set(tout) and tout["step"] == step + 1
        np.testing.assert_allclose(tout["loss"], jout["loss"], rtol=1e-2)
        assert tout["grid_index"] == idx and np.isfinite(tout["grad_norm"])
        if step == 0:
            lat = jnp.asarray(latents).reshape(LATENT)
            emb = jnp.asarray(embeds).reshape(EMBEDS)
            with par.mesh_context(jpipe.mesh):
                _, g = jax.jit(jax.value_and_grad(
                    _loss_fn(jpipe._train_step)))(
                    s0, jpipe.teacher_params, jpipe.ema_params, lat, emb,
                    jnp.zeros_like(emb), sub)
            want = state_dict_from_jax(jax.tree.map(np.asarray,
                                                    g.to_pure_dict()))
            _assert_grads_close(grads["first"], want)
            _assert_adamw_params_close(tstudent.state_dict(),
                                       _params(jpipe.student_params),
                                       grads["first"], want, LR, clip=1.0)
            for name, e in tpipe.ema.state_dict().items():
                assert torch.equal(e, start[name]), name
        assert_params_close(dict(tstudent.state_dict()),
                            _params(jpipe.student_params), start, step + 1)
    assert_params_close(dict(tpipe.ema.state_dict()),
                        _params(jpipe.ema_params), start, 1)
    assert np.array_equal(np.asarray(key), np.asarray(jpipe.rng))
    for name, t in tteacher.state_dict().items():
        assert torch.equal(t, teacher0[name]), name
    assert all(p.grad is None for p in tpipe.ema.parameters())
    par.destroy_mesh()


def test_build_from_config_trains_causal_cd(causal_checkpoint, tmp_path,
                                            monkeypatch):
    """``method: causal_cd`` with its ``method_config`` on a Parquet shard:
    two steps move the student and (from step 0) the EMA, not the
    teacher."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    cfg = load_train_config(train_config(
        tmp_path, "causal_cd", causal_checkpoint, write_shard(tmp_path),
        {"discrete_cd_N": 4, "guidance_scale": 2.0, "ema_decay": 0.5,
         "ema_start_step": 0, "flow_shift": 3.0}))
    method, loader = build_from_config(cfg)
    assert isinstance(method, tcd.CausalCDMethod)
    assert "causal_cd" not in NOT_PORTED
    assert resolve_method("causal_cd") is tcd.CausalCDMethod
    pipe = method.pipeline
    assert (pipe.n, pipe.guidance_scale, pipe.ema_decay,
            pipe.ema_start_step) == (4, 2.0, 0.5, 0)
    before = [{n: p.detach().clone() for n, p in m.named_parameters()}
              for m in (pipe.student, pipe.teacher, pipe.ema)]
    try:
        method.train(loader)
    finally:
        loader.shutdown()
    assert pipe.step == 2
    moved = [not any(torch.equal(before[i][n], p)
                     for n, p in m.named_parameters())
             for i, m in enumerate((pipe.student, pipe.teacher, pipe.ema))]
    assert moved == [True, False, True]
    # callbacks are dispatched (the loop is at max_train_steps: start and
    # end only)
    method.train([], callbacks={"grad_clip": {"max_grad_norm": 0.25}})
    assert pipe.args.max_grad_norm == 0.25
