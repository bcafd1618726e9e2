"""The port's AnyFlow distillation against the JAX
``AnyFlowDistillationPipeline`` on a 1-layer Wan with narrow widths, the
dual-timestep branch on every role and VSA on an exact grid (at sparsity
0: no forward context, as in JAX): the flow-map rollout with a handed
grad step (its sample and its gradient), one DMD step given JAX's draws,
the rollout schedule and the ``t_list_override`` check."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastvideo_tpu.parallel as par
from fastvideo_tpu.fastvideo_args import TrainingArgs as JTrainingArgs
from fastvideo_tpu.training import distillation_pipeline as jdp
from fastvideo_tpu.training.methods import anyflow as janyflow
from fastvideo_tpu_torch.fastvideo_args import TrainingArgs
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.training import distillation_pipeline as tdp
from fastvideo_tpu_torch.training.methods import anyflow as tanyflow

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_jax_reference import jax_plain_attention  # noqa: E402,F401
from test_torch_anyflow import (EMBEDS, LATENT, LR, R_ARCH,  # noqa: E402
                                _jax_model, _torch_model)
from test_torch_dmd2 import (_assert_grads_close,  # noqa: E402
                             _assert_params_close, _params)

torch.set_num_threads(2)


def _dmd_kw():
    return dict(dfake_gen_update_ratio=1, dmd_denoising_steps=(1000, 500))


def _anyflow_pipes(monkeypatch, t_list=(1000.0, 800.0, 400.0, 0.0)):
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    par.destroy_mesh()
    jms = [_jax_model(seed=s, **R_ARCH) for s in (0, 1, 2)]
    tms = [_torch_model(m, **R_ARCH) for m in jms]
    jpipe = janyflow.AnyFlowDistillationPipeline(
        *jms, JTrainingArgs(num_gpus=1, dp_size=1, learning_rate=LR,
                            max_grad_norm=1.0, seed=0, output_dir=""),
        jdp.DMDConfig(**_dmd_kw()), t_list_override=list(t_list))
    tpipe = tanyflow.AnyFlowDistillationPipeline(
        *tms, TrainingArgs(device="cpu", learning_rate=LR, max_grad_norm=1.0,
                           seed=0, output_dir="",
                           selective_checkpointing="full"),
        tdp.DMDConfig(**_dmd_kw()), t_list_override=list(t_list))
    return jpipe, tpipe, tms


def test_rollout_matches_jax(monkeypatch, jax_plain_attention):
    """The 3-step flow-map rollout (r = t_next reaches the generator) from
    one noise with the grad step handed to both: the sample within 2e-2
    of its largest magnitude, and the gradient of sum(x w) with respect to
    the generator by the DMD2 test's rule (it flows through the grad step
    alone)."""
    jpipe, tpipe, (tgen, _, _) = _anyflow_pipes(monkeypatch)
    grad_step = 1
    rng = np.random.default_rng(6)
    noise = rng.standard_normal(LATENT).astype(np.float32)
    w = rng.standard_normal(LATENT).astype(np.float32)
    emb = rng.standard_normal(EMBEDS).astype(np.float32)
    key = next(k for k in (jax.random.PRNGKey(i) for i in range(200))
               if int(jax.random.randint(jax.random.split(k)[0], (), 0, 3))
               == grad_step)

    def jloss(params):
        x = jpipe._generator_rollout(params, jnp.asarray(noise),
                                     jnp.asarray(emb), key)
        return jnp.sum(x * jnp.asarray(w)), x

    (_, jx), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jpipe.gen_params)
    jgrads = state_dict_from_jax(jax.tree.map(np.asarray,
                                              jgrads.to_pure_dict()))
    draws = tanyflow.FlowMapDraws([], 0, None, grad_step)
    x = tpipe._update_rollout(torch.from_numpy(noise), torch.from_numpy(emb),
                              draws)
    (x * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx),
                               atol=2e-2 * np.abs(np.asarray(jx)).max())
    _assert_grads_close({n: p.grad for n, p in tgen.named_parameters()},
                        jgrads)
    par.destroy_mesh()


def _jax_step_draws(rng, steps: int):
    """JAX's draws of one train_one_step with a generator and a critic
    update, from its key; each update's key splits into the rollout's (its
    first split draws the grad step), the timestep's and the noise's."""
    rng, k = jax.random.split(rng)
    out = {"noise": torch.from_numpy(np.array(
        jax.random.normal(k, LATENT, jnp.float32)))}
    for role in ("generator", "critic"):
        rng, key = jax.random.split(rng)
        k_roll, k_t, k_noise = jax.random.split(key, 3)
        grad_step = int(jax.random.randint(jax.random.split(k_roll)[0], (),
                                           0, steps))
        t_int = int(jax.random.randint(k_t, (1,), 0, 1000)[0])
        noise = torch.from_numpy(np.array(
            jax.random.normal(k_noise, LATENT, jnp.float32)))
        out[role] = tanyflow.FlowMapDraws([], t_int, noise, grad_step)
    return out


def test_one_dmd_step_matches_jax(monkeypatch, jax_plain_attention):
    """One AnyFlow step (a generator and a critic update) over a 2-step
    schedule (1000, 500, 0) given JAX's draws: losses within 1e-2
    relative, grad norms within 2e-2 relative, the generator's and the
    fake score's parameters after their updates by the DMD2 test's rule
    (each element within 2 lr, the moves within 0.15 relative L2); every
    trained parameter has a gradient (the fake score's delta_embedder,
    which never sees r, a zero one, as in JAX's tree); the teacher
    untouched. The gradient through the rollout's grad step is held in
    ``test_rollout_matches_jax``."""
    jpipe, tpipe, (tgen, treal, tfake) = _anyflow_pipes(
        monkeypatch, t_list=(1000.0, 500.0, 0.0))
    starts = [{n: t.clone() for n, t in m.state_dict().items()}
              for m in (tgen, treal, tfake)]
    emb = np.random.default_rng(7).standard_normal(EMBEDS).astype(np.float32)
    neg = np.zeros_like(emb)
    draws = _jax_step_draws(jpipe.rng, 2)
    clip = tdp.clip_grad_norm

    def every_grad(params, max_norm):
        assert all(p.grad is not None for p in params)
        return clip(params, max_norm)

    monkeypatch.setattr(tdp, "clip_grad_norm", every_grad)
    monkeypatch.setattr(tpipe, "draw", lambda shape, g: draws)
    jout = jpipe.train_one_step(emb, neg, LATENT)
    tout = tpipe.train_one_step(emb, neg, LATENT)
    assert tout.keys() == jout.keys()
    for name in ("generator_loss", "critic_loss"):
        np.testing.assert_allclose(tout[name], jout[name], rtol=1e-2,
                                   err_msg=name)
    for name in ("generator_grad_norm", "critic_grad_norm"):
        np.testing.assert_allclose(tout[name], jout[name], rtol=2e-2,
                                   err_msg=name)
    _assert_params_close(tgen, _params(jpipe.gen_params), starts[0], 1)
    _assert_params_close(tfake, _params(jpipe.fake_params), starts[2], 1)
    for n, t in treal.state_dict().items():
        assert torch.equal(t, starts[1][n]), n
    par.destroy_mesh()


def test_rollout_schedule_and_checks(monkeypatch):
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    models = [_torch_model(**R_ARCH) for _ in range(3)]
    args = TrainingArgs(device="cpu", output_dir="")
    pipe = tanyflow.AnyFlowDistillationPipeline(
        *models, args, tdp.DMDConfig(dmd_denoising_steps=(1000, 757, 522)))
    assert pipe._rollout_schedule() == [1000.0, 757.0, 522.0, 0.0]
    assert pipe._has_r and pipe.student_sample_steps == 4
    d = pipe._update_draws(LATENT)
    assert 0 <= d.grad_step < 3 and d.rollout == []
    with pytest.raises(ValueError, match="descending"):
        tanyflow.AnyFlowDistillationPipeline(
            *models, args, t_list_override=[0.0, 500.0, 1000.0])
    with pytest.raises(ValueError, match="positive"):
        tanyflow.AnyFlowDistillationPipeline(*models, args,
                                             student_sample_steps=0)
    plain = tanyflow.AnyFlowDistillationPipeline(
        *[_torch_model() for _ in range(3)], args)
    assert not plain._has_r
