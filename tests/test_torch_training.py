"""The port's SFT trainer against the JAX ``TrainingPipeline`` on a 2-layer
Wan with narrow widths and VSA on an exact grid: one step given JAX's random
draws (loss, gradients, grad_norm and every parameter after AdamW), the LR
schedules and AdamW against optax, clipping, the VSA sparsity ramp; and
the port's own invariants: accumulation 2 equals one batch of twice the
size, and ``selective_checkpointing="full"`` gives the gradients of no
checkpointing."""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import fastvideo_tpu.parallel as par
from fastvideo_tpu.attention.backends.abstract import AttentionMetadata
from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu.fastvideo_args import TrainingArgs as JTrainingArgs
from fastvideo_tpu.forward_context import set_forward_context
from fastvideo_tpu.models.dits.wan import WanTransformer3DModel
from fastvideo_tpu.models.schedulers.flow_match_euler import (
    FlowMatchEulerDiscreteScheduler)
from fastvideo_tpu.training import training_pipeline as jtp
from fastvideo_tpu.training.training_utils import (
    clip_grad_norm as jclip_grad_norm)
from fastvideo_tpu_torch.configs.models.dits.wan import (
    WanArchConfig as TorchWanArchConfig)
from fastvideo_tpu_torch.fastvideo_args import TrainingArgs
from fastvideo_tpu_torch.models.dits.wan import (
    WanTransformer3DModel as TorchWanTransformer3DModel)
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.schedulers.flow_match_euler import (
    FlowMatchEulerDiscreteScheduler as TorchScheduler)
from fastvideo_tpu_torch.training import training_pipeline as ttp
from fastvideo_tpu_torch.training.training_utils import clip_grad_norm

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_jax_reference import jax_plain_attention  # noqa: E402,F401
from test_torch_wan_dit import _arch, numpy_model  # noqa: E402

torch.set_num_threads(2)

# latents [accum, B, C, T, H, W]: token grid (2, 16, 16), whose exact VSA
# tile (2, 8, 8) gives 4 tiles of 128 tokens; 12 text tokens
LATENTS = (1, 1, 4, 2, 32, 32)
EMBEDS = (1, 1, 12, 32)
SPARSITY = 0.5
LR = 1e-3


def _batch(seed, latents=LATENTS, embeds=EMBEDS):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(latents).astype(np.float32),
            rng.standard_normal(embeds).astype(np.float32))


def _jax_draws(key, latents_shape):
    """The draws of one micro-batch of the JAX step, from the key the step
    hands it (``loss_fn``: noise key, then timestep key)."""
    noise_key, t_key = jax.random.split(key)
    u = jax.random.uniform(t_key, (latents_shape[0],))
    noise = jax.random.normal(noise_key, latents_shape, jnp.float32)
    return np.asarray(u), np.asarray(noise)


def _torch_pipe(monkeypatch, **extra):
    """The port's pipeline on the CPU, VSA blocks, weights from ``jmodel``
    when given (else from torch's seed 0)."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    jmodel = extra.pop("jmodel", None)
    torch.manual_seed(0)
    model = TorchWanTransformer3DModel(_arch(TorchWanArchConfig),
                                       dtype=torch.float32)
    if jmodel is not None:
        params = jax.tree.map(np.asarray, nnx.state(jmodel).to_pure_dict())
        model.load_state_dict(state_dict_from_jax(params), strict=True)
    sched = TorchScheduler(shift=3.0)
    sched.set_timesteps(1000)
    args = TrainingArgs(device="cpu", learning_rate=LR, max_grad_norm=1.0,
                        weighting_scheme="uniform", seed=0, output_dir="",
                        VSA_sparsity=SPARSITY, **extra)
    return ttp.TrainingPipeline(model, sched, args)


def _grads(pipe, latents, embeds, draws):
    """Gradients (by state_dict name) of one micro-batch loss."""
    u, noise = draws
    with pipe._context(SPARSITY):
        loss = pipe.loss(torch.from_numpy(latents), torch.from_numpy(embeds),
                         torch.tensor(u), torch.tensor(noise))
        loss.backward()
    grads = {n: p.grad.clone() for n, p in
             pipe.transformer.named_parameters()}
    pipe.optimizer.zero_grad(set_to_none=True)
    return loss.item(), grads


def _assert_adamw_params_close(got, want, got_grads, want_grads, lr,
                               clip):
    """Parameters after one AdamW step from the same start. The first
    update is lr * g / (|g| + 1e-8) of the clipped gradient g (``clip``
    times the raw one): +-lr by the gradient's sign, unless |g| is near
    1e-8. Where the two sides' gradients are at the bf16 noise level (the
    cross-attention's key bias shifts every score of a row alike, so its
    exact gradient is 0), their signs may differ and the parameters by up
    to 2 lr; every element is held within that. Where both clipped
    gradients have one sign and are at least 1e-5 (so that the 1e-8 moves
    the update by under 1e-3 lr), within fp32 rounding (2e-6)."""
    for name, w in want.items():
        g = got[name].detach().float().numpy()
        w = w.float().numpy()
        diff = np.abs(g - w)
        assert diff.max() <= 2 * lr + 1e-6, (name, diff.max())
        a, b = got_grads[name].numpy(), want_grads[name].numpy()
        sure = (np.sign(a) == np.sign(b)) & (
            np.minimum(np.abs(a), np.abs(b)) * clip >= 1e-5)
        assert diff[sure].max(initial=0) <= 2e-6, (name,
                                                   diff[sure].max(initial=0))


def test_one_step_matches_jax_pipeline(monkeypatch, jax_plain_attention):
    """One SFT step: the port's loss, gradients, grad_norm and AdamW
    parameters against JAX's TrainingPipeline given JAX's draws. bf16
    compute on both sides, rounded at different places (XLA against
    PyTorch elementwise), so: loss within 1e-2 relative, grad_norm within
    2e-2 relative, the gradients within 3e-2 relative L2 over the model
    and 1e-1 per tensor, and the parameters by the AdamW rule above."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    par.destroy_mesh()
    jmodel = numpy_model(lambda: WanTransformer3DModel(
        _arch(WanArchConfig), param_dtype=jnp.float32, rngs=nnx.Rngs(0)),
        seed=0)
    tpipe = _torch_pipe(monkeypatch, jmodel=jmodel)
    sched = FlowMatchEulerDiscreteScheduler(shift=3.0)
    sched.set_timesteps(1000)
    jargs = JTrainingArgs(num_gpus=1, dp_size=1, learning_rate=LR,
                          max_grad_norm=1.0, weighting_scheme="uniform",
                          seed=0, output_dir="", VSA_sparsity=SPARSITY)
    jpipe = jtp.TrainingPipeline(jmodel, sched, jargs)
    latents, embeds = _batch(1)
    # the JAX step's keys: split(rng, accum + 1), micro-batch 0 takes [1]
    micro_key = jax.random.split(jpipe.state.rng, 2)[1]
    draws = _jax_draws(micro_key, latents.shape[1:])

    loss_fn = jpipe._make_loss_fn()
    with set_forward_context(attn_metadata=AttentionMetadata(
            extra={"VSA_sparsity": SPARSITY})):
        jloss, jgrads = jax.value_and_grad(loss_fn)(
            jpipe.state.params, None, jnp.asarray(latents[0]),
            jnp.asarray(embeds[0]), micro_key)
    jgrads = state_dict_from_jax(jax.tree.map(np.asarray,
                                              jgrads.to_pure_dict()))
    tloss, tgrads = _grads(tpipe, latents[0], embeds[0], draws)
    np.testing.assert_allclose(tloss, float(jloss), rtol=1e-2)
    flat_t = torch.cat([tgrads[n].flatten() for n in jgrads])
    flat_j = torch.cat([jgrads[n].flatten() for n in jgrads])
    assert (flat_t - flat_j).norm() / flat_j.norm() < 3e-2
    for n, g in jgrads.items():
        assert (tgrads[n] - g).norm() <= 1e-1 * g.norm() + 1e-6, n

    jout = jpipe.train_one_step(latents, embeds, vsa_sparsity=SPARSITY)
    monkeypatch.setattr(tpipe, "draw", lambda shape: tuple(
        map(torch.tensor, draws)))
    tout = tpipe.train_one_step(latents, embeds, vsa_sparsity=SPARSITY)
    assert tout["step"] == jout["step"] == 1
    np.testing.assert_allclose(tout["loss"], jout["loss"], rtol=1e-2)
    np.testing.assert_allclose(tout["grad_norm"], jout["grad_norm"],
                               rtol=2e-2)
    jparams = state_dict_from_jax(jax.tree.map(
        np.asarray, jpipe.state.params.to_pure_dict()))
    _assert_adamw_params_close(tpipe.transformer.state_dict(), jparams,
                               tgrads, jgrads, LR,
                               clip=min(1.0, 1.0 / jout["grad_norm"]))
    par.destroy_mesh()


SCHEDULES = [
    dict(lr_scheduler="constant"),
    dict(lr_scheduler="constant", lr_warmup_steps=3),
    dict(lr_scheduler="linear"),
    dict(lr_scheduler="cosine", lr_warmup_steps=2),
]


@pytest.mark.parametrize("sched", SCHEDULES,
                         ids=["constant", "constant_warmup", "linear",
                              "cosine"])
def test_lr_schedule_matches_optax(sched):
    """The LR at each update count, against the optax schedule the JAX
    trainer builds. optax evaluates it in float32: within 1e-6 of the
    base LR."""
    kw = dict(learning_rate=3e-4, max_train_steps=10, **sched)
    want = jtp.build_lr_schedule(JTrainingArgs(**kw))
    got = ttp.build_lr_schedule(TrainingArgs(**kw))
    for count in range(14):
        w = float(want(count)) if callable(want) else float(want)
        np.testing.assert_allclose(got(count), w, rtol=0, atol=3e-10)
    if sched.get("lr_warmup_steps"):
        assert got(0) == 0.0  # optax's count before the first update


def test_adamw_matches_optax():
    """Three AdamW updates (cosine schedule with warm-up, weight decay) on
    identical gradients: the parameters and moments agree to fp32
    rounding."""
    kw = dict(learning_rate=1e-2, max_train_steps=6, lr_scheduler="cosine",
              lr_warmup_steps=1, weight_decay=0.1, betas=(0.8, 0.95))
    rng = np.random.default_rng(4)
    p0 = {"a": rng.standard_normal((5, 7)).astype(np.float32),
          "b": rng.standard_normal((3,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    tx = jtp.build_optimizer(JTrainingArgs(**kw))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
    args = TrainingArgs(**kw)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = ttp.build_optimizer(list(tp.values()), args)
    sched = ttp.build_lr_schedule(args)
    for count, g in enumerate(grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = sched(count)
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        assert opt.state[tp[k]]["exp_avg"].dtype == torch.float32


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_matches_jax(max_norm):
    rng = np.random.default_rng(5)
    g = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in (("a", (4, 6)), ("b", (9,)))}
    jclipped, jnorm = jclip_grad_norm({k: jnp.asarray(v)
                                       for k, v in g.items()}, max_norm)
    params = [torch.nn.Parameter(torch.zeros(v.shape)) for v in g.values()]
    for p, v in zip(params, g.values()):
        p.grad = torch.from_numpy(v.copy())
    norm = clip_grad_norm(params, max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for p, k in zip(params, g):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jclipped[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("ramp", [
    dict(VSA_sparsity=0.5, VSA_decay_rate=0.25, VSA_decay_interval_steps=2),
    dict(VSA_sparsity=0.9, VSA_decay_rate=0.2, VSA_decay_interval_steps=3),
    dict(VSA_sparsity=0.8),
    dict(),
])
def test_vsa_sparsity_ramp_matches_jax(ramp):
    want = types.SimpleNamespace(args=JTrainingArgs(**ramp))
    got = types.SimpleNamespace(args=TrainingArgs(**ramp))
    for step in range(0, 16):
        assert (ttp.TrainingPipeline.current_vsa_sparsity(got, step) ==
                jtp.TrainingPipeline.current_vsa_sparsity(want, step))


def _step_grads(pipe, latents, embeds, draws):
    """One train_one_step with the given draws (one pair a micro-batch);
    returns (metrics, the clipped gradients the optimizer saw)."""
    seen = []
    queue = list(draws)
    pipe.draw = lambda shape: queue.pop(0)
    step = pipe.optimizer.step

    def capture(*a, **kw):
        seen.append([p.grad.clone() for p in pipe.params])
        return step(*a, **kw)

    pipe.optimizer.step = capture
    out = pipe.train_one_step(latents, embeds, vsa_sparsity=SPARSITY)
    return out, seen[0]


def test_accumulation_equals_double_batch(monkeypatch):
    """Two micro-batches of one sample average to one batch of two: same
    loss, grad_norm and (clipped) gradients. Each sample's compute is its
    own in both, so only the bf16 products' row blocking differs: 1e-3
    relative on the loss and norm, 1e-2 relative L2 on the gradients."""
    lat, emb = _batch(2, (1, 2, 4, 2, 32, 32), (1, 2, 12, 32))
    rng = np.random.default_rng(6)
    u = rng.random(2).astype(np.float32)
    noise = rng.standard_normal(lat.shape[1:]).astype(np.float32)
    whole = _torch_pipe(monkeypatch)
    out1, g1 = _step_grads(whole, lat, emb,
                           [(torch.from_numpy(u), torch.from_numpy(noise))])
    split = _torch_pipe(monkeypatch, gradient_accumulation_steps=2)
    lat2 = lat.reshape(2, 1, *lat.shape[2:])
    emb2 = emb.reshape(2, 1, *emb.shape[2:])
    out2, g2 = _step_grads(split, lat2, emb2, [
        (torch.from_numpy(u[i:i + 1]), torch.from_numpy(noise[i:i + 1]))
        for i in range(2)])
    np.testing.assert_allclose(out2["loss"], out1["loss"], rtol=1e-3)
    np.testing.assert_allclose(out2["grad_norm"], out1["grad_norm"],
                               rtol=1e-3)
    a, b = torch.cat([g.flatten() for g in g1]), torch.cat(
        [g.flatten() for g in g2])
    assert (a - b).norm() / a.norm() < 1e-2


def test_full_checkpointing_keeps_the_gradients(monkeypatch):
    """selective_checkpointing="full" recomputes each block in the backward,
    which runs outside the forward context (on CUDA on autograd's own
    thread): each checkpointed block is bound to the forward's context, so
    the recompute picks the same VSA tiles, and the loss and gradients are
    those of no checkpointing; so are "ops"'s (which keeps the matmul
    outputs: ``tests/test_torch_remat_ops.py``)."""
    lat, emb = _batch(3)
    rng = np.random.default_rng(7)
    draws = (torch.from_numpy(rng.random(1).astype(np.float32)),
             torch.from_numpy(rng.standard_normal(lat.shape[1:]).astype(
                 np.float32)))
    outs = {}
    for remat in ("full", "ops", "none"):
        pipe = _torch_pipe(monkeypatch, selective_checkpointing=remat)
        assert pipe.transformer.gradient_checkpointing == (remat != "none")
        outs[remat] = _step_grads(pipe, lat, emb, [draws])
    for remat in ("full", "ops"):
        assert outs[remat][0]["loss"] == outs["none"][0]["loss"]
        for a, b in zip(outs[remat][1], outs["none"][1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_sigmas_and_density_sampling():
    """get_sigmas against the JAX one on the trainer's scheduler, and the
    density sampling's range and transforms (its draws are torch's)."""
    from fastvideo_tpu.training.training_utils import get_sigmas as jsig
    from fastvideo_tpu_torch.training.training_utils import (
        compute_density_for_timestep_sampling, get_sigmas)

    jsched = FlowMatchEulerDiscreteScheduler(shift=3.0)
    jsched.set_timesteps(1000)
    tsched = TorchScheduler(shift=3.0)
    tsched.set_timesteps(1000)
    ts = np.array([999.0, 757.3, 12.0], np.float32)
    want = np.asarray(jsig(jsched, jnp.asarray(ts), 5))
    got = get_sigmas(tsched, torch.from_numpy(ts), 5)
    assert got.shape == (3, 1, 1, 1, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    for scheme in ("uniform", "logit_normal", "mode"):
        u = compute_density_for_timestep_sampling(
            scheme, 4096, torch.Generator().manual_seed(0))
        assert u.shape == (4096,) and u.dtype == torch.float32
        assert 0.0 <= u.min() and u.max() <= 1.0
