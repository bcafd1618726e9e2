"""The port's AnyFlow pieces against the JAX package's on a 1-layer Wan with
narrow widths: the DiT's dual-timestep ``r_embedder`` in both fusions and
both delta types; ``FlowMapEulerDiscreteScheduler``; the
``anyflow_pretrain`` loss and gradients at batch 4 (all three branches)
given JAX's draws, and batch 1 (the free branch alone); both methods
through ``build_from_config`` with the copy rule (``delta_embedder``
starts as ``time_embedder`` when the checkpoint has no delta weights).
The AnyFlow rollout and DMD step are in test_torch_anyflow_dmd.py."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import fastvideo_tpu.parallel as par
from fastvideo_tpu.attention.backends.abstract import AttentionMetadata
from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu.fastvideo_args import TrainingArgs as JTrainingArgs
from fastvideo_tpu.forward_context import set_forward_context
from fastvideo_tpu.models.dits.wan import WanTransformer3DModel
from fastvideo_tpu.models.schedulers import scheduling_flow_map_euler as jfm
from fastvideo_tpu.training.methods import anyflow_pretrain as jpre
from fastvideo_tpu_torch.configs.models.dits.wan import (
    WanArchConfig as TorchWanArchConfig)
from fastvideo_tpu_torch.dataset.parquet import (record_from_sample,
                                                 write_parquet_dataset)
from fastvideo_tpu_torch.entrypoints.cli.train import build_from_config
from fastvideo_tpu_torch.fastvideo_args import TrainingArgs
from fastvideo_tpu_torch.models.dits.wan import (
    WanTransformer3DModel as TorchWanTransformer3DModel)
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.loader.safetensors_io import save_file
from fastvideo_tpu_torch.models.schedulers import (
    scheduling_flow_map_euler as tfm)
from fastvideo_tpu_torch.training.methods import NOT_PORTED, resolve_method
from fastvideo_tpu_torch.training.methods import anyflow_pretrain as tpre
from fastvideo_tpu_torch.training.run_config import load_train_config

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_dmd2 import _assert_grads_close  # noqa: E402
from test_torch_wan_dit import jax_params, numpy_model  # noqa: E402
from utils import TINY_DIT  # noqa: E402

torch.set_num_threads(2)

ARCH = dict(TINY_DIT, num_layers=1)
R_ARCH = dict(r_embedder=True, r_embedder_fusion="additive",
              r_embedder_gate_value=0.25, r_embedder_deltatime_type="r")
# noise [B, C, T, H, W]: token grid (2, 16, 16), 4 exact VSA tiles
LATENT = (1, 4, 2, 32, 32)
EMBEDS = (1, 12, ARCH["text_dim"])
SPARSITY = 0.5
LR = 1e-3


def _arch(cls, **extra):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in dict(ARCH, **extra).items()})


def _jax_model(seed=0, **extra):
    return numpy_model(lambda: WanTransformer3DModel(
        _arch(WanArchConfig, **extra), param_dtype=jnp.float32,
        rngs=nnx.Rngs(0)), seed=seed)


def _torch_model(jmodel=None, **extra):
    torch.manual_seed(0)
    model = TorchWanTransformer3DModel(_arch(TorchWanArchConfig, **extra),
                                       dtype=torch.float32)
    if jmodel is not None:
        model.load_state_dict(state_dict_from_jax(jax_params(jmodel)),
                              strict=True)
    return model


# -- the r_embedder -----------------------------------------------------------


@pytest.mark.parametrize("fusion", ["additive", "gated"])
@pytest.mark.parametrize("delta", ["r", "t-r"])
def test_r_embedder_forward_matches_jax(fusion, delta, monkeypatch):
    """The DiT with the branch, JAX's weights (``delta_embedder`` through
    the carrier), in fp32: with r its output within 2e-5 + 1e-4 |JAX| of
    JAX's (the DiT test's bars) and unlike the output without r, which is
    the branch-free model's, JAX's too."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    extra = dict(R_ARCH, r_embedder_fusion=fusion,
                 r_embedder_deltatime_type=delta, r_embedder_gate_value=0.4)
    jmodel = _jax_model(**extra)
    model = _torch_model(jmodel, **extra).eval()
    assert "condition_embedder.delta_embedder.mlp.fc_in.weight" in dict(
        model.state_dict())
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 2, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 12, ARCH["text_dim"])).astype(np.float32)
    t = np.float32([700.0, 300.0])
    r = np.float32([250.0, 0.0])
    want = np.asarray(jmodel(jnp.asarray(x), jnp.asarray(ctx),
                             jnp.asarray(t), r_timestep=jnp.asarray(r)))
    want_none = np.asarray(jmodel(jnp.asarray(x), jnp.asarray(ctx),
                                  jnp.asarray(t)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(ctx),
                    torch.from_numpy(t), r_timestep=torch.from_numpy(r))
        got_none = model(torch.from_numpy(x), torch.from_numpy(ctx),
                         torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got_none.numpy(), want_none, atol=2e-5,
                               rtol=1e-4)
    assert np.abs(want - want_none).max() > 1e-3


def test_r_embedder_checks_its_options():
    for bad in (dict(r_embedder_fusion="mul"),
                dict(r_embedder_deltatime_type="r-t")):
        with pytest.raises(ValueError, match="bad r_embedder"):
            TorchWanTransformer3DModel(_arch(TorchWanArchConfig,
                                             **dict(R_ARCH, **bad)),
                                       device="meta")
    plain = TorchWanTransformer3DModel(_arch(TorchWanArchConfig),
                                       device="meta")
    assert plain.condition_embedder.delta_embedder is None


# -- the flow-map scheduler ---------------------------------------------------


@pytest.mark.parametrize("shift", [1.0, 3.0])
def test_flow_map_scheduler_matches_jax(shift):
    """Its tables, shift, noise, step and training weights against JAX's
    (fp32 on both sides: within 1e-6 relative)."""
    js = jfm.FlowMapEulerDiscreteScheduler(shift=shift)
    ts = tfm.FlowMapEulerDiscreteScheduler(shift=shift)
    js.set_timesteps(6)
    ts.set_timesteps(6)
    np.testing.assert_allclose(ts.timesteps, js.timesteps, rtol=1e-6)
    np.testing.assert_allclose(ts.sigmas, js.sigmas, rtol=1e-6)
    custom = [1000.0, 600.0, 600.0, 0.0]
    js.set_timesteps(custom_timesteps=custom)
    ts.set_timesteps(custom_timesteps=custom)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    for bad in ([0.0, 1.0], None):
        with pytest.raises(ValueError):
            ts.set_timesteps(custom_timesteps=bad) if bad else \
                ts.set_timesteps(0)
    rng = np.random.default_rng(2)
    u = rng.random(5).astype(np.float32)
    np.testing.assert_allclose(ts.apply_shift(torch.from_numpy(u)).numpy(),
                               np.asarray(js.apply_shift(jnp.asarray(u))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        ts.apply_shift(torch.from_numpy(u), shift=5.0).numpy(),
        np.asarray(js.apply_shift(jnp.asarray(u), shift=5.0)), rtol=1e-6)
    x = rng.standard_normal((5, 3, 2, 4)).astype(np.float32)
    n = rng.standard_normal(x.shape).astype(np.float32)
    t = np.float32([999, 700, 500, 10, 0])
    r = np.float32([500, 0, 500, 0, 0])
    np.testing.assert_allclose(
        ts.add_noise(torch.from_numpy(x), torch.from_numpy(n),
                     torch.from_numpy(t)).numpy(),
        np.asarray(js.add_noise(jnp.asarray(x), jnp.asarray(n),
                                jnp.asarray(t))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        ts.step(torch.from_numpy(n), torch.from_numpy(t), torch.from_numpy(x),
                r_timestep=torch.from_numpy(r)).prev_sample.numpy(),
        np.asarray(js.step(jnp.asarray(n), jnp.asarray(t), jnp.asarray(x),
                           r_timestep=jnp.asarray(r)).prev_sample),
        rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="r_timestep"):
        ts.step(torch.from_numpy(n), torch.from_numpy(t), torch.from_numpy(x))
    for kind in ("uniform", "gaussian", "beta08"):
        for tt in (t, t / 1000.0):
            np.testing.assert_allclose(
                ts.get_train_weight(torch.from_numpy(tt),
                                    weight_type=kind).numpy(),
                np.asarray(js.get_train_weight(jnp.asarray(tt),
                                               weight_type=kind)),
                rtol=1e-6, atol=1e-7, err_msg=kind)
    with pytest.raises(ValueError, match="weight_type"):
        ts.get_train_weight(torch.from_numpy(t), weight_type="x")


# -- anyflow_pretrain ---------------------------------------------------------


def _jax_pretrain_draws(key, shape):
    """JAX's draws of the pretrain loss from its key: (t, r) uniforms, then
    the noise."""
    t_key, noise_key = jax.random.split(key)
    u = jax.random.uniform(t_key, (2, shape[0]))
    noise = jax.random.normal(noise_key, shape, jnp.float32)
    return torch.from_numpy(np.array(u)), torch.from_numpy(np.array(noise))


def _pretrain_pipe(model):
    return tpre.AnyFlowPretrainPipeline(
        model, tfm.FlowMapEulerDiscreteScheduler(shift=3.0),
        TrainingArgs(device="cpu", learning_rate=LR, seed=0, output_dir="",
                     VSA_sparsity=SPARSITY, selective_checkpointing="full"))


def _recorded_times(model, monkeypatch) -> list:
    """(timestep, r_timestep) of each forward of ``model``."""
    seen = []
    forward = model.forward

    def record(*a, **k):
        seen.append((a[2].clone(), k["r_timestep"].clone()))
        return forward(*a, **k)

    monkeypatch.setattr(model, "forward", record)
    return seen


def _check_times(seen, u, shift, n_diff, n_cons):
    """t = shift(max) T for every sample; r = t on the first n_diff, 0 on
    the next n_cons, shift(min) T on the rest; the two finite-difference
    forwards at t +- 5 with the same r."""
    (t, r), (t_plus, r_plus), (t_minus, r_minus) = seen
    torch.testing.assert_close(t_plus, t + 5.0)
    torch.testing.assert_close(t_minus, t - 5.0)
    assert torch.equal(r_plus, r) and torch.equal(r_minus, r)
    torch.testing.assert_close(t, shift(torch.maximum(u[0], u[1])) * 1000)
    free = shift(torch.minimum(u[0], u[1])) * 1000
    assert torch.equal(r[:n_diff], t[:n_diff])
    assert not r[n_diff:n_diff + n_cons].any()
    torch.testing.assert_close(r[n_diff + n_cons:], free[n_diff + n_cons:])


def test_pretrain_loss_and_grads_match_jax(monkeypatch):
    """The loss of a batch of 4 given JAX's draws, VSA at sparsity 0.5 on
    both sides (bf16 DiT passes rounded at different places): within 1e-2
    relative, the gradients by the DMD2 test's rule (3e-2 relative L2 over
    the model, 1e-1 a tensor). The first 2 samples take r = t (diffusion),
    the third r = 0 (consistency), the fourth its draw (free)."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    par.destroy_mesh()
    jmodel = _jax_model(**R_ARCH)
    model = _torch_model(jmodel, **R_ARCH)
    jargs = JTrainingArgs(num_gpus=1, dp_size=1, learning_rate=LR,
                          seed=0, output_dir="", VSA_sparsity=SPARSITY)
    jpipe = jpre.AnyFlowPretrainPipeline(
        jmodel, jfm.FlowMapEulerDiscreteScheduler(shift=3.0), jargs)
    tpipe = _pretrain_pipe(model)
    rng = np.random.default_rng(4)
    shape = (4,) + LATENT[1:]
    latents = rng.standard_normal(shape).astype(np.float32)
    embeds = rng.standard_normal((4,) + EMBEDS[1:]).astype(np.float32)
    key = jax.random.PRNGKey(3)
    with set_forward_context(attn_metadata=AttentionMetadata(
            extra={"VSA_sparsity": SPARSITY})):
        jloss, jgrads = jax.value_and_grad(jpipe._make_loss_fn())(
            jpipe.state.params, None, jnp.asarray(latents),
            jnp.asarray(embeds), key)
    jgrads = state_dict_from_jax(jax.tree.map(np.asarray,
                                              jgrads.to_pure_dict()))
    u, noise = _jax_pretrain_draws(key, shape)
    seen = _recorded_times(model, monkeypatch)
    with tpipe._context(SPARSITY):
        loss = tpipe.loss(torch.from_numpy(latents), torch.from_numpy(embeds),
                          u, noise)
        loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-2)
    _assert_grads_close({n: p.grad for n, p in model.named_parameters()},
                        jgrads)
    _check_times(seen, u, tpipe.scheduler.apply_shift, 2, 1)
    par.destroy_mesh()


def test_pretrain_batch_one_is_free(monkeypatch):
    """At batch 1, int(0.5) = int(0.25) = 0: the sample keeps its drawn r
    (JAX's index split); with no diffusion sample the rescale takes the
    batch mean, so the loss is the weighted per-sample loss times
    ps / (ps + 1e-5)."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    model = _torch_model(**R_ARCH)
    tpipe = _pretrain_pipe(model)
    seen = _recorded_times(model, monkeypatch)
    lat, emb = (torch.randn(LATENT), torch.randn(EMBEDS))
    u, noise = tpipe.draw(LATENT)
    assert u.shape == (2, 1) and noise.shape == LATENT
    with tpipe._context(SPARSITY), torch.no_grad():
        loss = tpipe.loss(lat, emb, u, noise)
    assert torch.isfinite(loss)
    _check_times(seen, u, tpipe.scheduler.apply_shift, 0, 0)


def test_pretrain_checks_its_arguments():
    model = _torch_model(**R_ARCH)
    sched = tfm.FlowMapEulerDiscreteScheduler()
    args = TrainingArgs(device="cpu", output_dir="")
    for kw, msg in ((dict(diffusion_ratio=-0.1), "non-negative"),
                    (dict(diffusion_ratio=0.8, consistency_ratio=0.3),
                     "<= 1"),
                    (dict(fd_epsilon=0.0), "positive"),
                    (dict(weight_type="x"), "weight_type")):
        with pytest.raises(ValueError, match=msg):
            tpre.AnyFlowPretrainPipeline(model, sched, args, **kw)
    with pytest.raises(ValueError, match="r_embedder=True"):
        tpre.AnyFlowPretrainPipeline(_torch_model(), sched, args)


# -- through the entry point --------------------------------------------------


def _checkpoint(root, extra):
    tdir = root / "transformer"
    tdir.mkdir(parents=True)
    (tdir / "config.json").write_text(json.dumps(
        dict(ARCH, _class_name="WanTransformer3DModel")))
    save_file(_torch_model(**extra).state_dict(),
              str(tdir / "model.safetensors"))
    return str(root)


@pytest.mark.parametrize("method", ["anyflow_pretrain", "anyflow"])
def test_build_from_config_and_copy_rule(method, tmp_path, monkeypatch):
    """Both methods through ``build_from_config`` on a Parquet
    ``data.path``: on a checkpoint without delta weights every role's
    ``delta_embedder`` starts equal to its ``time_embedder`` (copies, not
    shared tensors); on one with them, they are loaded. One step moves the
    trained roles."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    rng = np.random.default_rng(2)
    data = str(tmp_path / "data")
    write_parquet_dataset([record_from_sample(
        f"s{i}", rng.standard_normal(LATENT[1:]).astype(np.float32),
        rng.standard_normal(EMBEDS[1:]).astype(np.float32))
        for i in range(2)], data)
    for name, extra in (("plain", {}), ("delta", R_ARCH)):
        ckpt = _checkpoint(tmp_path / name / "Wan2.1-T2V-tiny-Diffusers",
                           extra)
        cfg_path = tmp_path / name / "cfg.json"
        cfg_path.write_text(json.dumps({
            "method": method,
            "model": {"pretrained_model_path": ckpt,
                      "dit_precision": "fp32", "flow_shift": 3.0},
            "data": {"path": data, "batch_size": 1},
            "dmd": {"dmd_denoising_steps": [1000, 500],
                    "dfake_gen_update_ratio": 1},
            "method_config": {"r_embedder_fusion": "gated"},
            "training": {"device": "cpu", "learning_rate": 1e-3, "seed": 0,
                         "selective_checkpointing": "full",
                         "max_train_steps": 1, "output_dir": ""},
        }))
        m, loader = build_from_config(load_train_config(str(cfg_path)))
        assert isinstance(m, resolve_method(method)) and method not in \
            NOT_PORTED
        pipe = m.pipeline
        roles = ([pipe.transformer] if method == "anyflow_pretrain" else
                 [pipe.generator, pipe.real_score, pipe.fake_score])
        for model in roles:
            ce = model.condition_embedder
            assert ce.r_fusion == "gated"
            # copied or loaded, the branch trains with the rest of its role
            assert [p.requires_grad for p in ce.delta_embedder.parameters()
                    ] == [p.requires_grad for p in
                          ce.time_embedder.parameters()]
            for (n, d), (_, t) in zip(
                    ce.delta_embedder.state_dict().items(),
                    ce.time_embedder.state_dict().items()):
                assert d.device.type == "cpu"
                assert torch.equal(d, t) == (name == "plain"), n
                assert d.data_ptr() != t.data_ptr()
        before = {n: p.detach().clone()
                  for n, p in roles[0].named_parameters()}
        try:
            m.train(loader)
        finally:
            loader.shutdown()
        assert pipe.step == 1
        assert not all(torch.equal(before[n], p)
                       for n, p in roles[0].named_parameters())
