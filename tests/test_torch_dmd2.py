"""The port's DMD2 distillation against the JAX ``DMD2DistillationPipeline``
on a 1-layer Wan with narrow widths and VSA on an exact grid (at sparsity
0: no forward context, as in JAX): 3 alternating steps given JAX's draws
(losses, grad norms, the first generator and critic updates' gradients,
every parameter of the generator, the fake score and the EMA), the
teacher untouched, ``shift_timestep``, and ``dmd2`` through
``build_from_config`` on a Parquet ``data.path``."""

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
from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu.fastvideo_args import TrainingArgs as JTrainingArgs
from fastvideo_tpu.models.dits.wan import WanTransformer3DModel
from fastvideo_tpu.training import distillation_pipeline as jdp
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
from fastvideo_tpu_torch.training import distillation_pipeline as tdp
from fastvideo_tpu_torch.training.methods import NOT_PORTED, resolve_method
from fastvideo_tpu_torch.training.methods.distribution_matching import (
    DMD2Method)
from fastvideo_tpu_torch.training.run_config import load_train_config

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_training import _assert_adamw_params_close  # noqa: E402
from test_torch_wan_dit import jax_params, numpy_model  # noqa: E402
from utils import TINY_DIT  # noqa: E402

torch.set_num_threads(2)

ARCH = dict(TINY_DIT, num_layers=1)
# the noise [B, C, T, H, W]: token grid (2, 16, 16), 4 exact VSA tiles of
# (2, 8, 8); 12 text tokens
LATENT = (1, 4, 2, 32, 32)
EMBEDS = (1, 12, ARCH["text_dim"])
LR = 1e-3
STEPS = 3
RATIO = 2
EMA = 0.9


def _arch(cls):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in ARCH.items()})


def _jax_models():
    """Generator, real score and fake score, each its own weights."""
    return [numpy_model(lambda: WanTransformer3DModel(
        _arch(WanArchConfig), param_dtype=jnp.float32, rngs=nnx.Rngs(0)),
        seed=s) for s in (0, 1, 2)]


def _torch_model(jmodel):
    model = TorchWanTransformer3DModel(_arch(TorchWanArchConfig),
                                       dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(jax_params(jmodel)),
                          strict=True)
    return model


def _dmd_config():
    return dict(dfake_gen_update_ratio=RATIO, ema_decay=EMA)


def _jax_step_draws(rng, gen_update: bool, steps):
    """JAX's draws of one train_one_step, from its key: the step's noise,
    then for each update the key split in the update's step function
    (rollout, timestep, noise; the rollout key split once a step). Also
    JAX's own noise and each update's key, by role."""
    shape = LATENT
    rng, k = jax.random.split(rng)
    jnoise = jax.random.normal(k, shape, jnp.float32)
    out = {"noise": torch.from_numpy(np.array(jnoise))}
    role_keys = {"noise": jnoise}
    for role in (["generator"] if gen_update else []) + ["critic"]:
        rng, key = jax.random.split(rng)
        role_keys[role] = key
        k_roll, k_t, k_noise = jax.random.split(key, 3)
        keys = jax.random.split(k_roll, len(steps))
        rollout = [torch.from_numpy(np.array(
            jax.random.normal(keys[i], shape, jnp.float32)))
            for i in range(len(steps) - 1)]
        t_int = int(jax.random.randint(k_t, (1,), 0, 1000)[0])
        noise = torch.from_numpy(np.array(
            jax.random.normal(k_noise, shape, jnp.float32)))
        out[role] = tdp.UpdateDraws(rollout, t_int, noise)
    return rng, out, role_keys


def _loss_fn(jitted_step):
    """The ``loss_fn`` that a JAX update's jitted step differentiates."""
    step = jitted_step.__wrapped__
    cells = dict(zip(step.__code__.co_freevars, step.__closure__))
    return cells["loss_fn"].cell_contents


def _jax_first_grads(jpipe, gen0, fake0, embeds, neg, keys):
    """JAX's gradients of step 0's generator update (from the starting
    generator and fake score) and critic update (the starting fake score
    on the updated generator), with the keys of that step, by state_dict
    name."""
    e, n = jnp.asarray(embeds), jnp.asarray(neg)
    with par.mesh_context(jpipe.mesh):
        _, g_gen = jax.jit(jax.value_and_grad(_loss_fn(jpipe._gen_step)))(
            gen0, fake0, jpipe.real_params, keys["noise"], e, n,
            keys["generator"])
        _, g_fake = jax.jit(jax.value_and_grad(
            _loss_fn(jpipe._critic_step)))(
            fake0, jpipe.gen_params, keys["noise"], e, keys["critic"])
    return {role: state_dict_from_jax(jax.tree.map(np.asarray,
                                                   g.to_pure_dict()))
            for role, g in (("generator", g_gen), ("critic", g_fake))}


def _assert_grads_close(got, want):
    """The SFT test's bars: 3e-2 relative L2 over the model, 1e-1 of each
    tensor's norm (plus 1e-6 for tensors whose exact gradient is 0)."""
    flat_t = torch.cat([got[n].flatten() for n in want])
    flat_j = torch.cat([want[n].flatten() for n in want])
    assert (flat_t - flat_j).norm() / flat_j.norm() < 3e-2
    for n, g in want.items():
        assert (got[n] - g).norm() <= 1e-1 * g.norm() + 1e-6, n


def _params(params) -> dict[str, torch.Tensor]:
    return state_dict_from_jax(jax.tree.map(np.asarray,
                                            params.to_pure_dict()))


def _assert_params_close(model_or_list, want, start, updates, names=None):
    """The port's parameters against JAX's after ``updates`` AdamW steps
    from the same ``start``. Each AdamW update moves an element by at most
    lr (the first by +-lr, its gradient's sign), and where the two sides'
    bf16 gradients differ in sign the parameters may differ by 2 lr an
    update: every element within that. Over the whole model the moves
    (parameter less its start) agree within 0.15 relative L2: the
    elements whose bf16 gradients sit at the noise level, where the
    first update takes either sign, leave 0.03-0.09 of it over these 3
    steps."""
    got = (dict(model_or_list.state_dict()) if names is None else
           dict(zip(names, model_or_list)))
    num = den = 0.0
    for name, w in want.items():
        g = got[name].detach().float()
        diff = (g - w).abs().max().item()
        assert diff <= 2 * LR * updates + 1e-6, (name, diff)
        num += ((g - w) ** 2).sum().item()
        den += ((w - start[name]) ** 2).sum().item()
    assert den > 0 and (num / den) ** 0.5 < 0.15, (num / den) ** 0.5


def test_three_steps_match_jax(monkeypatch):
    """3 steps at dfake_gen_update_ratio 2 (generator updates at steps 0
    and 2, a critic update every step) given JAX's draws, at the SFT
    test's bars (bf16 compute on both sides, rounded at different places):
    each step's losses within 1e-2 relative and grad norms within 2e-2
    relative; step 0's generator and critic gradients (before clipping)
    against JAX's by ``_assert_grads_close``, and the parameters after
    those first updates by the SFT test's AdamW rule (within 2e-6 where
    the two gradients agree in sign and are at least 1e-5); the
    generator's, the fake score's and the EMA's parameters after every
    step by ``_assert_params_close``; the teacher bit for bit and without
    gradients."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    par.destroy_mesh()
    jgen, jreal, jfake = _jax_models()
    tgen, treal, tfake = (_torch_model(m) for m in (jgen, jreal, jfake))
    starts = [{k: v.clone() for k, v in m.state_dict().items()}
              for m in (tgen, treal, tfake)]
    jargs = JTrainingArgs(num_gpus=1, dp_size=1, learning_rate=LR,
                          max_grad_norm=1.0, seed=0, output_dir="")
    jpipe = jdp.DMD2DistillationPipeline(jgen, jreal, jfake, jargs,
                                         jdp.DMDConfig(**_dmd_config()))
    targs = TrainingArgs(device="cpu", learning_rate=LR, max_grad_norm=1.0,
                         seed=0, output_dir="",
                         selective_checkpointing="full")
    tpipe = tdp.DMD2DistillationPipeline(tgen, treal, tfake, targs,
                                         tdp.DMDConfig(**_dmd_config()))
    assert tgen.gradient_checkpointing and tfake.gradient_checkpointing
    raw: dict[str, list] = {}
    clip = tdp.clip_grad_norm

    def keep_first_grads(params, max_norm):
        role = "generator" if params is tpipe.gen_params else "critic"
        raw.setdefault(role, [p.grad.detach().clone() for p in params])
        return clip(params, max_norm)

    monkeypatch.setattr(tdp, "clip_grad_norm", keep_first_grads)
    names = {role: [n for n, p in m.named_parameters() if p.requires_grad]
             for role, m in (("generator", tgen), ("critic", tfake))}
    rng = np.random.default_rng(5)
    embeds = rng.standard_normal(EMBEDS).astype(np.float32)
    neg = np.zeros_like(embeds)
    steps = jpipe.dmd.dmd_denoising_steps
    key = jpipe.rng
    gen_updates = 0
    for step in range(STEPS):
        gen_update = step % RATIO == 0
        key, draws, keys = _jax_step_draws(key, gen_update, steps)
        monkeypatch.setattr(tpipe, "draw", lambda shape, g, d=draws: d)
        gen0, fake0 = jpipe.gen_params, jpipe.fake_params
        jout = jpipe.train_one_step(embeds, neg, LATENT)
        tout = tpipe.train_one_step(embeds, neg, LATENT)
        assert tout.keys() == jout.keys() and tout["step"] == step + 1
        for name in ("generator_loss", "critic_loss"):
            if name in jout:
                np.testing.assert_allclose(tout[name], jout[name],
                                           rtol=1e-2, err_msg=name)
        for name in ("generator_grad_norm", "critic_grad_norm"):
            if name in jout:
                np.testing.assert_allclose(tout[name], jout[name],
                                           rtol=2e-2, err_msg=name)
        gen_updates += gen_update
        if step == 0:
            jgrads = _jax_first_grads(jpipe, gen0, fake0, embeds, neg, keys)
            for role, model, params in (
                    ("generator", tgen, jpipe.gen_params),
                    ("critic", tfake, jpipe.fake_params)):
                tgrads = dict(zip(names[role], raw[role]))
                _assert_grads_close(tgrads, jgrads[role])
                _assert_adamw_params_close(
                    model.state_dict(), _params(params), tgrads,
                    jgrads[role], LR,
                    clip=min(1.0, 1.0 / jout[f"{role}_grad_norm"]))
        _assert_params_close(tgen, _params(jpipe.gen_params), starts[0],
                             gen_updates)
        _assert_params_close(tfake, _params(jpipe.fake_params), starts[2],
                             step + 1)
        _assert_params_close(tpipe.ema_params, _params(jpipe.ema_params),
                             starts[0], gen_updates,
                             names=names["generator"])
    # the reconstruction of JAX's key chain ends where JAX's does
    assert np.array_equal(np.asarray(key), np.asarray(jpipe.rng))
    assert tpipe.gen_updates == 2 and tpipe.fake_updates == STEPS
    for name, t in treal.state_dict().items():
        assert torch.equal(t, starts[1][name]), name
    assert all(p.grad is None and not p.requires_grad
               for p in treal.parameters())
    par.destroy_mesh()


def test_ema_tracks_the_generator(monkeypatch):
    """After each generator update, ema = d ema + (1 - d) params, from the
    generator's start; steps without a generator update leave it."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    torch.manual_seed(0)
    models = [TorchWanTransformer3DModel(_arch(TorchWanArchConfig),
                                         dtype=torch.float32)
              for _ in range(3)]
    pipe = tdp.DMD2DistillationPipeline(
        *models, TrainingArgs(device="cpu", learning_rate=LR, seed=1,
                              output_dir=""),
        tdp.DMDConfig(dfake_gen_update_ratio=2, ema_decay=0.5,
                      dmd_denoising_steps=(1000, 500)))
    want = [p.detach().clone() for p in pipe.gen_params]
    emb = np.random.default_rng(0).standard_normal(EMBEDS).astype(np.float32)
    for step in range(3):
        pipe.train_one_step(emb, np.zeros_like(emb), LATENT)
        if step % 2 == 0:
            want = [0.5 * e + 0.5 * p.detach()
                    for e, p in zip(want, pipe.gen_params)]
        for e, w in zip(pipe.ema_params, want):
            torch.testing.assert_close(e, w, rtol=0, atol=1e-7)


@pytest.mark.parametrize("shift", [1.0, 3.0, 8.0])
def test_shift_timestep_matches_jax(shift):
    t = np.arange(0, 1000, dtype=np.float32)
    want = np.asarray(jdp.shift_timestep(jnp.asarray(t), shift, 1000))
    got = tdp.shift_timestep(torch.from_numpy(t), shift, 1000).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got.dtype == np.float32


def test_draws_come_from_the_seeded_generator(monkeypatch):
    """Two pipelines of one seed draw the same numbers; a step without a
    generator update draws no generator numbers."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    torch.manual_seed(0)
    pipes = [tdp.DMD2DistillationPipeline(
        *[TorchWanTransformer3DModel(_arch(TorchWanArchConfig),
                                     dtype=torch.float32) for _ in range(3)],
        TrainingArgs(device="cpu", seed=3, output_dir=""))
        for _ in range(2)]
    a, b = (p.draw(LATENT, True) for p in pipes)
    assert torch.equal(a["noise"], b["noise"])
    assert a["generator"].t_int == b["generator"].t_int
    assert 0 <= a["critic"].t_int < 1000
    assert len(a["generator"].rollout) == 2
    assert "generator" not in pipes[0].draw(LATENT, False)


@pytest.fixture
def checkpoint(tmp_path, monkeypatch):
    """A diffusers-style directory with a tiny VSA Wan ``transformer/``."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    root = tmp_path / "Wan2.1-T2V-tiny-Diffusers"
    tdir = root / "transformer"
    tdir.mkdir(parents=True)
    (tdir / "config.json").write_text(json.dumps(
        dict(ARCH, _class_name="WanTransformer3DModel")))
    torch.manual_seed(0)
    model = TorchWanTransformer3DModel(_arch(TorchWanArchConfig))
    save_file(model.state_dict(), str(tdir / "model.safetensors"))
    return str(root)


def test_build_from_config_trains_dmd2_on_parquet(checkpoint, tmp_path):
    """``method: dmd2`` with a Parquet ``data.path`` written by the port:
    two steps on the CPU (both update the generator and the critic at
    ratio 1) move the generator and the fake score and leave the teacher."""
    rng = np.random.default_rng(2)
    data = str(tmp_path / "data")
    write_parquet_dataset([record_from_sample(
        f"s{i}", rng.standard_normal(LATENT[1:]).astype(np.float32),
        rng.standard_normal(EMBEDS[1:]).astype(np.float32))
        for i in range(3)], data)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({
        "method": "dmd2",
        "model": {"pretrained_model_path": checkpoint,
                  "dit_precision": "fp32"},
        "data": {"path": data, "batch_size": 1},
        "dmd": {"dmd_denoising_steps": [1000, 500],
                "dfake_gen_update_ratio": 1},
        "training": {"device": "cpu", "learning_rate": 1e-3, "seed": 0,
                     "selective_checkpointing": "full",
                     "max_train_steps": 2, "output_dir": ""},
    }))
    method, loader = build_from_config(load_train_config(str(cfg_path)))
    assert isinstance(method, DMD2Method) and "dmd2" not in NOT_PORTED
    assert resolve_method("dmd2") is DMD2Method
    pipe = method.pipeline
    assert pipe.dmd.dfake_gen_update_ratio == 1
    before = [{n: p.detach().clone() for n, p in m.named_parameters()}
              for m in (pipe.generator, pipe.real_score, pipe.fake_score)]
    try:
        method.train(loader)
    finally:
        loader.shutdown()
    assert pipe.step == 2 and pipe.gen_updates == 2
    for i, m in enumerate((pipe.generator, pipe.real_score,
                           pipe.fake_score)):
        same = [torch.equal(before[i][n], p)
                for n, p in m.named_parameters()]
        assert all(same) if i == 1 else not any(same), i
    # callbacks are dispatched (the loop is at max_train_steps: start and
    # end only)
    method.train([], callbacks={"grad_clip": {"max_grad_norm": 0.25}})
    assert pipe.args.max_grad_norm == 0.25
