"""The port's self-forcing distillation against the JAX
``SelfForcingDistillationPipeline`` on a 1-layer causal Wan with narrow
widths (2 blocks of 2 latent frames, a 4-frame window: the cached
attention's dense branch, as at JAX's own test's shapes): two steps given
JAX's draws, the first with a generator update through block 0 and the
second without (losses, grad norms, the first updates' gradients, every
parameter of the generator and the fake score, the teacher untouched),
then the grad block's advance; the rollout's bf16 caches against fp32
ones; and ``self_forcing`` through ``build_from_config`` on a Parquet
``data.path``."""

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
from fastvideo_tpu.models.dits.causal_wan import (
    CausalWanTransformer3DModel as JCausalWan)
from fastvideo_tpu.training import distillation_pipeline as jdp
from fastvideo_tpu.training import self_forcing_pipeline as jsf
from fastvideo_tpu_torch.dataset.parquet import (record_from_sample,
                                                 write_parquet_dataset)
from fastvideo_tpu_torch.entrypoints.cli.train import build_from_config
from fastvideo_tpu_torch.fastvideo_args import TrainingArgs
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.loader.safetensors_io import save_file
from fastvideo_tpu_torch.models.registry import resolve_model_cls
from fastvideo_tpu_torch.training import distillation_pipeline as tdp
from fastvideo_tpu_torch.training import self_forcing_pipeline as tsf
from fastvideo_tpu_torch.training.methods import NOT_PORTED, resolve_method
from fastvideo_tpu_torch.training.methods.distribution_matching import (
    SelfForcingMethod)
from fastvideo_tpu_torch.training.run_config import load_train_config

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_dmd2 import (_assert_grads_close, _loss_fn,  # noqa: E402
                             _params)
from test_torch_training import _assert_adamw_params_close  # noqa: E402
from test_torch_wan_dit import jax_params, numpy_model  # noqa: E402
from utils import TINY_DIT  # noqa: E402

torch.set_num_threads(2)

CAUSAL = dict(num_frames_per_block=2, local_attn_size=4, sink_size=0)
ARCH = dict(TINY_DIT, num_layers=1, **CAUSAL)
# [B, C, T, H, W]: 2 blocks of 2 latent frames of (4, 4) tokens
LATENT = (1, 4, 4, 8, 8)
EMBEDS = (1, 6, ARCH["text_dim"])
LR = 1e-3
RATIO = 2
STEPS = (1000, 500)


def causal_arch():
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in ARCH.items()}


def jax_models(seeds=(0, 1, 2)):
    """Causal Wans of the JAX package, each its own weights."""
    return [numpy_model(lambda: JCausalWan(
        WanArchConfig(**causal_arch()), param_dtype=jnp.float32,
        rngs=nnx.Rngs(0)), seed=s) for s in seeds]


def torch_model(jmodel):
    cls, arch_cls = resolve_model_cls("CausalWanTransformer3DModel")
    model = cls(arch_cls(**causal_arch()), dtype=torch.float32)
    model.load_state_dict(state_dict_from_jax(jax_params(jmodel)),
                          strict=True)
    return model


def jax_args():
    return JTrainingArgs(num_gpus=1, dp_size=1, learning_rate=LR,
                         max_grad_norm=1.0, seed=0, output_dir="")


def torch_args(**kw):
    return TrainingArgs(device="cpu", learning_rate=LR, max_grad_norm=1.0,
                        seed=0, output_dir="", selective_checkpointing="full",
                        **kw)


def normal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape,
                                                       jnp.float32)))


def jax_rollout_draws(k_roll, shape, steps):
    """The rollout's fresh noises from its key: split per block, then per
    denoise step (every step but the last)."""
    nfpb = CAUSAL["num_frames_per_block"]
    blocks = shape[2] // nfpb
    block_shape = tuple(shape[:2]) + (nfpb,) + tuple(shape[3:])
    out = []
    for bkey in jax.random.split(k_roll, blocks):
        skeys = jax.random.split(bkey, len(steps))
        out.append([normal(skeys[i], block_shape)
                    for i in range(len(steps) - 1)])
    return out


def jax_update_draws(key, shape, steps):
    """An update's draws from the key its step function splits: (rollout,
    timestep, noise)."""
    k_roll, k_t, k_n = jax.random.split(key, 3)
    t_int = int(jax.random.randint(k_t, (1,), 0, 1000)[0])
    return tdp.UpdateDraws(jax_rollout_draws(k_roll, shape, steps), t_int,
                           normal(k_n, shape))


def jax_step_draws(rng, gen_update: bool, shape, steps):
    """JAX's draws of one self-forcing train_one_step: the step's noise,
    then each update's key; also the keys, by role."""
    rng, k = jax.random.split(rng)
    out = {"noise": normal(k, shape)}
    keys = {"noise": jax.random.normal(k, shape, jnp.float32)}
    for role in (["generator"] if gen_update else []) + ["critic"]:
        rng, key = jax.random.split(rng)
        keys[role] = key
        out[role] = jax_update_draws(key, shape, steps)
    return rng, out, keys


def assert_params_close(got: dict, want: dict, start: dict, updates: int,
                        lr: float = LR) -> None:
    """The parameters after ``updates`` AdamW steps from the same start:
    each element within 2 lr an update (the first update moves by +-lr,
    the gradient's sign), and the moves within 0.15 relative L2 over the
    model (as the DMD2 test holds them)."""
    num = den = 0.0
    for name, w in want.items():
        g = got[name].detach().float()
        diff = (g - w).abs().max().item()
        assert diff <= 2 * lr * updates + 1e-6, (name, diff)
        num += ((g - w) ** 2).sum().item()
        den += ((w - start[name]) ** 2).sum().item()
    assert den > 0 and (num / den) ** 0.5 < 0.15, (num / den) ** 0.5


def capture_first_grads(monkeypatch, pipe, module=tdp) -> dict:
    """The gradients each role's first update hands to clipping."""
    raw: dict = {}
    clip = module.clip_grad_norm

    def keep(params, max_norm):
        role = "generator" if params is pipe.gen_params else "critic"
        raw.setdefault(role, [p.grad.detach().clone() for p in params])
        return clip(params, max_norm)

    monkeypatch.setattr(module, "clip_grad_norm", keep)
    return raw


def test_two_steps_match_jax(monkeypatch):
    """Step 0 updates the generator through block 0's last pass and the
    critic; step 1 the critic only (ratio 2). Given JAX's draws: each
    step's losses within 1e-2 relative and grad norms within 2e-2; step
    0's generator and critic gradients against JAX's
    (``_assert_grads_close``) and the parameters after them by the SFT
    test's AdamW rule; every parameter after each step within the DMD2
    test's bars; the teacher bit for bit. A third step (the port's own
    draws) updates the generator through block 1."""
    par.destroy_mesh()
    jgen, jreal, jfake = jax_models()
    tgen, treal, tfake = (torch_model(m) for m in (jgen, jreal, jfake))
    starts = [{k: v.clone() for k, v in m.state_dict().items()}
              for m in (tgen, treal, tfake)]
    cfg = dict(dfake_gen_update_ratio=RATIO)
    jpipe = jsf.SelfForcingDistillationPipeline(
        jgen, jreal, jfake, jax_args(), jdp.DMDConfig(**cfg),
        denoise_steps=STEPS)
    tpipe = tsf.SelfForcingDistillationPipeline(
        tgen, treal, tfake, torch_args(), tdp.DMDConfig(**cfg),
        denoise_steps=STEPS)
    assert tgen.gradient_checkpointing and tfake.gradient_checkpointing
    raw = capture_first_grads(monkeypatch, tpipe)
    names = {role: [n for n, p in m.named_parameters() if p.requires_grad]
             for role, m in (("generator", tgen), ("critic", tfake))}
    rng = np.random.default_rng(5)
    embeds = rng.standard_normal(EMBEDS).astype(np.float32)
    neg = np.zeros_like(embeds)
    key = jpipe.rng
    for step in range(2):
        gen_update = step % RATIO == 0
        key, draws, keys = jax_step_draws(key, gen_update, LATENT, STEPS)
        monkeypatch.setattr(tpipe, "draw", lambda shape, g, d=draws: d)
        gen0, fake0 = jpipe.gen_params, jpipe.fake_params
        jout = jpipe.train_one_step(embeds, neg, LATENT)
        tout = tpipe.train_one_step(embeds, neg, LATENT)
        assert set(jout) <= set(tout) and tout["step"] == step + 1
        assert ("generator_loss" in tout) == gen_update
        for name in ("generator_loss", "critic_loss"):
            if name in jout:
                np.testing.assert_allclose(tout[name], jout[name],
                                           rtol=1e-2, err_msg=name)
        if gen_update:
            assert tout["grad_block"] == 0
            np.testing.assert_allclose(tout["generator_grad_norm"],
                                       jout["generator_grad_norm"],
                                       rtol=2e-2)
        if step == 0:
            e, n = jnp.asarray(embeds), jnp.asarray(neg)
            with par.mesh_context(jpipe.mesh):
                _, g_gen = jax.jit(jax.value_and_grad(
                    _loss_fn(jpipe._gen_step)), static_argnums=7)(
                    gen0, fake0, jpipe.real_params, keys["noise"], e, n,
                    keys["generator"], 0)
                _, g_fake = jax.jit(jax.value_and_grad(
                    _loss_fn(jpipe._critic_step)))(
                    fake0, jpipe.gen_params, keys["noise"], e,
                    keys["critic"])
            for role, model, jparams, g in (
                    ("generator", tgen, jpipe.gen_params, g_gen),
                    ("critic", tfake, jpipe.fake_params, g_fake)):
                want = state_dict_from_jax(jax.tree.map(
                    np.asarray, g.to_pure_dict()))
                got = dict(zip(names[role], raw[role]))
                _assert_grads_close(got, want)
                norm = float(torch.cat([x.flatten() for x in raw[role]])
                             .norm())
                _assert_adamw_params_close(model.state_dict(),
                                           _params(jparams), got, want, LR,
                                           clip=min(1.0, 1.0 / norm))
        assert_params_close(dict(tgen.state_dict()), _params(jpipe.gen_params),
                            starts[0], 1)
        assert_params_close(dict(tfake.state_dict()),
                            _params(jpipe.fake_params), starts[2], step + 1)
    assert np.array_equal(np.asarray(key), np.asarray(jpipe.rng))
    for name, t in treal.state_dict().items():
        assert torch.equal(t, starts[1][name]), name
    assert all(p.grad is None and not p.requires_grad
               for p in treal.parameters())
    # the grad block advances: (step // ratio) % blocks
    monkeypatch.undo()
    out = tpipe.train_one_step(embeds, neg, LATENT)
    assert out["grad_block"] == 1 and np.isfinite(out["generator_loss"])
    par.destroy_mesh()


def test_bf16_caches_hold_the_fp32_caches_values(monkeypatch):
    """The rollout on bf16 caches equals the rollout on fp32 ones (JAX's)
    bit for bit, with and without the gradient: the keys and values are
    computed in bf16 and attended in bf16 either way."""
    torch.manual_seed(0)
    cls, arch_cls = resolve_model_cls("CausalWanTransformer3DModel")
    models = [cls(arch_cls(**causal_arch()), dtype=torch.float32)
              for _ in range(3)]
    pipe = tsf.SelfForcingDistillationPipeline(
        *models, torch_args(), tdp.DMDConfig(), denoise_steps=STEPS)
    emb = torch.randn(EMBEDS)
    draws = pipe._update_draws(LATENT)
    noise = torch.randn(LATENT)
    outs = {}
    for dtype in (torch.bfloat16, torch.float32):
        pipe.cache_dtype = dtype
        video = pipe._rollout(noise, emb, draws.rollout, grad_block=1)
        grads = torch.autograd.grad(video.square().sum(), pipe.gen_params)
        outs[dtype] = video.detach(), grads
    (v16, g16), (v32, g32) = outs.values()
    assert torch.equal(v16, v32)
    assert all(torch.equal(a, b) for a, b in zip(g16, g32))


@pytest.fixture
def causal_checkpoint(tmp_path):
    """A diffusers-style directory whose ``transformer/`` is the tiny
    causal Wan."""
    tdir = tmp_path / "SelfForcing-tiny" / "transformer"
    tdir.mkdir(parents=True)
    (tdir / "config.json").write_text(json.dumps(
        dict(ARCH, _class_name="CausalWanTransformer3DModel")))
    torch.manual_seed(0)
    cls, arch_cls = resolve_model_cls("CausalWanTransformer3DModel")
    save_file(cls(arch_cls(**causal_arch())).state_dict(),
              str(tdir / "model.safetensors"))
    return str(tdir.parent)


def write_shard(tmp_path, latent=LATENT, embeds=EMBEDS) -> str:
    rng = np.random.default_rng(2)
    data = str(tmp_path / "data")
    write_parquet_dataset([record_from_sample(
        f"s{i}", rng.standard_normal(latent[1:]).astype(np.float32),
        rng.standard_normal(embeds[1:]).astype(np.float32))
        for i in range(2)], data)
    return data


def train_config(tmp_path, method: str, checkpoint: str, data: str,
                 method_config: dict, steps: int = 2) -> str:
    path = tmp_path / f"{method}.json"
    path.write_text(json.dumps({
        "method": method,
        "model": {"pretrained_model_path": checkpoint,
                  "dit_precision": "fp32"},
        "data": {"path": data, "batch_size": 1},
        "dmd": {"dmd_denoising_steps": [1000, 757, 522],
                "dfake_gen_update_ratio": 1},
        "method_config": method_config,
        "training": {"device": "cpu", "learning_rate": 1e-3, "seed": 0,
                     "selective_checkpointing": "full",
                     "max_train_steps": steps, "output_dir": ""},
    }))
    return str(path)


def roles_moved(pipe, before) -> list[bool]:
    return [not any(torch.equal(before[i][n], p)
                    for n, p in m.named_parameters())
            for i, m in enumerate((pipe.generator, pipe.real_score,
                                   pipe.fake_score))]


def test_build_from_config_trains_self_forcing_on_parquet(
        causal_checkpoint, tmp_path, monkeypatch):
    """``method: self_forcing`` with ``method_config.denoise_steps`` on a
    Parquet shard: two steps at ratio 1 move the generator (through
    blocks 0 and 1) and the fake score and leave the teacher."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    cfg = load_train_config(train_config(
        tmp_path, "self_forcing", causal_checkpoint, write_shard(tmp_path),
        {"denoise_steps": [1000, 500]}))
    method, loader = build_from_config(cfg)
    assert isinstance(method, SelfForcingMethod)
    assert "self_forcing" not in NOT_PORTED
    assert resolve_method("self_forcing") is SelfForcingMethod
    pipe = method.pipeline
    assert pipe.denoise_steps == (1000, 500)
    before = [{n: p.detach().clone() for n, p in m.named_parameters()}
              for m in (pipe.generator, pipe.real_score, pipe.fake_score)]
    try:
        method.train(loader)
    finally:
        loader.shutdown()
    assert pipe.step == 2 and pipe.gen_updates == 2
    assert roles_moved(pipe, before) == [True, False, True]
