"""The port's DiffusionNFT (``diffusion_nft``) against the JAX package on the
tiny Wan of ``tests/training/test_diffusion_nft.py`` (1 layer, 2 heads of
8): the reward scorer, advantages, ``return_decay`` and ``SamplingConfig``
checks; the sampler in ``ode`` and ``sde_reflow``; one and two outer steps
of ``DiffusionNFTPipeline`` for each ``adv_mode`` given JAX's draws (the
start-noise and sampler splits of ``train_one_step``, the per-timestep
keys of ``loss_fn``); ``diffusion_nft`` through ``build_from_config``; and
the Parquet loader's 2-tuple batches, which raise in ``train`` as in JAX."""

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
from fastvideo_tpu.training import rl as jrl
from fastvideo_tpu_torch.configs.models.dits.wan import (
    WanArchConfig as TorchWanArchConfig)
from fastvideo_tpu_torch.entrypoints.cli.train import build_from_config
from fastvideo_tpu_torch.fastvideo_args import TrainingArgs
from fastvideo_tpu_torch.models.dits.wan import (
    WanTransformer3DModel as TorchWanTransformer3DModel)
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.loader.safetensors_io import save_file
from fastvideo_tpu_torch.training import rl as trl
from fastvideo_tpu_torch.training.methods import NOT_PORTED, resolve_method
from fastvideo_tpu_torch.training.methods.rl import DiffusionNFTMethod
from fastvideo_tpu_torch.training.rl.diffusion_nft import NFTDraws
from fastvideo_tpu_torch.training.run_config import load_train_config

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_jax_reference import jax_plain_attention  # noqa: E402,F401
from test_torch_clip import _write_dual_tower  # noqa: E402
from test_torch_wan_dit import jax_params, numpy_model  # noqa: E402

torch.set_num_threads(2)

# tests/training/test_diffusion_nft.py's tiny Wan and shapes
ARCH = dict(num_attention_heads=2, attention_head_dim=8, in_channels=4,
            out_channels=4, text_dim=16, freq_dim=16, ffn_dim=32,
            num_layers=1)
LATENT = (4, 2, 8, 8)
PROMPTS = ["cat", "dog"]
LR = 1e-3


def _embeds(seed=1):
    return np.random.default_rng(seed).standard_normal((2, 6, 16)).astype(
        np.float32)


def _models(monkeypatch):
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    jmodel = numpy_model(lambda: WanTransformer3DModel(
        WanArchConfig(**ARCH), param_dtype=jnp.float32, rngs=nnx.Rngs(0)),
        seed=0)
    tmodel = TorchWanTransformer3DModel(TorchWanArchConfig(**ARCH),
                                        dtype=torch.float32)
    tmodel.load_state_dict(state_dict_from_jax(jax_params(jmodel)),
                           strict=True)
    return jmodel, tmodel


def _reward(media, prompts):
    """A deterministic reward of the media: the samples' mean over the
    first channel, scaled so that a group's two samples differ by far more
    than the two frameworks' bf16 noise."""
    media = np.asarray(media, np.float32)
    return 50.0 * media[:, 0].reshape(media.shape[0], -1).mean(axis=1)


def test_rewards_advantages_decay_and_sampling_config():
    """The weighted scorer, group advantages, return_decay and
    SamplingConfig against JAX's on the same inputs: equal values and
    equal errors."""
    def s1(media, prompts):
        return np.arange(len(prompts), dtype=np.float32)

    def s2(media, prompts):
        return np.full(len(prompts), 2.0, np.float32)

    media = np.random.default_rng(0).random((4, 3, 2, 4, 4)).astype(
        np.float32)
    prompts = ["x", "x", "y", "y"]
    for pkg in (jrl, trl):
        out = pkg.MultiRewardScorer({"a": 1.0, "b": 0.5},
                                    scorers={"a": s1, "b": s2})(media,
                                                                prompts)
        np.testing.assert_array_equal(out["avg"], [1.0, 2.0, 3.0, 4.0])
        assert set(out) == {"a", "b", "avg"}
        with pytest.raises(ValueError, match="Unsupported reward"):
            pkg.MultiRewardScorer({"missing": 1.0}, scorers={"a": s1})
        with pytest.raises(ValueError, match="media batch size"):
            pkg.MultiRewardScorer({"a": 1.0}, scorers={"a": s1})(
                media[:3], prompts)
        with pytest.raises(ValueError):
            pkg.build_multi_reward_scorer({})
        with pytest.raises(ValueError, match="unknown reward"):
            pkg.build_multi_reward_scorer({"aesthetic": 1.0})
        assert pkg.select_first_frame(media).shape == (4, 3, 4, 4)
        with pytest.raises(ValueError):
            pkg.select_first_frame(media[0, 0])
    rng = np.random.default_rng(1)
    for _ in range(5):
        r = rng.standard_normal(12) * 3
        p = [f"p{i % 4}" for i in rng.permutation(12)]
        np.testing.assert_array_equal(trl.compute_group_advantages(p, r),
                                      jrl.compute_group_advantages(p, r))
    for step in (0, 1, 10, 74, 75, 100, 500, 10_000):
        for decay_type in (0, 1, 2):
            assert trl.return_decay(step, decay_type) == \
                jrl.return_decay(step, decay_type)
    for pkg in (jrl, trl):
        with pytest.raises(ValueError):
            pkg.return_decay(0, 7)
    good = [None, {"num_steps": 3, "trajectory": "SDE_REFLOW",
                   "flow_shift": 3.0},
            {"timesteps": [900, 500], "sigmas": [0.9, 0.5]},
            {"flow_shift": "inherit", "scheduler": "flow_match_euler"}]
    for raw in good:
        assert dataclass_dict(trl.SamplingConfig.from_mapping(raw)) == \
            dataclass_dict(jrl.SamplingConfig.from_mapping(raw))
    bad = [{"bogus": 1}, {"scheduler": "ddim"}, {"trajectory": "sde"},
           {"timesteps": []}, {"sigmas": "0.5"}, {"num_steps": -1},
           {"timesteps": [500.0], "sigmas": [0.5, 0.1]}, [1, 2]]
    for raw in bad:
        with pytest.raises(ValueError) as jerr:
            jrl.SamplingConfig.from_mapping(raw)
        with pytest.raises(ValueError) as terr:
            trl.SamplingConfig.from_mapping(raw)
        assert str(terr.value) == str(jerr.value)
    for kw in ({"adv_mode": "best"}, {"decay_type": 3}):
        with pytest.raises(ValueError):
            trl.DiffusionNFTConfig(**kw)


def dataclass_dict(cfg):
    return {f: getattr(cfg, f) for f in ("num_steps", "scheduler",
                                         "trajectory", "flow_shift",
                                         "timesteps", "sigmas")}


@pytest.mark.parametrize("sampling", [
    {"num_steps": 3, "flow_shift": 3.0},
    {"num_steps": 3, "trajectory": "sde_reflow"},
    {"timesteps": [999.0, 600.0, 250.0]},
], ids=["ode_shift", "sde_reflow", "timesteps"])
def test_sampler_matches_jax(monkeypatch, sampling, jax_plain_attention):
    """The schedule exactly; the sampled latents given JAX's noise and its
    sampler keys' fresh noise within 2e-2 of their largest magnitude (bf16
    DiT passes rounded at other places, three steps)."""
    jmodel, tmodel = _models(monkeypatch)
    cfg_j = jrl.SamplingConfig.from_mapping(sampling)
    cfg_t = trl.SamplingConfig.from_mapping(sampling)
    js, ts = jrl.DiffusionSampler(cfg_j), trl.DiffusionSampler(cfg_t)
    jt, jsig = js.schedule()
    tt, tsig = ts.schedule()
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tsig, jsig)
    shape = (3, *LATENT)
    noise = jax.random.normal(jax.random.PRNGKey(4), shape, jnp.float32)
    emb = np.repeat(_embeds(), [2, 1], axis=0)
    key = jax.random.PRNGKey(5)
    graphdef, params = nnx.split(jmodel)
    want = np.asarray(js.sample(graphdef, params, noise, jnp.asarray(emb),
                                key).latents)
    fresh = [torch.from_numpy(np.asarray(jax.random.normal(k, shape,
                                                           jnp.float32)))
             for k in jax.random.split(key, len(jt))]
    got = ts.sample(tmodel, torch.from_numpy(np.asarray(noise)),
                    torch.from_numpy(emb), fresh)
    assert got.latents.dtype == torch.float32
    np.testing.assert_allclose(got.latents.numpy(), want,
                               atol=2e-2 * np.abs(want).max())
    if cfg_t.trajectory == "sde_reflow":
        with pytest.raises(ValueError, match="fresh"):
            ts.sample(tmodel, torch.from_numpy(np.asarray(noise)),
                      torch.from_numpy(emb))


def _jax_draws(rng, n_samples, n_steps, n_t, stochastic):
    """JAX's draws of one outer step from the pipeline's key: the start
    noise, the sampler's per-step noise and the loss's per-timestep
    noise."""
    shape = (n_samples, *LATENT)

    def normal(k):
        return torch.from_numpy(np.asarray(jax.random.normal(
            k, shape, jnp.float32)))

    rng, k_noise = jax.random.split(rng)
    rng, k_samp = jax.random.split(rng)
    _, key = jax.random.split(rng)
    return NFTDraws(
        noise=normal(k_noise),
        fresh=[normal(k) for k in jax.random.split(k_samp, n_steps)]
        if stochastic else [],
        t_noise=[normal(k) for k in jax.random.split(key, n_t)])


def _state(params):
    return state_dict_from_jax(jax.tree.map(np.asarray,
                                            params.to_pure_dict()))


def _assert_moves_close(got: dict, want: dict, start: dict, updates: int):
    """Parameters after ``updates`` AdamW steps from one start. Each update
    moves an element by at most lr, and where the two sides' bf16
    gradients differ in sign the parameters may differ by 2 lr an update;
    over the model the moves agree within 0.2 relative L2 (the elements
    whose gradients sit at the bf16 noise level take either sign)."""
    num = den = 0.0
    for name, w in want.items():
        g = got[name].detach().float()
        assert (g - w).abs().max().item() <= 2 * LR * updates + 1e-6, name
        num += ((g - w) ** 2).sum().item()
        den += ((w - start[name]) ** 2).sum().item()
    assert den > 0 and (num / den) ** 0.5 < 0.2, (num / den) ** 0.5


@pytest.mark.parametrize("adv_mode", ["all", "positive_only",
                                      "negative_only", "one_only",
                                      "binary"])
def test_two_outer_steps_match_jax(monkeypatch, adv_mode, jax_plain_attention):
    """Two outer steps (2 prompts x 2 videos, 2 sde_reflow sampling steps,
    one trained timestep, EMA 0.5) given JAX's draws: rewards within 2e-2
    of their scale, total / policy losses within 2e-2 relative, KL (0 at
    step 1: student = ref) within 5e-2 relative, grad_norm within 2e-2
    relative; the student by the AdamW moves' rule; old after step 1 the
    student exactly (decay 0), after step 2 0.001 old + 0.999 student;
    the EMA its lerp of the port's own values exactly and JAX's EMA by the
    same rule; ref unchanged bit for bit."""
    par.destroy_mesh()
    jmodel, tmodel = _models(monkeypatch)
    start = {n: p.detach().clone() for n, p in tmodel.state_dict().items()}
    sampling = {"num_steps": 2, "trajectory": "sde_reflow"}
    cfg = dict(num_video_per_prompt=2, decay_type=1, adv_mode=adv_mode,
               ema_decay=0.5)
    scorers = {"fake": _reward}
    jpipe = jrl.DiffusionNFTPipeline(
        jmodel, JTrainingArgs(num_gpus=1, dp_size=1, learning_rate=LR,
                              max_grad_norm=1.0, seed=0),
        jrl.MultiRewardScorer({"fake": 1.0}, scorers=scorers),
        jrl.DiffusionNFTConfig(**cfg),
        jrl.SamplingConfig.from_mapping(sampling))
    tpipe = trl.DiffusionNFTPipeline(
        tmodel, TrainingArgs(device="cpu", learning_rate=LR,
                             max_grad_norm=1.0, seed=0, output_dir=""),
        trl.MultiRewardScorer({"fake": 1.0}, scorers=scorers),
        trl.DiffusionNFTConfig(**cfg),
        trl.SamplingConfig.from_mapping(sampling))
    n_t = tpipe.num_train_timesteps()
    assert n_t == jpipe._num_train_timesteps() == 1
    emb = _embeds()
    old_before = None
    for step in (1, 2):
        draws = _jax_draws(jpipe.rng, 4, 2, n_t, True)
        monkeypatch.setattr(tpipe, "draw", lambda n, shape: draws)
        jm = jpipe.train_one_step(PROMPTS, emb, LATENT)
        tm = tpipe.train_one_step(PROMPTS, emb, LATENT)
        assert tm["step"] == jm["step"] == step
        assert tm["old_decay"] == jm["old_decay"]
        assert set(tm) == set(jm)
        np.testing.assert_allclose(tm["reward/fake"], jm["reward/fake"],
                                   atol=2e-2 * 50)
        for k in ("total_loss", "policy_loss", "grad_norm"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=2e-2, err_msg=k)
        if step == 1:
            assert tm["kl_div_loss"] == jm["kl_div_loss"] == 0.0
        else:
            np.testing.assert_allclose(tm["kl_div_loss"], jm["kl_div_loss"],
                                       rtol=5e-2)
        student = tpipe.student.state_dict()
        _assert_moves_close(student, _state(jpipe.student_params), start,
                            step)
        old = tpipe.old.state_dict()
        if step == 1:
            for n, p in old.items():
                assert torch.equal(p, student[n]), n
        else:
            d = np.float32(0.001)
            keep, take = float(d), float(np.float32(1) - d)
            for n, p in old.items():
                assert torch.equal(p, old_before[n] * keep +
                                   student[n] * take), n
        _assert_moves_close(old, _state(jpipe.old_params), start, step)
        _assert_moves_close(tpipe.ema.state_dict(),
                            _state(jpipe.ema_params), start, step)
        old_before = {n: p.clone() for n, p in old.items()}
    for n, p in tpipe.ref.state_dict().items():
        assert torch.equal(p, start[n]), n
    assert set(tpipe.stage_seconds) == {"sample", "decode", "score",
                                        "update"}
    par.destroy_mesh()


def test_ema_lerp_and_shaped_advantages(monkeypatch):
    """The EMA after a step is 0.5 EMA + 0.5 student of the port's own
    values; ``shape_advantages`` equals JAX's ``_shape_advantages``
    for every mode on the same advantages."""
    par.destroy_mesh()
    jmodel, tmodel = _models(monkeypatch)
    adv = np.array([-7.0, -2.5, -0.1, 0.0, 0.3, 4.9, 6.0], np.float32)
    for mode in ("all", "positive_only", "negative_only", "one_only",
                 "binary"):
        cfg = dict(num_video_per_prompt=2, adv_mode=mode)
        jpipe = jrl.DiffusionNFTPipeline(
            jmodel, JTrainingArgs(num_gpus=1, dp_size=1, seed=0),
            jrl.MultiRewardScorer({"f": 1.0}, scorers={"f": _reward}),
            jrl.DiffusionNFTConfig(**cfg))
        tpipe = trl.DiffusionNFTPipeline(
            tmodel, TrainingArgs(device="cpu", seed=0, output_dir=""),
            trl.MultiRewardScorer({"f": 1.0}, scorers={"f": _reward}),
            trl.DiffusionNFTConfig(**cfg))
        np.testing.assert_array_equal(
            tpipe.shape_advantages(torch.from_numpy(adv)).numpy(),
            np.asarray(jpipe._shape_advantages(jnp.asarray(adv))))
    tpipe = trl.DiffusionNFTPipeline(
        tmodel, TrainingArgs(device="cpu", seed=0, output_dir=""),
        trl.MultiRewardScorer({"f": 1.0}, scorers={"f": _reward}),
        trl.DiffusionNFTConfig(num_video_per_prompt=2, ema_decay=0.5),
        trl.SamplingConfig(num_steps=2))
    ema0 = {n: p.clone() for n, p in tpipe.ema.state_dict().items()}
    tpipe.train_one_step(PROMPTS, _embeds(), LATENT)
    student = tpipe.student.state_dict()
    for n, p in tpipe.ema.state_dict().items():
        assert torch.equal(p, ema0[n] * 0.5 + student[n] * 0.5), n
    par.destroy_mesh()


@pytest.fixture
def checkpoint(tmp_path, monkeypatch):
    """A diffusers-style directory with the tiny Wan ``transformer/``."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    tdir = tmp_path / "Wan2.1-T2V-tiny-Diffusers" / "transformer"
    tdir.mkdir(parents=True)
    (tdir / "config.json").write_text(json.dumps(
        dict(ARCH, _class_name="WanTransformer3DModel")))
    torch.manual_seed(0)
    model = TorchWanTransformer3DModel(TorchWanArchConfig(**ARCH))
    save_file(model.state_dict(), str(tdir / "model.safetensors"))
    return str(tdir.parent)


def test_build_from_config_and_batches(checkpoint, tmp_path, monkeypatch):
    """``method: diffusion_nft`` through ``build_from_config`` with
    ``reward_fn {clipscore, pickscore}`` on a test-written CLIP dual tower:
    the method registered and no longer NOT_PORTED, the config's knobs in
    the pipeline, no decoder attached (as in JAX). Its train takes
    (prompts, embeds, latent_shape) batches: two steps move the student,
    leave ref, and dispatch the callbacks; a Parquet (latents, embeds)
    batch raises as JAX's does."""
    clip = _write_dual_tower(str(tmp_path / "clip"), 32)
    monkeypatch.setenv("FASTVIDEO_CLIPSCORE_WEIGHTS", clip)
    monkeypatch.setenv("FASTVIDEO_PICKSCORE_WEIGHTS", clip)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({
        "method": "diffusion_nft",
        "model": {"pretrained_model_path": checkpoint,
                  "dit_precision": "fp32"},
        "method_config": {"reward_fn": {"clipscore": 1.0, "pickscore": 1.0},
                          "sampling": {"num_steps": 2},
                          "num_video_per_prompt": 2, "beta": 0.2,
                          "adv_mode": "BINARY", "kl_beta": 1e-3},
        "training": {"device": "cpu", "learning_rate": 1e-3, "seed": 0,
                     "max_train_steps": 2, "output_dir": ""},
    }))
    method, loader = build_from_config(load_train_config(str(cfg_path)))
    assert loader is None
    assert isinstance(method, DiffusionNFTMethod)
    assert "diffusion_nft" not in NOT_PORTED
    assert resolve_method("diffusion_nft") is DiffusionNFTMethod
    pipe = method.pipeline
    assert (pipe.cfg.nft_beta, pipe.cfg.adv_mode, pipe.cfg.kl_beta,
            pipe.cfg.num_video_per_prompt) == (0.2, "binary", 1e-3, 2)
    assert sorted(pipe.reward_scorer.scorers) == ["clipscore", "pickscore"]
    assert pipe.student.gradient_checkpointing
    # no decoder: the rewards would score raw latents; hand it frames
    pipe.decode_fn = lambda lat: torch.sigmoid(lat[:, :3]).numpy()
    start = {n: p.clone() for n, p in pipe.student.state_dict().items()}
    seen = []

    from fastvideo_tpu_torch.training.callbacks import Callback

    class Record(Callback):
        def on_training_step_end(self, method, loss_dict, iteration=0):
            seen.append((iteration, loss_dict["reward/avg"]))

    batch = (["a cat", "a dog"], _embeds(), LATENT)
    method.train([batch], callbacks={"rec": {"_target_": Record}})
    assert [i for i, _ in seen] == [1, 2]
    assert all(np.isfinite(r) for _, r in seen)
    assert not all(torch.equal(p, start[n])
                   for n, p in pipe.student.state_dict().items())
    for n, p in pipe.ref.state_dict().items():
        assert torch.equal(p, start[n]), n
    latents = np.zeros((1, 1, *LATENT), np.float32)
    with pytest.raises(ValueError, match="not enough values to unpack"):
        pipe.train([(latents, _embeds()[None, :1])], max_steps=3)
    for name in ("ClipScoreScorer", "DiffusionNFTConfig",
                 "DiffusionNFTPipeline", "DiffusionSampler",
                 "MultiRewardScorer", "PickScoreScorer", "SamplingConfig",
                 "SamplingResult", "build_multi_reward_scorer",
                 "compute_group_advantages", "return_decay",
                 "select_first_frame"):
        assert name in trl.__all__ and name in jrl.__all__


def test_two_tuple_batches_raise_in_jax_too(monkeypatch):
    """JAX's train unpacks (prompts, embeds, latent_shape) too: a
    (latents, embeds) batch raises the same ValueError there."""
    par.destroy_mesh()
    jmodel, _ = _models(monkeypatch)
    jpipe = jrl.DiffusionNFTPipeline(
        jmodel, JTrainingArgs(num_gpus=1, dp_size=1, seed=0),
        jrl.MultiRewardScorer({"f": 1.0}, scorers={"f": _reward}),
        jrl.DiffusionNFTConfig(num_video_per_prompt=2))
    latents = np.zeros((1, 1, *LATENT), np.float32)
    with pytest.raises(ValueError, match="not enough values to unpack"):
        jpipe.train([(latents, _embeds()[None, :1])], max_steps=1)
    par.destroy_mesh()
