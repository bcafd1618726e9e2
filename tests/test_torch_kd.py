"""The port's knowledge distillation (``kd``) against the JAX ``KDMethod`` on
a 1-layer Wan with narrow widths and VSA on an exact grid (at sparsity 0:
no forward context, as in JAX): the teacher's rollout and one step given
JAX's draws; a teacher cache written by JAX read by the port and the
reverse; the ``COMPLETE`` sentinel and a resumed cache; ``kd`` through
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
from fastvideo_tpu.training.methods import knowledge_distillation as jkd
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
from fastvideo_tpu_torch.training.methods import NOT_PORTED, resolve_method
from fastvideo_tpu_torch.training.methods import (
    knowledge_distillation as tkd)
from fastvideo_tpu_torch.training.run_config import load_train_config

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_dmd2 import _assert_params_close, _params  # noqa: E402
from test_torch_wan_dit import jax_params, numpy_model  # noqa: E402
from utils import TINY_DIT  # noqa: E402

torch.set_num_threads(2)

ARCH = dict(TINY_DIT, num_layers=1)
# latents [accum, B, C, T, H, W]: token grid (2, 16, 16), 4 exact VSA tiles
LATENTS = (1, 1, 4, 2, 32, 32)
EMBEDS = (1, 1, 12, ARCH["text_dim"])
T_LIST = (999, 937, 833, 624)
LR = 1e-3


def _arch(cls):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in ARCH.items()})


def _jax_model(seed=0):
    return numpy_model(lambda: WanTransformer3DModel(
        _arch(WanArchConfig), param_dtype=jnp.float32, rngs=nnx.Rngs(0)),
        seed=seed)


def _torch_model(jmodel=None):
    torch.manual_seed(0)
    model = TorchWanTransformer3DModel(_arch(TorchWanArchConfig),
                                       dtype=torch.float32)
    if jmodel is not None:
        model.load_state_dict(state_dict_from_jax(jax_params(jmodel)),
                              strict=True)
    return model


def _jargs():
    return JTrainingArgs(num_gpus=1, dp_size=1, learning_rate=LR,
                         max_grad_norm=1.0, seed=0, output_dir="")


def _targs(**kw):
    return TrainingArgs(**dict(dict(
        device="cpu", learning_rate=LR, max_grad_norm=1.0, seed=0,
        output_dir="", selective_checkpointing="full"), **kw))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(LATENTS).astype(np.float32),
            rng.standard_normal(EMBEDS).astype(np.float32))


def _jax_rollout_draws(key, shape):
    """JAX's rollout draws from its key: the fresh noise of each step but
    the last (split(key, len(t_list)))."""
    keys = jax.random.split(key, len(T_LIST))
    return [torch.from_numpy(np.array(jax.random.normal(
        keys[i], shape, jnp.float32))) for i in range(len(T_LIST) - 1)]


def _methods(monkeypatch):
    """JAX's and the port's KDMethod over one student, each teacher a frozen
    copy of another model's weights."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    par.destroy_mesh()
    jstudent, jteacher = _jax_model(0), _jax_model(1)
    _, tparams = nnx.split(jteacher)
    jm = jkd.KDMethod(jstudent, _jargs(), tparams, t_list=T_LIST)
    tm = tkd.KDMethod(_torch_model(jstudent), _targs(),
                      _torch_model(jteacher), t_list=T_LIST)
    return jm, tm


def test_rollout_and_step_match_jax(monkeypatch):
    """The teacher's rollout given JAX's noise and fresh draws: its first
    trajectory entry is the noise bit for bit, the others and the final x0
    within 2e-2 of their largest magnitude (bf16 DiT passes on both
    sides, rounded at different places, through 4 steps). Then one step
    from JAX's trajectory given JAX's step index: the loss within 1e-2
    relative, the grad norm within 2e-2 relative, the gradients by the
    DMD2 test's rule and the parameters after AdamW by the SFT test's."""
    jm, tm = _methods(monkeypatch)
    lat, emb = _batch(3)
    lat, emb = lat[0], emb[0]
    key = jax.random.PRNGKey(5)
    noise = jax.random.normal(jax.random.PRNGKey(6), lat.shape)
    jtraj, jreal = jm._teacher_rollout(jm.teacher_params, noise,
                                       jnp.asarray(emb), key)
    jtraj, jreal = np.array(jtraj), np.array(jreal)
    draws = tkd.RolloutDraws(torch.from_numpy(np.array(noise)),
                             _jax_rollout_draws(key, lat.shape))
    traj, real = tm.teacher_rollout(emb, draws)
    assert traj.shape == jtraj.shape == (len(T_LIST),) + lat.shape
    assert torch.equal(traj[0], draws.noise)
    for i in range(1, len(T_LIST)):
        np.testing.assert_allclose(traj[i].numpy(), jtraj[i],
                                   atol=2e-2 * np.abs(jtraj[i]).max())
    np.testing.assert_allclose(real.numpy(), jreal,
                               atol=2e-2 * np.abs(jreal).max())
    assert not any(p.grad is not None for p in tm.teacher.parameters())

    # one step from JAX's trajectory with JAX's step index
    rng, k = jax.random.split(jm.rng)
    step_i = int(jax.random.randint(k, (), 0, len(T_LIST)))
    start = {n: t.clone() for n, t in tm.student.state_dict().items()}
    monkeypatch.setattr(tm, "draw", lambda *a, **k: step_i)
    jout = jm.train_one_step(jtraj, emb, jreal)
    tout = tm.train_one_step(jtraj, emb, jreal)
    assert tout["kd_step_idx"] == jout["kd_step_idx"] == step_i
    assert tout["step"] == jout["step"] == 1
    np.testing.assert_allclose(tout["kd_loss"], jout["kd_loss"], rtol=1e-2)
    np.testing.assert_allclose(tout["grad_norm"], jout["grad_norm"],
                               rtol=2e-2)
    _assert_params_close(tm.student, _params(jm.params), start, 1)
    assert np.array_equal(np.asarray(rng), np.asarray(jm.rng))
    par.destroy_mesh()


def _loader(n):
    return [_batch(20 + i) for i in range(n)]


def test_caches_cross_read(monkeypatch, tmp_path):
    """A cache JAX writes reads in the port (and trains a step), and one the
    port writes reads in JAX: the same keys, shapes and dtypes, each a
    loader batch's first micro-batch."""
    jm, tm = _methods(monkeypatch)
    jm.teacher_path_cache = str(tmp_path / "jax")
    tm.teacher_path_cache = str(tmp_path / "port")
    jm.generate_cache(_loader(2), max_samples=2)
    tm.generate_cache(_loader(2), max_samples=2)
    for d in (jm.teacher_path_cache, tm.teacher_path_cache):
        assert sorted(os.listdir(d)) == ["00000000.npz", "00000001.npz",
                                         "COMPLETE"]
    want = [dict(np.load(os.path.join(jm.teacher_path_cache, f)))
            for f in ("00000000.npz", "00000001.npz")]
    mine = [dict(np.load(os.path.join(tm.teacher_path_cache, f)))
            for f in ("00000000.npz", "00000001.npz")]
    for w, m in zip(want, mine):
        assert w.keys() == m.keys() == {"trajectory", "real",
                                        "text_embedding", "t_list"}
        for k in w:
            assert w[k].shape == m[k].shape and w[k].dtype == m[k].dtype, k
        np.testing.assert_array_equal(m["t_list"], T_LIST)
    np.testing.assert_array_equal(want[1]["text_embedding"],
                                  _loader(2)[1][1][0])
    # the port reads JAX's cache, JAX the port's
    tm.teacher_path_cache, jm.teacher_path_cache = (jm.teacher_path_cache,
                                                    tm.teacher_path_cache)
    got = list(tm.iter_cache())
    for (traj, emb, real), w in zip(got, want):
        np.testing.assert_array_equal(traj, w["trajectory"])
        np.testing.assert_array_equal(real, w["real"])
        np.testing.assert_array_equal(emb, w["text_embedding"])
    theirs = list(jm._iter_cache())
    for (traj, emb, real), m in zip(theirs, mine):
        np.testing.assert_array_equal(traj, m["trajectory"])
        np.testing.assert_array_equal(real, m["real"])
        np.testing.assert_array_equal(emb, m["text_embedding"])
    assert np.isfinite(tm.train_one_step(*got[0])["kd_loss"])
    par.destroy_mesh()


def test_cache_complete_and_resume(monkeypatch, tmp_path):
    """A cache generation cut after its first sample resumes: the written
    sample is kept as it was, the others are written, then ``COMPLETE``;
    with the sentinel a generation does nothing. A sample's rollout is
    drawn from its index, so the resumed cache equals an uncut one."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")

    def cut(n, at):
        for i, b in enumerate(_loader(n)):
            if i == at:
                raise KeyboardInterrupt
            yield b

    tm = tkd.KDMethod(_torch_model(), _targs(), _torch_model(),
                      t_list=T_LIST, teacher_path_cache=str(tmp_path / "c"))
    with pytest.raises(KeyboardInterrupt):
        tm.generate_cache(cut(3, 1), max_samples=3)
    first = tmp_path / "c" / "00000000.npz"
    assert sorted(os.listdir(tmp_path / "c")) == ["00000000.npz"]
    stamp = first.stat().st_mtime_ns
    tm.generate_cache(_loader(3), max_samples=3)
    assert first.stat().st_mtime_ns == stamp
    assert sorted(os.listdir(tmp_path / "c")) == [
        "00000000.npz", "00000001.npz", "00000002.npz", "COMPLETE"]
    tm.generate_cache(cut(3, 0), max_samples=3)  # complete: reads nothing
    uncut = tkd.KDMethod(_torch_model(), _targs(), _torch_model(),
                         t_list=T_LIST,
                         teacher_path_cache=str(tmp_path / "u"))
    uncut.generate_cache(_loader(3), max_samples=3)
    for a, b in zip(tm.iter_cache(), uncut.iter_cache()):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.fixture
def checkpoint(tmp_path, monkeypatch):
    """A diffusers-style directory with a tiny VSA Wan ``transformer/``."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    root = tmp_path / "Wan2.1-T2V-tiny-Diffusers"
    tdir = root / "transformer"
    tdir.mkdir(parents=True)
    (tdir / "config.json").write_text(json.dumps(
        dict(ARCH, _class_name="WanTransformer3DModel")))
    save_file(_torch_model().state_dict(), str(tdir / "model.safetensors"))
    return str(root)


def _config(checkpoint, data, **method_config):
    return {
        "method": "kd",
        "model": {"pretrained_model_path": checkpoint,
                  "dit_precision": "fp32"},
        "data": {"path": data, "batch_size": 1},
        "method_config": {"t_list": list(T_LIST), **method_config},
        "training": {"device": "cpu", "learning_rate": 1e-3, "seed": 0,
                     "selective_checkpointing": "full",
                     "max_train_steps": 2, "output_dir": ""},
    }


def test_build_from_config_trains_kd(checkpoint, tmp_path):
    """``method: kd`` on a Parquet ``data.path``: the self-distillation
    teacher is a frozen copy of the student's initial weights; two steps on
    the fly move the student and leave the teacher. With a cache, the
    first train writes it; once complete, a new method has no teacher and
    trains from the cache."""
    rng = np.random.default_rng(2)
    data = str(tmp_path / "data")
    write_parquet_dataset([record_from_sample(
        f"s{i}", rng.standard_normal(LATENTS[2:]).astype(np.float32),
        rng.standard_normal(EMBEDS[2:]).astype(np.float32))
        for i in range(3)], data)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(_config(checkpoint, data)))
    method, loader = build_from_config(load_train_config(str(cfg_path)))
    assert isinstance(method, tkd.KDMethod) and "kd" not in NOT_PORTED
    assert resolve_method("kd") is tkd.KDMethod
    assert method.t_list == T_LIST and method.student.gradient_checkpointing
    start = {n: p.detach().clone() for n, p in
             method.student.named_parameters()}
    for n, p in method.teacher.named_parameters():
        assert torch.equal(p, start[n]) and not p.requires_grad
    try:
        method.train(loader)
    finally:
        loader.shutdown()
    assert method.step == 2
    assert not all(torch.equal(start[n], p)
                   for n, p in method.student.named_parameters())
    for n, p in method.teacher.named_parameters():
        assert torch.equal(p, start[n]), n

    cache = str(tmp_path / "cache")
    cfg_path.write_text(json.dumps(_config(checkpoint, data,
                                           teacher_path_cache=cache)))
    method, loader = build_from_config(load_train_config(str(cfg_path)))
    try:
        method.train(loader)
    finally:
        loader.shutdown()
    assert os.path.exists(os.path.join(cache, "COMPLETE"))
    assert len([f for f in os.listdir(cache) if f.endswith(".npz")]) == 2
    method, loader = build_from_config(load_train_config(str(cfg_path)))
    loader.shutdown()
    assert method.teacher is None
    method.train(None, max_steps=3)
    assert method.step == 3
    with pytest.raises(ValueError, match="no teacher"):
        method.teacher_rollout(np.zeros(EMBEDS[1:], np.float32),
                               method.draw(LATENTS[1:]))
