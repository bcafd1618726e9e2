"""The port's training callbacks against the JAX package's: the built-ins
and ``_target_`` paths (a ``fastvideo_tpu.`` path resolves in the port);
the EMA shadow over three SFT steps given JAX's draws, against JAX's
EMACallback and against its own recursion exactly; its ``state_dict``
round trip through a checkpoint file and its ``ema_context`` swap; the
grad-clip threshold; and where ``train(callbacks=)`` dispatches the hooks
in the SFT, DMD2, causal_cd and kd loops, hook for hook as the JAX loops
do (kd dispatches none, in both packages)."""

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
from fastvideo_tpu.models.schedulers.flow_match_euler import (
    FlowMatchEulerDiscreteScheduler)
from fastvideo_tpu.training import callbacks as jcb
from fastvideo_tpu.training import distillation_pipeline as jdp
from fastvideo_tpu.training import training_pipeline as jtp
from fastvideo_tpu.training.methods import causal_cd as jcd
from fastvideo_tpu.training.methods import knowledge_distillation as jkd
from fastvideo_tpu_torch.fastvideo_args import TrainingArgs
from fastvideo_tpu_torch.training import callbacks as tcb
from fastvideo_tpu_torch.training import distillation_pipeline as tdp
from fastvideo_tpu_torch.training.instantiate import instantiate
from fastvideo_tpu_torch.training.methods import causal_cd as tcd
from fastvideo_tpu_torch.training.methods import knowledge_distillation as tkd

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_training import (LR, SPARSITY, _batch,  # noqa: E402
                                 _jax_draws, _torch_pipe)
from test_torch_wan_dit import _arch, numpy_model  # noqa: E402

torch.set_num_threads(2)


def test_builtins_and_targets():
    """Built-in names need no ``_target_``; a ``fastvideo_tpu.`` path
    resolves to the port's class, a ``fastvideo_tpu_torch.`` path as it
    is; a config without a target is skipped and a non-Callback target
    raises, as in JAX. ``instantiate`` drops the keys a constructor does
    not take."""
    cfg = {"grad_clip": {"max_grad_norm": 0.5},
           "ema": {"decay": 0.9, "start_iter": 2},
           "validation": {"every_n_steps": 3, "prompt": "a cat"},
           "mine": {"_target_":
                    "fastvideo_tpu.training.callbacks.GradNormClipCallback",
                    "max_grad_norm": 2.0},
           "theirs": {"_target_": "fastvideo_tpu_torch.training.callbacks."
                      "EMACallback", "decay": 0.5},
           "nothing": {}}
    ours = tcb.CallbackDict(cfg)
    jax_cbs = jcb.CallbackDict({k: v for k, v in cfg.items()
                                if k != "theirs"})
    assert [(cb.name, type(cb).__name__) for cb in ours
            if cb.name != "theirs"] == \
        [(cb.name, type(cb).__name__) for cb in jax_cbs]
    assert isinstance(ours["mine"], tcb.GradNormClipCallback)
    assert ours["mine"].max_grad_norm == 2.0 and len(ours) == 5
    assert (ours["ema"].decay, ours["ema"].start_iter) == (0.9, 2)
    assert tcb.normalize_callbacks(None) is None
    assert tcb.normalize_callbacks(ours) is ours
    for bad in ({"x": {"_target_": "fastvideo_tpu_torch.training."
                       "instantiate.resolve_target"}},):
        with pytest.raises(TypeError):
            tcb.CallbackDict(bad)
    with pytest.raises(ImportError):
        tcb.CallbackDict({"x": {"_target_": "fastvideo_tpu.no_such.Thing"}})
    with pytest.raises(ImportError, match="no JAX"):
        tcb.CallbackDict({"x": {"_target_": "jax.numpy.ones"}})
    with pytest.raises(ValueError):
        tcb.CallbackDict({"x": {"_target_": "nodots"}})
    cb = instantiate({"_target_": "fastvideo_tpu.training.callbacks."
                      "EMACallback", "decay": 0.25, "unknown_key": 1})
    assert isinstance(cb, tcb.EMACallback) and cb.decay == 0.25
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcb.ValidationCallback(dataset_path="prompts.csv")


class Recorder(tcb.Callback):
    """Records the hooks and the parameters after each step."""

    def __init__(self):
        self.calls = []
        self.snapshots = []

    def on_train_start(self, method, iteration=0):
        self.calls.append(("start", iteration))

    def on_before_optimizer_step(self, method, iteration=0):
        self.calls.append(("before", iteration))

    def on_training_step_end(self, method, loss_dict, iteration=0):
        self.calls.append(("end", iteration))
        params = getattr(method, "params", None)
        if isinstance(params, list):
            self.snapshots.append([p.detach().clone() for p in params])

    def on_train_end(self, method, iteration=0):
        self.calls.append(("train_end", iteration))


class JRecorder(jcb.Callback):
    def __init__(self):
        self.calls = []

    def on_train_start(self, method, iteration=0):
        self.calls.append(("start", iteration))

    def on_before_optimizer_step(self, method, iteration=0):
        self.calls.append(("before", iteration))

    def on_training_step_end(self, method, loss_dict, iteration=0):
        self.calls.append(("end", iteration))

    def on_train_end(self, method, iteration=0):
        self.calls.append(("train_end", iteration))


def _sft_pair(monkeypatch):
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    par.destroy_mesh()
    jmodel = numpy_model(lambda: WanTransformer3DModel(
        _arch(WanArchConfig), param_dtype=jnp.float32, rngs=nnx.Rngs(0)),
        seed=0)
    tpipe = _torch_pipe(monkeypatch, jmodel=jmodel, max_train_steps=3)
    sched = FlowMatchEulerDiscreteScheduler(shift=3.0)
    sched.set_timesteps(1000)
    jpipe = jtp.TrainingPipeline(jmodel, sched, JTrainingArgs(
        num_gpus=1, dp_size=1, learning_rate=LR, max_grad_norm=1.0,
        weighting_scheme="uniform", seed=0, output_dir="",
        VSA_sparsity=SPARSITY, max_train_steps=3))
    return jpipe, tpipe


def test_ema_over_three_sft_steps_matches_jax(monkeypatch, tmp_path):
    """Three SFT steps through ``train(callbacks={"ema": ..., ...})`` on
    both packages, the port given JAX's draws: the hooks in JAX's order
    (start, then before / end a step, then train end); the port's shadow
    is its own recursion ``s d + p (1 - d)`` from the start parameters bit
    for bit, and JAX's shadow within the SFT test's AdamW bar (2 lr an
    update: the parameters' own gap). The state_dict round-trips through
    a checkpoint file into a new callback; ``ema_context`` swaps the
    shadow in and the live parameters back."""
    jpipe, tpipe = _sft_pair(monkeypatch)
    decay = 0.75
    batches = [_batch(10 + i) for i in range(3)]
    # the JAX steps' micro-batch keys: split(rng, 2)[1], rng <- [0]
    rng, draws = jpipe.state.rng, []
    for lat, _ in batches:
        rng, micro = jax.random.split(rng, 2)
        draws.append(tuple(map(torch.tensor,
                               _jax_draws(micro, lat.shape[1:]))))
    queue = iter(draws)
    monkeypatch.setattr(tpipe, "draw", lambda shape: next(queue))
    start = [p.detach().clone() for p in tpipe.params]
    rec, jrec = Recorder(), JRecorder()
    tcbs = tcb.CallbackDict({"ema": {"decay": decay}})
    tcbs._callbacks["rec"] = rec
    jcbs = jcb.CallbackDict({"ema": {"decay": decay}})
    jcbs._callbacks["rec"] = jrec
    tpipe.train(batches, callbacks=tcbs)
    jpipe.train(batches, callbacks=jcbs)
    assert rec.calls == jrec.calls == [
        ("start", 0), ("before", 0), ("end", 1), ("before", 1), ("end", 2),
        ("before", 2), ("end", 3), ("train_end", 3)]
    shadow = tcbs["ema"].shadow
    want = [s.clone() for s in start]
    for snap in rec.snapshots:
        want = [w * decay + p * (1.0 - decay) for w, p in zip(want, snap)]
    for s, w in zip(shadow, want):
        assert torch.equal(s, w)
    names = [n for n, p in tpipe.transformer.named_parameters()
             if p.requires_grad]
    from fastvideo_tpu_torch.models.loader.jax_params import (
        state_dict_from_jax)
    jshadow = state_dict_from_jax(jax.tree.map(
        np.asarray, jcbs["ema"].shadow.to_pure_dict()))
    for n, s in zip(names, shadow):
        assert (s - jshadow[n]).abs().max().item() <= 2 * LR * 3 + 1e-6, n
    # the state_dict through a checkpoint file
    path = str(tmp_path / "callbacks.pt")
    torch.save(tcbs.state_dict(), path)
    fresh = tcb.CallbackDict({"ema": {"decay": decay}})
    fresh["ema"].on_train_start(tpipe)
    fresh.load_state_dict(torch.load(path, weights_only=False))
    for a, b in zip(fresh["ema"].shadow, shadow):
        assert torch.equal(a, b)
    assert set(tcbs.state_dict()["ema"]) == set(
        jcbs.state_dict()["ema"]) == {"decay", "shadow_flat"}
    live = [p.detach().clone() for p in tpipe.params]
    with tcbs["ema"].ema_context(tpipe):
        for p, s in zip(tpipe.params, shadow):
            assert torch.equal(p.detach(), s)
    for p, v in zip(tpipe.params, live):
        assert torch.equal(p.detach(), v)
    par.destroy_mesh()


def test_grad_clip_sets_the_threshold(monkeypatch):
    """``grad_clip`` sets ``args.max_grad_norm`` at train start (the next
    step clips by it) and logs each step's grad norm to the tracker; a
    non-positive threshold leaves the args."""
    tpipe = _torch_pipe(monkeypatch, max_train_steps=1)
    logged = []
    tpipe.tracker.log = lambda metrics, step: logged.append(metrics)
    tpipe.train([_batch(3)], callbacks={"grad_clip": {
        "max_grad_norm": 1e-4}})
    assert tpipe.args.max_grad_norm == 1e-4
    assert any("grad_norm/transformer" in m for m in logged)
    before = [p.detach().clone() for p in tpipe.params]
    tpipe.train([_batch(4)], max_steps=2,
                callbacks={"grad_clip": {"max_grad_norm": 0.0}})
    assert tpipe.args.max_grad_norm == 1e-4
    # clipped to 1e-4 of norm: AdamW's first moves are still +-lr, later
    # ones scale with the clipped gradient
    assert any(not torch.equal(a, b) for a, b in zip(before, tpipe.params))


class _Stub:
    """Enough of a trainer to run its class's ``train`` loop: the steps
    are stubs that count."""


def _stub(cls, step_fn, **attrs):
    obj = cls.__new__(cls)
    for k, v in attrs.items():
        setattr(obj, k, v)

    def train_one_step(*args, **kw):
        obj.step += 1
        return {"step": obj.step, "loss": 0.5, "kd_loss": 0.5,
                "kd_step_idx": 0.0}

    obj.train_one_step = step_fn or train_one_step
    return obj


class _Tracker:
    def log(self, metrics, step):
        pass


@pytest.mark.parametrize("kind", ["dmd2", "causal_cd", "kd"])
def test_loops_dispatch_where_jax_does(kind):
    """Each loop's hook calls over two stub steps, against the JAX loop of
    the same method: DMD2 and causal_cd dispatch start, end a step and
    train end; kd takes ``callbacks`` and dispatches none, as JAX's kd
    (which takes them in ``**kwargs``)."""
    lat = np.zeros((1, 1, 4, 2, 8, 8), np.float32)
    emb = np.zeros((1, 1, 6, 16), np.float32)
    loader = [(lat, emb)] * 2
    jargs = JTrainingArgs(num_gpus=1, dp_size=1, max_train_steps=2, seed=0)
    targs = TrainingArgs(device="cpu", max_train_steps=2, seed=0,
                         output_dir="")
    common = dict(step=0, tracker=_Tracker())
    if kind == "dmd2":
        jobj = _stub(jdp.DMD2DistillationPipeline, None, args=jargs, step=0)
        tobj = _stub(tdp.DMD2DistillationPipeline, None, args=targs,
                     label="dmd2", **common)
    elif kind == "causal_cd":
        jobj = _stub(jcd.CausalCDPipeline, None, args=jargs, step=0)
        tobj = _stub(tcd.CausalCDPipeline, None, args=targs, **common)
    else:
        jobj = _stub(jkd.KDMethod, None, _args=jargs, step=0,
                     teacher_path_cache=None, rng=jax.random.PRNGKey(0),
                     teacher_params=None,
                     _teacher_rollout=lambda *a: (np.zeros(1), np.zeros(1)))
        tobj = _stub(tkd.KDMethod, None, _args=targs, teacher=None,
                     teacher_path_cache=None,
                     draw=lambda *a, **k: None,
                     teacher_rollout=lambda *a: (torch.zeros(1),
                                                 torch.zeros(1)),
                     **common)
    rec, jrec = Recorder(), JRecorder()
    tcbs, jcbs = tcb.CallbackDict({}), jcb.CallbackDict({})
    tcbs._callbacks["rec"], jcbs._callbacks["rec"] = rec, jrec
    tobj.train(loader, callbacks=tcbs)
    jobj.train(loader, callbacks=jcbs)
    assert tobj.step == jobj.step == 2
    assert rec.calls == jrec.calls
    if kind == "kd":
        assert rec.calls == []
    else:
        assert rec.calls == [("start", 0), ("end", 1), ("end", 2),
                             ("train_end", 2)]
        assert tobj._callbacks is tcbs
