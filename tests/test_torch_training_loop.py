"""The port's training loop around the step: the entry point
(``build_from_config`` on a JSON and a simple-YAML config, ``SFTMethod``,
``method.train`` over a ``PrefetchingLoader``), checkpoint save and restore
with the random state, the samplers and the loader's resume (against the
JAX package's samplers), the trackers, the loss falling on one sample, and
what the slice leaves out raising."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from fastvideo_tpu.dataset.parquet import DPSPBatchSampler as JSampler
from fastvideo_tpu_torch.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu_torch.dataset.loader import PrefetchingLoader
from fastvideo_tpu_torch.dataset.parquet import (DPSPBatchSampler,
                                                 _AccumSampler)
from fastvideo_tpu_torch.entrypoints.cli.train import build_from_config
from fastvideo_tpu_torch.models.dits.wan import WanTransformer3DModel
from fastvideo_tpu_torch.models.loader.safetensors_io import save_file
from fastvideo_tpu_torch.training.callbacks import CallbackDict
from fastvideo_tpu_torch.training.methods import NOT_PORTED, resolve_method
from fastvideo_tpu_torch.training.methods.fine_tuning import SFTMethod
from fastvideo_tpu_torch.training.run_config import (build_dataloader,
                                                     build_training_args,
                                                     load_train_config)
from fastvideo_tpu_torch.training.trackers import (DummyTracker,
                                                   JsonlTracker,
                                                   initialize_trackers)

sys.path.insert(0, os.path.dirname(__file__))

from utils import TINY_DIT  # noqa: E402

torch.set_num_threads(2)

LATENTS = (1, 1, 4, 2, 32, 32)  # token grid (2, 16, 16): exact VSA tiles
EMBEDS = (1, 1, 12, 32)


@pytest.fixture
def checkpoint(tmp_path, monkeypatch):
    """A diffusers-style directory with a tiny VSA Wan ``transformer/``,
    written with the port's own safetensors writer."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    root = tmp_path / "Wan2.1-T2V-tiny-Diffusers"
    tdir = root / "transformer"
    tdir.mkdir(parents=True)
    cfg = dict(TINY_DIT, _class_name="WanTransformer3DModel")
    (tdir / "config.json").write_text(json.dumps(cfg))
    torch.manual_seed(0)
    model = WanTransformer3DModel(
        WanArchConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in TINY_DIT.items()}))
    save_file(model.state_dict(), str(tdir / "model.safetensors"))
    return str(root)


def _config(checkpoint, out_dir, **training):
    return {
        "method": "sft",
        "model": {"pretrained_model_path": checkpoint,
                  "dit_precision": "fp32"},
        "training": {"device": "cpu", "VSA_sparsity": 0.5,
                     "selective_checkpointing": "full",
                     "learning_rate": 1e-3, "max_grad_norm": 1.0,
                     "weighting_scheme": "uniform", "seed": 0,
                     "gradient_accumulation_steps": 1,
                     "output_dir": out_dir, "checkpointing_steps": 0,
                     **training},
    }


YAML = """\
method: sft   # the only method the port registers
model:
  pretrained_model_path: {path}
  dit_precision: fp32
training:
  device: cpu
  VSA_sparsity: 0.5
  selective_checkpointing: full
  learning_rate: 1e-3
  max_grad_norm: 1.0
  weighting_scheme: "uniform"
  seed: 0
  gradient_accumulation_steps: 1
  output_dir: {out}
  checkpointing_steps: 0
"""


def _loader(seed=0, n=8, accum=1):
    """Seeded numpy batches through the samplers and the prefetching
    loader, as the JAX repo's train-step bench builds them."""
    rng = np.random.default_rng(seed)
    data = [(rng.standard_normal(LATENTS[2:]).astype(np.float32),
             rng.standard_normal(EMBEDS[2:]).astype(np.float32))
            for _ in range(n)]

    def make_batch(groups):  # [accum][batch] indices
        return tuple(np.stack([np.stack([data[i][j] for i in idx])
                               for idx in groups]) for j in (0, 1))

    sampler = _AccumSampler(DPSPBatchSampler(n, 1, 1, 0, seed=seed), accum)
    return PrefetchingLoader(sampler, make_batch, prefetch=2)


def test_build_from_config_json_and_yaml_then_train(checkpoint, tmp_path):
    json_path = tmp_path / "cfg.json"
    json_path.write_text(json.dumps(_config(checkpoint, str(tmp_path))))
    yaml_path = tmp_path / "cfg.yaml"
    yaml_path.write_text(YAML.format(path=checkpoint, out=str(tmp_path)))
    a, b = load_train_config(str(json_path)), load_train_config(
        str(yaml_path))
    assert a == b
    method, dataloader = build_from_config(b)
    assert isinstance(method, SFTMethod) and dataloader is None
    pipe = method.pipeline
    assert method.args.VSA_sparsity == 0.5 and pipe.device.type == "cpu"
    assert pipe.transformer.training and pipe.transformer.gradient_checkpointing
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in pipe.transformer.parameters())
    before = {n: p.detach().clone()
              for n, p in pipe.transformer.named_parameters()}
    loader = _loader()
    try:
        method.train(loader, max_steps=2)
    finally:
        loader.shutdown()
    assert pipe.step == 2
    moved = [not torch.equal(before[n], p)
             for n, p in pipe.transformer.named_parameters()]
    assert all(moved)


def test_checkpoint_roundtrip_restores_rng_and_next_step(checkpoint,
                                                         tmp_path):
    cfg = load_train_config(str(_write(tmp_path, _config(
        checkpoint, str(tmp_path / "out")))))
    method, _ = build_from_config(cfg)
    pipe = method.pipeline
    rng = np.random.default_rng(1)
    batches = [tuple(rng.standard_normal(s).astype(np.float32)
                     for s in (LATENTS, EMBEDS)) for _ in range(3)]
    for lat, emb in batches[:2]:
        pipe.train_one_step(lat, emb, vsa_sparsity=0.5)
    method.save_checkpoint()
    saved = {n: t.clone() for n, t in pipe.transformer.state_dict().items()}
    nxt = pipe.train_one_step(*batches[2], vsa_sparsity=0.5)
    after = {n: t.clone() for n, t in pipe.transformer.state_dict().items()}
    method.resume_from_checkpoint()
    assert pipe.step == 2
    for n, t in pipe.transformer.state_dict().items():
        assert torch.equal(t, saved[n]), n
    again = pipe.train_one_step(*batches[2], vsa_sparsity=0.5)
    assert again["loss"] == nxt["loss"]
    assert again["grad_norm"] == nxt["grad_norm"]
    for n, t in pipe.transformer.state_dict().items():
        assert torch.equal(t, after[n]), n


def test_checkpoints_keep_the_newest(tmp_path):
    from fastvideo_tpu_torch.training.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    p = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.AdamW([p], lr=0.1)
    p.grad = torch.ones(3)
    opt.step()
    for step in (1, 2, 3):
        mgr.save(step, {"w": p.detach() * step}, opt.state_dict(),
                 torch.Generator().manual_seed(step).get_state())
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    model, opt_state, rng, meta = mgr.restore()
    assert torch.equal(model["w"], p.detach() * 3) and meta["step"] == 3
    assert torch.equal(rng, torch.Generator().manual_seed(3).get_state())
    fresh = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(3))], lr=0.1)
    fresh.load_state_dict(opt_state)
    assert fresh.param_groups[0]["betas"] == (0.9, 0.999)
    torch.testing.assert_close(
        list(fresh.state.values())[0]["exp_avg"],
        list(opt.state.values())[0]["exp_avg"])


def _write(tmp_path, cfg):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return path


def test_samplers_match_jax_and_loader_resumes():
    mine = DPSPBatchSampler(10, 2, 1, 0, seed=3)
    theirs = JSampler(10, 2, 1, 0, seed=3)
    for _ in range(2):  # two epochs
        assert list(mine) == list(theirs)
    accum = _AccumSampler(DPSPBatchSampler(12, 1, 1, 0, seed=5), 2)
    groups = list(accum)
    assert len(groups) == 6 and all(len(g) == 2 for g in groups)

    def run(loader, n):
        return [loader.__next__()[0].sum() for _ in range(n)]

    ref = _loader(seed=4)
    want = run(ref, 6)
    ref.shutdown()
    first = _loader(seed=4)
    got = run(first, 3)
    state = first.state_dict()
    first.shutdown()
    resumed = _loader(seed=4)
    resumed.load_state_dict(state)
    got += run(resumed, 3)
    resumed.shutdown()
    assert got == want


def test_loss_falls_on_one_sample(checkpoint, tmp_path):
    cfg = load_train_config(str(_write(tmp_path, _config(
        checkpoint, "", learning_rate=3e-3))))
    pipe = build_from_config(cfg)[0].pipeline
    rng = np.random.default_rng(2)
    lat, emb = (rng.standard_normal(s).astype(np.float32)
                for s in (LATENTS, EMBEDS))
    losses = [pipe.train_one_step(lat, emb, vsa_sparsity=0.5)["loss"]
              for _ in range(30)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_trackers(tmp_path):
    t = initialize_trackers(["jsonl", "no-such-backend"], "proj",
                            config={"lr": 1e-3}, log_dir=str(tmp_path),
                            run_name="r")
    assert isinstance(t, JsonlTracker)
    t.log({"loss": torch.tensor(0.5), "step": 1}, 1)
    t.finish()
    rows = (tmp_path / "proj" / "r" / "metrics.jsonl").read_text().splitlines()
    assert json.loads(rows[0])["loss"] == 0.5
    assert isinstance(initialize_trackers([], "p"), DummyTracker)


def test_what_waits_raises(checkpoint, tmp_path):
    for name in NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            resolve_method(name)
    with pytest.raises(ValueError, match="Unknown training method"):
        resolve_method("no_such_method")
    cfg = load_train_config(str(_write(tmp_path, dict(
        _config(checkpoint, ""), data={"path": str(tmp_path)}))))
    # the Parquet reader is ported: a data path without shards raises
    with pytest.raises(FileNotFoundError, match="no parquet files"):
        build_dataloader(cfg, build_training_args(cfg))
    method = build_from_config(load_train_config(str(_write(
        tmp_path, _config(checkpoint, "")))))[0]
    # training callbacks are ported (tests/test_torch_callbacks.py): at
    # max_train_steps the loop dispatches only train start and end
    method.pipeline.step = method.args.max_train_steps
    cbs = CallbackDict({"ema": {}})
    method.train([], callbacks=cbs)
    assert len(cbs["ema"].shadow) == len(method.pipeline.params)
    # a dotted path resolves in the port, and must name a TrainingMethod
    assert resolve_method("fastvideo_tpu.training.methods.fine_tuning."
                          "SFTMethod") is type(method)
    with pytest.raises(TypeError, match="not a TrainingMethod"):
        resolve_method("fastvideo_tpu.training.callbacks.EMACallback")


def test_validation_sample_with_the_current_parameters(checkpoint,
                                                       tmp_path):
    """Few-step sampling with the training parameters: finite latents of
    the asked shape, the same for the same seed."""
    cfg = load_train_config(str(_write(tmp_path, _config(checkpoint, ""))))
    pipe = build_from_config(cfg)[0].pipeline
    emb = np.random.default_rng(3).standard_normal(EMBEDS[1:]).astype(
        np.float32)
    a = pipe.validation_sample(emb, LATENTS[1:], (1000, 500), seed=3)
    b = pipe.validation_sample(emb, LATENTS[1:], (1000, 500), seed=3)
    assert a.shape == LATENTS[1:] and torch.isfinite(a).all()
    assert torch.equal(a, b)
