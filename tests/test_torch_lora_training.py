"""The port's LoRA fine-tuning against the JAX ``LoRATrainingPipeline`` on a
1-layer Wan with narrow widths and VSA on an exact grid: JAX's A draws
handed to the port, three steps given JAX's draws (losses, grad norms and
the adapters after each step), the base bit for bit, the trainable count;
save, resume and the same next step; ``lora_finetune`` through
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
from fastvideo_tpu.attention.backends.abstract import AttentionMetadata
from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu.fastvideo_args import TrainingArgs as JTrainingArgs
from fastvideo_tpu.forward_context import set_forward_context
from fastvideo_tpu.layers.lora import LoRALinear as JLoRALinear
from fastvideo_tpu.models.dits.wan import WanTransformer3DModel
from fastvideo_tpu.models.schedulers.flow_match_euler import (
    FlowMatchEulerDiscreteScheduler)
from fastvideo_tpu.training.methods import lora as jlora
from fastvideo_tpu_torch.configs.models.dits.wan import (
    WanArchConfig as TorchWanArchConfig)
from fastvideo_tpu_torch.dataset.parquet import (record_from_sample,
                                                 write_parquet_dataset)
from fastvideo_tpu_torch.entrypoints.cli.train import build_from_config
from fastvideo_tpu_torch.fastvideo_args import TrainingArgs
from fastvideo_tpu_torch.layers.lora import LoRALinear
from fastvideo_tpu_torch.models.dits.wan import (
    WanTransformer3DModel as TorchWanTransformer3DModel)
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.loader.safetensors_io import (load_file,
                                                              save_file)
from fastvideo_tpu_torch.models.schedulers.flow_match_euler import (
    FlowMatchEulerDiscreteScheduler as TorchScheduler)
from fastvideo_tpu_torch.training.methods import NOT_PORTED, resolve_method
from fastvideo_tpu_torch.training import training_pipeline as ttp
from fastvideo_tpu_torch.training.methods import lora as tlora
from fastvideo_tpu_torch.training.run_config import load_train_config

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_training import (  # noqa: E402
    _assert_adamw_params_close, _jax_draws)
from test_torch_wan_dit import jax_params, numpy_model  # noqa: E402
from utils import TINY_DIT  # noqa: E402

torch.set_num_threads(2)

ARCH = dict(TINY_DIT, num_layers=1)
# latents [accum, B, C, T, H, W]: token grid (2, 16, 16), 4 exact VSA tiles
LATENTS = (1, 1, 4, 2, 32, 32)
EMBEDS = (1, 1, 12, ARCH["text_dim"])
SPARSITY = 0.5
LR = 1e-3
RANK, ALPHA = 4, 8.0
STEPS = 3


def _arch(cls):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in ARCH.items()})


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(LATENTS).astype(np.float32),
            rng.standard_normal(EMBEDS).astype(np.float32))


def _jax_init_draws(jmodel, seed: int) -> dict[str, np.ndarray]:
    """The standard normal draw each JAX LoRA layer takes at init, by path
    (JAX's walk and key chain), in the port's [r, in] layout."""
    key = jax.random.PRNGKey(seed)
    out = {}

    def walk(mod, path):
        nonlocal key
        for name, child in list(vars(mod).items()):
            if str(name).startswith("_"):
                continue
            full = f"{path}.{name}" if path else str(name)
            if isinstance(child, JLoRALinear):
                key, sub = jax.random.split(key)
                out[full] = np.asarray(jax.random.normal(
                    sub, child.lora_A.value.shape, jnp.float32)).T
            if isinstance(child, (list, nnx.List)):
                for i, item in enumerate(child):
                    if isinstance(item, nnx.Module):
                        walk(item, f"{full}.{i}")
            elif isinstance(child, nnx.Module):
                walk(child, full)

    walk(jmodel, "")
    return out


class _HandedInit(tlora.LoRATrainingPipeline):
    """The port's pipeline, its A draws handed in by path."""
    handed: dict[str, np.ndarray] = {}

    def draw_lora_A(self, name, shape):
        a = torch.from_numpy(np.ascontiguousarray(self.handed[name]))
        assert tuple(a.shape) == shape
        return a


def _torch_model(jmodel=None):
    torch.manual_seed(0)
    model = TorchWanTransformer3DModel(_arch(TorchWanArchConfig),
                                       dtype=torch.float32)
    if jmodel is not None:
        model.load_state_dict(state_dict_from_jax(jax_params(jmodel)),
                              strict=True)
    return model


def _targs(**kw):
    return TrainingArgs(**dict(dict(
        device="cpu", learning_rate=LR, max_grad_norm=1.0,
        weighting_scheme="uniform", seed=0, output_dir="",
        VSA_sparsity=SPARSITY, selective_checkpointing="full"), **kw))


def _sched(cls):
    s = cls(shift=3.0)
    s.set_timesteps(1000)
    return s


def _adapters(model) -> dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if ".lora_" in n}


def _jax_grads(jpipe, latents, embeds, key):
    """JAX's adapter gradients of one micro-batch, by state_dict name."""
    loss_fn = jpipe._make_loss_fn()
    with set_forward_context(attn_metadata=AttentionMetadata(
            extra={"VSA_sparsity": SPARSITY})):
        _, grads = jax.value_and_grad(loss_fn)(
            jpipe.state.params, jpipe._frozen, jnp.asarray(latents[0]),
            jnp.asarray(embeds[0]), key)
    return state_dict_from_jax(jax.tree.map(np.asarray,
                                            grads.to_pure_dict()))


def test_three_steps_match_jax(monkeypatch):
    """Given JAX's A draws, the port's adapters start as JAX's (bit for
    bit), with B = 0; then 3 steps given JAX's draws, bf16 compute on both
    sides (rounded at different places):

    * each step's loss within 1e-2 relative and grad norm within 2e-2
      relative (the SFT test's bars);
    * step 1's adapter gradients within 3e-2 relative L2 over all adapters
      (the SFT test's bar) and 2e-1 of each tensor's norm (plus 1e-9: the
      A gradients are 0 while B is), and the adapters after its AdamW
      update by the SFT test's rule;
    * after every step each adapter element within 2 lr a step of JAX's
      (an AdamW update moves an element by at most lr) and the moves
      (adapter less its start) within 0.3 relative L2 over all adapters.

    The per-tensor and move bars are wider than the full model's: the
    rank-4 projections of the self-attention's q / k gradients are 1e-3 of
    the largest gradient and carry bf16 noise of 0.1-0.2 of their norm, a
    few percent of their elements take the other sign, and AdamW moves
    each of those by lr whatever its size (0.21 relative L2 at worst over
    these steps). The base bit for bit, without gradients; the trainable
    count JAX's."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    par.destroy_mesh()
    jmodel = numpy_model(lambda: WanTransformer3DModel(
        _arch(WanArchConfig), param_dtype=jnp.float32, rngs=nnx.Rngs(0)),
        seed=0)
    model = _torch_model(jmodel)
    base = {n: t.clone() for n, t in model.state_dict().items()}
    jargs = JTrainingArgs(num_gpus=1, dp_size=1, learning_rate=LR,
                          max_grad_norm=1.0, weighting_scheme="uniform",
                          seed=0, output_dir="", VSA_sparsity=SPARSITY)
    jpipe = jlora.LoRATrainingPipeline(
        jmodel, _sched(FlowMatchEulerDiscreteScheduler), jargs, rank=RANK,
        alpha=ALPHA, init_seed=7)
    handed = _jax_init_draws(jmodel, 7)
    assert len(handed) == 10 + 4
    monkeypatch.setattr(_HandedInit, "handed", handed)
    tpipe = _HandedInit(model, _sched(TorchScheduler), _targs(), rank=RANK,
                        alpha=ALPHA, init_seed=7)
    assert tpipe.n_lora_layers == 14

    def jadapters():
        return state_dict_from_jax(jax.tree.map(
            np.asarray, jpipe.state.params.to_pure_dict()))

    start = jadapters()
    got = _adapters(model)
    assert set(got) == set(start)
    for name, want in start.items():
        assert torch.equal(got[name], want), name
        if name.endswith("lora_B"):
            assert not want.any()
    n_jax = sum(x.size for x in jax.tree.leaves(jpipe.state.params))
    assert sum(p.numel() for p in tpipe.params) == n_jax
    assert {id(p) for p in tpipe.params} == {
        id(p) for n, p in model.named_parameters() if ".lora_" in n}
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    raw = {}
    clip = ttp.clip_grad_norm

    def keep_grads(params, max_norm):
        raw.setdefault("first", dict(zip(
            names, (p.grad.detach().clone() for p in params))))
        return clip(params, max_norm)

    monkeypatch.setattr(ttp, "clip_grad_norm", keep_grads)

    rng = jpipe.state.rng
    for step in range(STEPS):
        latents, embeds = _batch(10 + step)
        rng, micro = jax.random.split(rng, 2)
        draws = _jax_draws(micro, latents.shape[1:])
        monkeypatch.setattr(tpipe, "draw", lambda shape, d=draws: tuple(
            map(torch.tensor, d)))
        if step == 0:
            jgrads = _jax_grads(jpipe, latents, embeds, micro)
        jout = jpipe.train_one_step(latents, embeds, vsa_sparsity=SPARSITY)
        tout = tpipe.train_one_step(latents, embeds, vsa_sparsity=SPARSITY)
        assert tout["step"] == jout["step"] == step + 1
        np.testing.assert_allclose(tout["loss"], jout["loss"], rtol=1e-2)
        np.testing.assert_allclose(tout["grad_norm"], jout["grad_norm"],
                                   rtol=2e-2)
        want, got = jadapters(), _adapters(model)
        if step == 0:
            tgrads = raw["first"]
            flat_t = torch.cat([tgrads[n].flatten() for n in jgrads])
            flat_j = torch.cat([jgrads[n].flatten() for n in jgrads])
            assert (flat_t - flat_j).norm() / flat_j.norm() < 3e-2
            for n, g in jgrads.items():
                assert (tgrads[n] - g).norm() <= 2e-1 * g.norm() + 1e-9, n
            _assert_adamw_params_close(
                got, want, tgrads, jgrads, LR,
                clip=min(1.0, 1.0 / jout["grad_norm"]))
        num = den = 0.0
        for name, w in want.items():
            diff = (got[name] - w).abs().max().item()
            assert diff <= 2 * LR * (step + 1) + 1e-6, (name, diff)
            num += ((got[name] - w) ** 2).sum().item()
            den += ((w - start[name]) ** 2).sum().item()
        assert den > 0 and (num / den) ** 0.5 < 0.3, (num / den) ** 0.5
    assert np.array_equal(np.asarray(rng), np.asarray(jpipe.state.rng))
    for name, t in model.state_dict().items():
        if ".lora_" not in name:
            assert torch.equal(t, base[name]), name
    assert all(p.grad is None for p in model.parameters())
    assert all(not p.requires_grad for n, p in model.named_parameters()
               if ".lora_" not in n)
    par.destroy_mesh()


def test_no_target_raises():
    model = _torch_model()
    with pytest.raises(ValueError, match="no Linear matched"):
        tlora.LoRATrainingPipeline(model, _sched(TorchScheduler), _targs(),
                                   target_modules=("no_such_linear",))


def test_save_resume_gives_the_same_next_step(tmp_path, monkeypatch):
    """Two steps, a checkpoint (the adapters and their AdamW state only),
    a third step; a fresh pipeline over the same base resumed from the
    checkpoint takes the same third step, bit for bit."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")

    def pipe(out):
        return tlora.LoRATrainingPipeline(
            _torch_model(), _sched(TorchScheduler), _targs(output_dir=out),
            rank=RANK, alpha=ALPHA, init_seed=1)

    out = str(tmp_path / "ckpt")
    first = pipe(out)
    for step in range(2):
        first.train_one_step(*_batch(step), vsa_sparsity=SPARSITY)
    first.save_checkpoint()
    want = first.train_one_step(*_batch(2), vsa_sparsity=SPARSITY)
    saved = load_file(os.path.join(out, "checkpoint-2", "model.safetensors"))
    assert set(saved) == set(_adapters(first.transformer))
    opt = load_file(os.path.join(out, "checkpoint-2",
                                 "optimizer.safetensors"))
    assert len({k.split(".")[0] for k in opt}) == len(saved)

    second = pipe(out)
    second.resume_from_checkpoint()
    assert second.step == 2
    got = second.train_one_step(*_batch(2), vsa_sparsity=SPARSITY)
    assert got == want
    a, b = _adapters(first.transformer), _adapters(second.transformer)
    assert all(torch.equal(a[n], b[n]) for n in a)


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


def test_build_from_config_trains_lora_on_parquet(checkpoint, tmp_path):
    """``method: lora_finetune`` with a Parquet ``data.path``: two steps on
    the CPU move every A and B (B from 0) and leave the base; rank, alpha
    and targets from ``method_config``."""
    rng = np.random.default_rng(2)
    data = str(tmp_path / "data")
    write_parquet_dataset([record_from_sample(
        f"s{i}", rng.standard_normal(LATENTS[2:]).astype(np.float32),
        rng.standard_normal(EMBEDS[2:]).astype(np.float32))
        for i in range(3)], data)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({
        "method": "lora_finetune",
        "model": {"pretrained_model_path": checkpoint,
                  "dit_precision": "fp32"},
        "data": {"path": data, "batch_size": 1},
        "method_config": {"rank": RANK, "alpha": ALPHA, "init_seed": 3,
                          "target_modules": ["to_q", "to_v", "fc_out"]},
        "training": {"device": "cpu", "learning_rate": 1e-3, "seed": 0,
                     "VSA_sparsity": SPARSITY,
                     "selective_checkpointing": "full",
                     "max_train_steps": 2, "output_dir": ""},
    }))
    method, loader = build_from_config(load_train_config(str(cfg_path)))
    assert isinstance(method, tlora.LoRAFinetuneMethod)
    assert resolve_method("lora_finetune") is tlora.LoRAFinetuneMethod
    assert "lora_finetune" not in NOT_PORTED
    pipe = method.pipeline
    layers = [m for m in pipe.transformer.modules()
              if isinstance(m, LoRALinear)]
    # to_q, to_v (self and cross) and fc_out (FFN, time and text MLPs)
    assert len(layers) == pipe.n_lora_layers == 4 + 3
    assert all(m.rank == RANK and m.scaling == ALPHA / RANK for m in layers)
    before = {n: p.detach().clone() for n, p in
              pipe.transformer.named_parameters()}
    try:
        method.train(loader)
    finally:
        loader.shutdown()
    assert pipe.step == 2
    for n, p in pipe.transformer.named_parameters():
        assert torch.equal(before[n], p) == (".lora_" not in n), n
