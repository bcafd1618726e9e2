"""``selective_checkpointing="ops"``: the Wan DiT keeps the outputs of its
matmuls (``aten.mm`` / ``aten.addmm``, JAX's
``dots_with_no_batch_dims_saveable``) and recomputes the rest of each
block. Its gradients equal those of "full" and of no checkpointing bit for
bit, and JAX's "ops" step by the SFT test's bars; its backward runs no
matmul of the forward again (as many as without checkpointing, where
"full" runs each block's again); every trainer takes "ops"; and the causal
Wan's block-causal passes recompute whole blocks under it, as JAX's
``train_forward`` does (its ``jax.checkpoint`` takes no policy)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from torch.utils._python_dispatch import TorchDispatchMode

import fastvideo_tpu.parallel as par
from fastvideo_tpu.attention.backends.abstract import AttentionMetadata
from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu.fastvideo_args import TrainingArgs as JTrainingArgs
from fastvideo_tpu.forward_context import set_forward_context
from fastvideo_tpu.models.dits.wan import WanTransformer3DModel
from fastvideo_tpu.models.schedulers.flow_match_euler import (
    FlowMatchEulerDiscreteScheduler)
from fastvideo_tpu.training import training_pipeline as jtp
from fastvideo_tpu_torch.configs.models.dits.wan import (
    WanArchConfig as TorchWanArchConfig)
from fastvideo_tpu_torch.fastvideo_args import TrainingArgs
from fastvideo_tpu_torch.models.dits.wan import SAVED_UNDER_OPS
from fastvideo_tpu_torch.models.dits.wan import (
    WanTransformer3DModel as TorchWanTransformer3DModel)
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.registry import resolve_model_cls
from fastvideo_tpu_torch.training import distillation_pipeline as tdp
from fastvideo_tpu_torch.training.methods import causal_cd as tcd
from fastvideo_tpu_torch.training.methods import knowledge_distillation as tkd
from fastvideo_tpu_torch.training.training_utils import (
    set_activation_checkpointing)

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_training import (LR, SPARSITY, _batch,  # noqa: E402
                                 _grads, _jax_draws, _torch_pipe)
from test_torch_wan_dit import _arch, numpy_model  # noqa: E402
from utils import TINY_DIT  # noqa: E402

torch.set_num_threads(2)


class MatmulCount(TorchDispatchMode):
    """Counts the matmuls ``"ops"`` saves, as they are dispatched."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in SAVED_UNDER_OPS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _draws(seed=7):
    rng = np.random.default_rng(seed)
    lat, _ = _batch(3)
    return (torch.from_numpy(rng.random(1).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(lat.shape[1:]).astype(
                np.float32)))


def test_ops_gradients_equal_full_and_none(monkeypatch):
    """One SFT micro-batch under "ops", "full" and none: equal losses and
    gradients bit for bit; the backward's matmuls: "ops" as many as none,
    "full" one forward's more (each block's recompute)."""
    lat, emb = _batch(3)
    draws = _draws()
    outs, counts = {}, {}
    for remat in ("ops", "full", "none"):
        pipe = _torch_pipe(monkeypatch, selective_checkpointing=remat)
        model = pipe.transformer
        assert model.gradient_checkpointing == (remat != "none")
        assert model.gradient_checkpointing_policy == (
            "ops" if remat == "ops" else None)
        with pipe._context(SPARSITY):
            loss = pipe.loss(torch.from_numpy(lat[0]),
                             torch.from_numpy(emb[0]), *draws)
        with MatmulCount() as count:
            loss.backward()
        counts[remat] = count.n
        outs[remat] = (loss.item(), [p.grad.clone() for p in pipe.params])
    # the blocks' matmuls in one forward: counted between each block's
    # entry and exit
    in_block, block_mms = [], [0]

    class BlockCount(MatmulCount):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in SAVED_UNDER_OPS and in_block:
                block_mms[0] += 1
            return func(*args, **(kwargs or {}))

    def enter(*args):
        in_block.append(1)

    def leave(*args):
        in_block.pop()

    for block in pipe.transformer.blocks:
        block.register_forward_pre_hook(enter)
        block.register_forward_hook(leave)
    with torch.no_grad(), BlockCount():
        pipe.transformer(torch.from_numpy(lat[0]).bfloat16(),
                         torch.from_numpy(emb[0]).bfloat16(),
                         torch.tensor([500.0]))
    for remat in ("ops", "full"):
        assert outs[remat][0] == outs["none"][0]
        for a, b in zip(outs[remat][1], outs["none"][1]):
            assert torch.equal(a, b)
    assert counts["ops"] == counts["none"]
    assert block_mms[0] > 0
    assert counts["full"] == counts["none"] + block_mms[0]


def test_ops_step_matches_jax_ops_step(monkeypatch):
    """One SFT step with "ops" on both sides (JAX's trainer sets
    ``dots_with_no_batch_dims_saveable``), the port given JAX's draws:
    the loss within 1e-2 relative, the gradients within 3e-2 relative L2
    and the grad norm within 2e-2 relative (the SFT test's bars: bf16 on
    both sides, rounded at other places)."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    par.destroy_mesh()
    jmodel = numpy_model(lambda: WanTransformer3DModel(
        _arch(WanArchConfig), param_dtype=jnp.float32, rngs=nnx.Rngs(0)),
        seed=0)
    tpipe = _torch_pipe(monkeypatch, jmodel=jmodel,
                        selective_checkpointing="ops")
    sched = FlowMatchEulerDiscreteScheduler(shift=3.0)
    sched.set_timesteps(1000)
    jpipe = jtp.TrainingPipeline(jmodel, sched, JTrainingArgs(
        num_gpus=1, dp_size=1, learning_rate=LR, max_grad_norm=1.0,
        weighting_scheme="uniform", seed=0, output_dir="",
        VSA_sparsity=SPARSITY, selective_checkpointing="ops"))
    assert jmodel.gradient_checkpointing_policy is \
        jax.checkpoint_policies.dots_with_no_batch_dims_saveable
    latents, embeds = _batch(1)
    micro_key = jax.random.split(jpipe.state.rng, 2)[1]
    draws = _jax_draws(micro_key, latents.shape[1:])
    with set_forward_context(attn_metadata=AttentionMetadata(
            extra={"VSA_sparsity": SPARSITY})):
        jloss, jgrads = jax.value_and_grad(jpipe._make_loss_fn())(
            jpipe.state.params, None, jnp.asarray(latents[0]),
            jnp.asarray(embeds[0]), micro_key)
    jgrads = state_dict_from_jax(jax.tree.map(np.asarray,
                                              jgrads.to_pure_dict()))
    tloss, tgrads = _grads(tpipe, latents[0], embeds[0], draws)
    np.testing.assert_allclose(tloss, float(jloss), rtol=1e-2)
    flat_t = torch.cat([tgrads[n].flatten() for n in jgrads])
    flat_j = torch.cat([jgrads[n].flatten() for n in jgrads])
    assert (flat_t - flat_j).norm() / flat_j.norm() < 3e-2
    jout = jpipe.train_one_step(latents, embeds, vsa_sparsity=SPARSITY)
    monkeypatch.setattr(tpipe, "draw", lambda shape: tuple(
        map(torch.tensor, draws)))
    tout = tpipe.train_one_step(latents, embeds, vsa_sparsity=SPARSITY)
    np.testing.assert_allclose(tout["loss"], jout["loss"], rtol=1e-2)
    np.testing.assert_allclose(tout["grad_norm"], jout["grad_norm"],
                               rtol=2e-2)
    par.destroy_mesh()


def _dit():
    return TorchWanTransformer3DModel(_arch(TorchWanArchConfig),
                                      dtype=torch.float32)


@pytest.mark.parametrize("remat", ["ops", "full", "none"])
def test_every_trainer_takes_ops(monkeypatch, remat):
    """DMD2, causal_cd and kd build under each mode (they raised for "ops"
    before) and set their trained roles' checkpointing by it; the frozen
    roles stay without."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    args = TrainingArgs(device="cpu", seed=0, output_dir="",
                        selective_checkpointing=remat)
    policy = "ops" if remat == "ops" else None
    dmd = tdp.DMD2DistillationPipeline(_dit(), _dit(), _dit(), args)
    for m in (dmd.generator, dmd.fake_score):
        assert m.gradient_checkpointing == (remat != "none")
        assert m.gradient_checkpointing_policy == policy
    cd = tcd.CausalCDPipeline(_dit(), _dit(), args)
    assert cd.student.gradient_checkpointing == (remat != "none")
    assert cd.student.gradient_checkpointing_policy == policy
    assert not cd.ema.gradient_checkpointing
    kd = tkd.KDMethod(_dit(), args, teacher=_dit())
    assert kd.student.gradient_checkpointing_policy == policy


def test_causal_train_forward_recomputes_whole_blocks(monkeypatch):
    """The causal Wan takes the policy's attribute, but its block-causal
    ``train_forward`` checkpoints whole blocks as JAX's: under "ops" its
    backward runs the same matmuls as under "full"."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    cfg = dict(TINY_DIT, num_frames_per_block=2, local_attn_size=-1,
               sink_size=0)
    cls, arch_cls = resolve_model_cls("CausalWanTransformer3DModel")
    torch.manual_seed(0)
    model = cls(arch_cls(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in cfg.items()}), dtype=torch.float32)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 8, 12)).astype(
        np.float32))
    emb = torch.from_numpy(rng.standard_normal((1, 7, 32)).astype(
        np.float32))
    t = torch.tensor([[800.0, 800.0, 300.0, 300.0]])
    counts, grads = {}, {}
    for remat in ("ops", "full", "none"):
        set_activation_checkpointing(model, remat)
        model.zero_grad(set_to_none=True)
        out = model.train_forward(x.bfloat16(), emb.bfloat16(), t)
        with MatmulCount() as count:
            out.float().square().mean().backward()
        counts[remat] = count.n
        grads[remat] = [p.grad.clone() for p in model.parameters()]
    assert model.gradient_checkpointing_policy is None
    assert counts["ops"] == counts["full"] > counts["none"]
    for a, b in zip(grads["ops"], grads["none"]):
        assert torch.equal(a, b)
