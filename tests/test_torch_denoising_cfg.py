"""The port's multistep DenoisingStage against the JAX stage on a tiny Wan
DiT with the same weights, numpy-seeded latents and text embeddings, and a
FlowUniPC scheduler each: classifier-free guidance, the delta-CFG cache
(also through ``enable_teacache``), guidance rescale, the trajectory, and a
per-request VSA sparsity. The DiT runs VIDEO_SPARSE_ATTN on the token grid
(3, 9, 11), which has no exact tile (padded (4, 8, 8) tiles). fp32."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu.configs.pipelines.wan import (
    WanT2V480PConfig as JaxWanT2V480PConfig)
from fastvideo_tpu.fastvideo_args import FastVideoArgs as JaxFastVideoArgs
from fastvideo_tpu.models.dits.wan import WanTransformer3DModel
from fastvideo_tpu.models.schedulers.flow_unipc import (
    FlowUniPCMultistepScheduler as JaxScheduler)
from fastvideo_tpu.pipelines.batch import ForwardBatch as JaxForwardBatch
from fastvideo_tpu.pipelines.stages.denoising import (
    DenoisingStage as JaxDenoisingStage)
from fastvideo_tpu_torch.configs.models.dits.wan import (
    WanArchConfig as TorchWanArchConfig)
from fastvideo_tpu_torch.configs.pipelines.wan import WanT2V480PConfig
from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.models.dits.wan import (
    WanTransformer3DModel as TorchWanTransformer3DModel)
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.schedulers.flow_unipc import (
    FlowUniPCMultistepScheduler)
from fastvideo_tpu_torch.pipelines.batch import ForwardBatch
from fastvideo_tpu_torch.pipelines.stages.denoising import DenoisingStage

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_wan_dit import _arch, jax_params, numpy_model  # noqa: E402

torch.set_num_threads(2)

STEPS = 4
LATENT_SHAPE = (1, 4, 3, 18, 22)  # token grid (3, 9, 11)
# fp32 both sides through 2 blocks x 2 passes x 4 steps: summation order,
# amplified by the guidance scale
ATOL = 2e-4


@pytest.fixture(scope="module")
def models():
    mp = pytest.MonkeyPatch()
    mp.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    try:
        jmodel = numpy_model(lambda: WanTransformer3DModel(
            _arch(WanArchConfig), param_dtype=jnp.float32, rngs=nnx.Rngs(0)),
            seed=3)
        tmodel = TorchWanTransformer3DModel(_arch(TorchWanArchConfig),
                                            dtype=torch.float32)
    finally:
        mp.undo()
    assert tmodel.vsa_tiled_order
    tmodel.load_state_dict(state_dict_from_jax(jax_params(jmodel)),
                           strict=True)
    rng = np.random.default_rng(0)
    data = dict(
        latents=rng.standard_normal(LATENT_SHAPE).astype(np.float32),
        pos=rng.standard_normal((1, 12, 32)).astype(np.float32),
        neg=rng.standard_normal((1, 12, 32)).astype(np.float32))
    return jmodel, tmodel, data


def _run(models, jax_stage=None, *, sparsity_args=0.5, **fields):
    """Run both stages on the same inputs; returns (port batch, JAX batch).
    ``jax_stage`` reuses one jitted JAX stage across cases."""
    jmodel, tmodel, data = models
    extra = fields.pop("extra", {})
    jsched, tsched = JaxScheduler(shift=3.0), FlowUniPCMultistepScheduler(
        shift=3.0)
    jsched.set_timesteps(STEPS)
    tsched.set_timesteps(STEPS)
    if jax_stage is None:
        jax_stage = JaxDenoisingStage(jmodel, jsched,
                                      JaxWanT2V480PConfig(precision="fp32"))
    jax_stage.scheduler = jsched
    jb = JaxForwardBatch(
        latents=jnp.asarray(data["latents"]),
        prompt_embeds=[jnp.asarray(data["pos"])],
        negative_prompt_embeds=[jnp.asarray(data["neg"])],
        do_classifier_free_guidance=True, timesteps=jsched.timesteps,
        extra=dict(extra), **fields)
    jb = jax_stage.forward(jb, JaxFastVideoArgs(VSA_sparsity=sparsity_args))
    stage = DenoisingStage(tmodel, tsched, WanT2V480PConfig(precision="fp32"),
                           device=torch.device("cpu"))
    tb = ForwardBatch(
        latents=torch.from_numpy(data["latents"]),
        prompt_embeds=[torch.from_numpy(data["pos"])],
        negative_prompt_embeds=[torch.from_numpy(data["neg"])],
        do_classifier_free_guidance=True, timesteps=tsched.timesteps,
        extra=dict(extra), **fields)
    with torch.no_grad():
        tb = stage.forward(tb, FastVideoArgs(VSA_sparsity=sparsity_args))
    return tb, jb


@pytest.fixture(scope="module")
def jax_stage(models):
    return JaxDenoisingStage(models[0], JaxScheduler(shift=3.0),
                             JaxWanT2V480PConfig(precision="fp32"))


@pytest.fixture(scope="module")
def plain_cfg(models, jax_stage):
    return _run(models, jax_stage, guidance_scale=5.0,
                return_trajectory_latents=True)


def test_cfg_and_trajectory_match_jax(plain_cfg):
    tb, jb = plain_cfg
    assert tb.latents.shape == LATENT_SHAPE
    assert tb.latents.dtype == torch.float32
    np.testing.assert_allclose(tb.latents.numpy(), np.asarray(jb.latents),
                               atol=ATOL, rtol=0)
    assert tb.trajectory_latents.shape == (1, STEPS, *LATENT_SHAPE[1:])
    np.testing.assert_allclose(tb.trajectory_latents.numpy(),
                               np.asarray(jb.trajectory_latents), atol=ATOL,
                               rtol=0)
    assert [int(t) for t in tb.trajectory_timesteps] == [
        int(t) for t in jb.trajectory_timesteps]
    torch.testing.assert_close(tb.trajectory_latents[:, -1], tb.latents,
                               atol=0, rtol=0)


@pytest.mark.parametrize("fields", [
    dict(guidance_scale=5.0, extra={"cfg_cache_interval": 2}),
    dict(guidance_scale=5.0, extra={"enable_teacache": True}),
    dict(guidance_scale=5.0, guidance_rescale=0.7),
    dict(guidance_scale=1.0),
], ids=["delta_cfg_cache", "teacache_flag", "guidance_rescale",
        "guidance_scale_1"])
def test_cfg_variants_match_jax(models, jax_stage, plain_cfg, fields):
    tb, jb = _run(models, jax_stage, **fields)
    np.testing.assert_allclose(tb.latents.numpy(), np.asarray(jb.latents),
                               atol=ATOL, rtol=0)
    assert tb.trajectory_latents is None
    # each variant changes the result of the plain CFG run
    assert (tb.latents - plain_cfg[0].latents).abs().max() > 1e-3


def test_per_request_sparsity_overrides_the_args(models, plain_cfg):
    """``batch.VSA_sparsity`` wins over ``FastVideoArgs.VSA_sparsity``: 0.75
    keeps 1 of the 4 padded tiles where the arguments' 0.5 keeps 2. (A fresh
    JAX stage: its jitted step reads the sparsity when it is traced.)"""
    tb, jb = _run(models, None, guidance_scale=5.0, VSA_sparsity=0.75)
    np.testing.assert_allclose(tb.latents.numpy(), np.asarray(jb.latents),
                               atol=ATOL, rtol=0)
    assert (tb.latents - plain_cfg[0].latents).abs().max() > 1e-3
    meta = DenoisingStage._build_attn_metadata(
        ForwardBatch(VSA_sparsity=0.75), FastVideoArgs(VSA_sparsity=0.5))
    assert meta.extra == {"VSA_sparsity": 0.75}
    meta = DenoisingStage._build_attn_metadata(
        ForwardBatch(), FastVideoArgs(VSA_sparsity=0.5))
    assert meta.extra == {"VSA_sparsity": 0.5}
    assert DenoisingStage._build_attn_metadata(ForwardBatch(),
                                               FastVideoArgs()) is None


@pytest.mark.parametrize("extra", [{"y_camera": {}}, {"mouse_cond": [0]},
                                   {"use_embedded_guidance": True},
                                   {"image_path": "a.png"},
                                   {"boundary_ratio": 0.9}])
def test_unported_inputs_raise(models, extra):
    _, tmodel, data = models
    stage = DenoisingStage(tmodel, FlowUniPCMultistepScheduler(),
                           WanT2V480PConfig(), device=torch.device("cpu"))
    batch = ForwardBatch(latents=torch.from_numpy(data["latents"]),
                         prompt_embeds=[torch.from_numpy(data["pos"])],
                         timesteps=[999], extra=extra)
    with pytest.raises(NotImplementedError, match=next(iter(extra))):
        stage.forward(batch, FastVideoArgs())
