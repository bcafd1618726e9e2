"""The port's causal (self-forcing) path against the JAX package's: a tiny
WanCausalDMDPipeline checkpoint through VideoGenerator.from_pretrained and
generate_video, 3 blocks of 2 latent frames with 2 flow-match Euler steps
each, in fp32 on the CPU."""

import os
import sys

import numpy as np
import torch

from fastvideo_tpu.models.loader.component_loader import (
    PipelineComponentLoader as JaxLoader)

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_jax_reference import jax_plain_attention  # noqa: E402,F401
from test_torch_streaming import write_causal_checkpoint  # noqa: E402

torch.set_num_threads(2)

# 11 frames at 32x32: latents [1, 4, 6, 16, 16], 64 tokens a frame
GEN = dict(prompt="w1 w2 w3", height=32, width=32, num_frames=11, seed=5,
           num_inference_steps=2, save_video=False)
FP32 = dict(precision="fp32", vae_decode_precision="fp32",
            text_encoder_precisions=("fp32",))


def test_causal_generation_matches_jax(tmp_path, monkeypatch,
                                       jax_plain_attention):
    # the blocks build their (unused) self-attention backend from the
    # environment, which other tests may leave set
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    import fastvideo_tpu.parallel as par
    from fastvideo_tpu import VideoGenerator as JaxGenerator

    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.models.schedulers.flow_match_euler import (
        FlowMatchEulerDiscreteScheduler)
    from fastvideo_tpu_torch.pipelines.basic.wan.wan_pipeline import (
        WanCausalDMDPipeline)
    from fastvideo_tpu_torch.pipelines.pipeline_registry import (
        resolve_pipeline_cls)

    ckpt = str(tmp_path / "Wan2.1-T2V-causal-tiny-Diffusers")
    jax_mods = write_causal_checkpoint(ckpt, seed=3)
    # the JAX side takes its VAE as written (its loader's eager VAE init
    # costs half a minute) and loads every other component
    load = JaxLoader.load_module

    def load_module(name, component_dir, pipeline_config, *args, **kwargs):
        if name != "vae":
            return load(name, component_dir, pipeline_config, *args,
                        **kwargs)
        pipeline_config.vae_config.arch_config = jax_mods["vae"].config
        return jax_mods["vae"]

    monkeypatch.setattr(JaxLoader, "load_module", staticmethod(load_module))
    par.destroy_mesh()
    want = JaxGenerator.from_pretrained(ckpt, num_gpus=1,
                                        **FP32).generate_video(**GEN)
    par.destroy_mesh()

    gen = VideoGenerator.from_pretrained(ckpt, device="cpu", **FP32)
    assert isinstance(gen.pipeline, WanCausalDMDPipeline)
    assert resolve_pipeline_cls("CausalWanPipeline") is WanCausalDMDPipeline
    sched = gen.pipeline.modules["scheduler"]
    assert isinstance(sched, FlowMatchEulerDiscreteScheduler)
    got = gen.generate_video(**GEN)
    # the Wan config's flow_shift 3.0 replaces the pipeline's default 5.0
    assert sched.shift == 3.0
    assert "CausalDenoisingStage" in got["stage_times"]

    lat_want = np.asarray(want["latents"], np.float32)
    lat_got = got["latents"].numpy()
    assert lat_got.shape == lat_want.shape == (1, 4, 6, 16, 16)
    # fp32 on both sides: summation order through 3 blocks x (2 denoise
    # passes + 1 commit pass) of the 2-layer DiT
    np.testing.assert_allclose(lat_got, lat_want, atol=1e-4, rtol=0)
    f_want, f_got = want["frames"][0], got["frames"][0]
    assert f_got.shape == f_want.shape == (11, 32, 32, 3)
    assert f_got.dtype == np.uint8
    diff = np.abs(f_got.astype(np.int16) - f_want.astype(np.int16))
    assert diff.max() <= 1
