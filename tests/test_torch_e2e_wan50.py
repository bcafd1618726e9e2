"""The port's multistep Wan T2V path against the JAX package's: a Wan2.1
T2V checkpoint name -> WanPipeline (FlowUniPC steps with classifier-free
guidance on a negative prompt) -> VAE decode -> uint8 frames, on the CPU in
fp32, with VIDEO_SPARSE_ATTN and with SLIDING_TILE_ATTN on a token grid
that has no exact tile (padded (4, 8, 8) tiles)."""

import os
import sys

import numpy as np
import pytest
import torch

import fastvideo_tpu  # noqa: F401  (the JAX reference)
import fastvideo_tpu_torch  # noqa: F401

sys.path.insert(0, os.path.dirname(__file__))

from utils import make_tiny_wan_checkpoint  # noqa: E402

torch.set_num_threads(2)

# F frames at 40x56 -> latents [1, 4, (F+1)/2, 20, 28] -> token grid
# ((F+1)/2, 10, 14): no tile with a multiple of 8 tokens divides it, so
# padded (4, 8, 8) tiles, 2 x 2 x 2 of them at 9 frames and 3 x 2 x 2 at 17
# (where an STA window of 3 tiles no longer spans the time axis)
GEN = dict(prompt="w1 w2 w3", negative_prompt="w9 w8", height=40, width=56,
           seed=11, num_inference_steps=4, guidance_scale=5.0,
           save_video=False)
FP32 = dict(precision="fp32", vae_decode_precision="fp32",
            text_encoder_precisions=("fp32",))


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64))**2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


@pytest.mark.parametrize("backend,frames,kwargs", [
    ("VIDEO_SPARSE_ATTN", 9, dict(VSA_sparsity=0.6)),
    ("SLIDING_TILE_ATTN", 17, {}),
])
def test_wan_unipc_cfg_matches_jax(backend, frames, kwargs, tmp_path,
                                   monkeypatch):
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", backend)
    import fastvideo_tpu.parallel as par
    from fastvideo_tpu import VideoGenerator as JaxGenerator

    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.attention.backends.vsa import resolve_vsa_tile
    from fastvideo_tpu_torch.configs.pipelines.wan import (
        FastWanT2V480PConfig, WanT2V480PConfig)
    from fastvideo_tpu_torch.ops import _build
    from fastvideo_tpu_torch.pipelines.stages.denoising import (
        DenoisingStage, DmdDenoisingStage)

    lat_t = (frames + 1) // 2
    gen_kw = dict(GEN, num_frames=frames)
    assert resolve_vsa_tile((lat_t, 10, 14)) == ((4, 8, 8), False)
    ckpt = make_tiny_wan_checkpoint(
        str(tmp_path / "Wan2.1-T2V-tiny-Diffusers"))

    par.destroy_mesh()
    jax_gen = JaxGenerator.from_pretrained(ckpt, num_gpus=1, **kwargs, **FP32)
    want = jax_gen.generate_video(**gen_kw)
    par.destroy_mesh()

    gen = VideoGenerator.from_pretrained(ckpt, device="cpu", **kwargs, **FP32)
    cfg = gen.fastvideo_args.pipeline_config
    assert isinstance(cfg, WanT2V480PConfig)
    assert not isinstance(cfg, FastWanT2V480PConfig) and cfg.flow_shift == 3.0
    stage = gen.pipeline.denoising_stage
    assert type(stage) is DenoisingStage
    assert not isinstance(stage, DmdDenoisingStage)
    before = _build.PLAIN_CALLS["vsa_sparse_padded_fwd"]
    got = gen.generate_video(**gen_kw)
    # 2 DiT layers x 2 CFG passes x 4 steps through the padded sparse op
    assert _build.PLAIN_CALLS["vsa_sparse_padded_fwd"] == before + 16

    assert "DenoisingStage" in got["stage_times"]
    lat_want = np.asarray(want["latents"], np.float32)
    lat_got = got["latents"].numpy()
    assert lat_got.shape == lat_want.shape == (1, 4, lat_t, 20, 28)
    # fp32 on both sides; the bound covers summation-order differences
    # through 8 DiT passes, the guidance scale and UniPC's corrector
    np.testing.assert_allclose(lat_got, lat_want, atol=2e-3, rtol=0)
    f_want, f_got = want["frames"][0], got["frames"][0]
    assert f_got.shape == f_want.shape == (frames, 40, 56, 3)
    assert f_got.dtype == np.uint8
    assert psnr(f_got, f_want) > 50.0
    assert np.abs(f_got.astype(np.int16) - f_want.astype(np.int16)).max() <= 1


def test_unported_wan_names_raise(tmp_path):
    from fastvideo_tpu_torch import VideoGenerator

    for name in ("Wan2.1-I2V-14B-480P-Diffusers", "Wan2.2-T2V-A14B-Diffusers",
                 "Wan2.1-T2V-14B-Diffusers", "TurboDiffusion-I2V-A14B-720P",
                 "TurboDiffusion-T2V-14B-720P", "Lucy-Edit-Dev"):
        with pytest.raises(NotImplementedError, match="not ported"):
            VideoGenerator.from_pretrained(str(tmp_path / name), device="cpu")
