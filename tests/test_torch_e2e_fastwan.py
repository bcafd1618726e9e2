"""The port's main path against the JAX package's: FastWan checkpoint name
-> WanDMDPipeline (3 DMD steps, VIDEO_SPARSE_ATTN on an exact-tile grid)
-> VAE decode -> uint8 frames, in fp32 on the CPU."""

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

# 9 frames at 64x64 -> latents [1, 4, 5, 32, 32] -> token grid (5, 16, 16),
# which select_vsa_tile tiles exactly with (1, 16, 16)
GEN = dict(prompt="w1 w2 w3", height=64, width=64, num_frames=9, seed=11,
           save_video=False)
FP32 = dict(precision="fp32", vae_decode_precision="fp32",
            text_encoder_precisions=("fp32",))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("fastwan_port")
    mp = pytest.MonkeyPatch()
    mp.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    try:
        yield make_tiny_wan_checkpoint(
            str(root / "FastWan2.1-T2V-tiny-Diffusers"))
    finally:
        mp.undo()


def test_fastwan_dmd_vsa_matches_jax(ckpt, monkeypatch):
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    import fastvideo_tpu.parallel as par
    from fastvideo_tpu import VideoGenerator as JaxGenerator

    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.pipelines.stages.denoising import (
        DmdDenoisingStage)

    par.destroy_mesh()
    jax_gen = JaxGenerator.from_pretrained(ckpt, num_gpus=1, VSA_sparsity=0.5,
                                           **FP32)
    want = jax_gen.generate_video(**GEN)
    par.destroy_mesh()

    gen = VideoGenerator.from_pretrained(ckpt, device="cpu", VSA_sparsity=0.5,
                                         **FP32)
    assert any(isinstance(s, DmdDenoisingStage)
               for s in gen.pipeline.stages)
    got = gen.generate_video(**GEN)

    assert "DmdDenoisingStage" in got["stage_times"]
    lat_want = np.asarray(want["latents"], np.float32)
    lat_got = got["latents"].numpy()
    assert lat_got.shape == lat_want.shape == (1, 4, 5, 32, 32)
    # fp32 on both sides; the bound covers summation-order differences
    # through 3 DiT passes and the VSA top-k
    np.testing.assert_allclose(lat_got, lat_want, atol=1e-3, rtol=0)
    f_want, f_got = want["frames"][0], got["frames"][0]
    assert f_got.shape == f_want.shape == (9, 64, 64, 3)
    assert f_got.dtype == np.uint8
    diff = np.abs(f_got.astype(np.int16) - f_want.astype(np.int16))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


def test_from_pretrained_without_cuda_raises(ckpt, monkeypatch):
    from fastvideo_tpu_torch import VideoGenerator

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        VideoGenerator.from_pretrained(ckpt, VSA_sparsity=0.5)
