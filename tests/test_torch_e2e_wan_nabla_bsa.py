"""The port's multistep Wan T2V path with the self-attention on BSA_ATTN or
NABLA_ATTN against the JAX package's: a tiny Wan2.1 T2V checkpoint ->
WanPipeline (4 FlowUniPC steps with classifier-free guidance) -> VAE
decode -> uint8 frames, on the CPU in fp32. BSA runs on a token grid with
no exact (4, 4, 4) tile (zero padding tokens, NaN-ranked pruning), NABLA on
a grid whose token count is a multiple of 64; the Pallas kernels run in
interpret mode on the JAX side, K9a / K9b's plain versions on the port's."""

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

GEN = dict(prompt="w1 w2 w3", negative_prompt="w9 w8", num_frames=9,
           seed=11, num_inference_steps=4, guidance_scale=5.0,
           save_video=False)
FP32 = dict(precision="fp32", vae_decode_precision="fp32",
            text_encoder_precisions=("fp32",))


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64))**2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


# 9 frames at 40x56: token grid (5, 10, 14), 24 padded (4, 4, 4) tiles;
# at 32x64: (5, 8, 16), 640 tokens in 10 blocks of 64
@pytest.mark.parametrize("backend,height,width,kernel", [
    ("BSA_ATTN", 40, 56, "dyn_sparse_qtile_fwd"),
    ("NABLA_ATTN", 32, 64, "dyn_sparse_fwd"),
])
def test_wan_unipc_cfg_with_nabla_and_bsa_matches_jax(backend, height, width,
                                                      kernel, tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", backend)
    import fastvideo_tpu.parallel as par
    from fastvideo_tpu import VideoGenerator as JaxGenerator

    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.ops import _build

    gen_kw = dict(GEN, height=height, width=width)
    ckpt = make_tiny_wan_checkpoint(
        str(tmp_path / "Wan2.1-T2V-tiny-Diffusers"))

    par.destroy_mesh()
    jax_gen = JaxGenerator.from_pretrained(ckpt, num_gpus=1, **FP32)
    want = jax_gen.generate_video(**gen_kw)
    par.destroy_mesh()

    gen = VideoGenerator.from_pretrained(ckpt, device="cpu", **FP32)
    blocks = gen.pipeline.get_module("transformer").blocks
    assert {b.attn1.backend.name for b in blocks} == {backend}
    assert {b.attn2.attn.backend.name for b in blocks} == {"FLASH_ATTN"}
    before = dict(_build.PLAIN_CALLS)
    got = gen.generate_video(**gen_kw)
    # 2 DiT layers x 2 CFG passes x 4 steps through K9a or K9b's plain form
    assert _build.PLAIN_CALLS[kernel] == before[kernel] + 16
    other = "dyn_sparse_fwd" if kernel != "dyn_sparse_fwd" else \
        "dyn_sparse_qtile_fwd"
    assert _build.PLAIN_CALLS[other] == before[other]

    lat_want = np.asarray(want["latents"], np.float32)
    lat_got = got["latents"].numpy()
    assert lat_got.shape == lat_want.shape == (1, 4, 5, height // 2,
                                               width // 2)
    # fp32 on both sides; the bound covers summation-order differences
    # through 8 DiT passes, the guidance scale and UniPC's corrector
    np.testing.assert_allclose(lat_got, lat_want, atol=2e-3, rtol=0)
    f_want, f_got = want["frames"][0], got["frames"][0]
    assert f_got.shape == f_want.shape == (9, height, width, 3)
    assert f_got.dtype == np.uint8
    assert psnr(f_got, f_want) > 50.0
    assert np.abs(f_got.astype(np.int16) - f_want.astype(np.int16)).max() <= 1
