"""The port's Wan video-to-video path against the JAX package's on the CPU in
fp32: WanVideoToVideoPipeline (control latent a seeded posterior sample,
``sample`` mode) through VideoGenerator on the tiny V2V checkpoint of
tests/utils.py, the source clip from a ``.npy`` video_path (longer than
the generation: truncated) and from ``extra["video"]`` (shorter: zero
frames at the tail; another size: LANCZOS-resized); and the Lucy Edit
pipeline's construction (its generation is test_torch_wan22_ti2v.py's). The JAX stage's resize branch raises (it calls
``PIL.Image.Image.fromarray``), so where the port resizes, the JAX side is
given the frames that branch means to make (Pillow's LANCZOS of the
uint8 frames, back to [0, 1]) and runs without it.

Tolerances: the VideoVAEEncodingStage's control latent within 1e-5 of its
largest magnitude (fp32 encodes, sums in another order); the generations'
latents within 2e-3 and their uint8 frames above 50 dB PSNR and at most
one level apart, as the I2V test.
"""

import os
import shutil
import sys

import numpy as np
import PIL.Image
import pytest
import torch

import fastvideo_tpu  # noqa: F401  (the JAX reference)

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_jax_reference import jax_plain_attention  # noqa: E402,F401
from test_torch_wan_i2v import FP32, psnr, rbg_prng  # noqa: E402
from utils import (make_tiny_lucy_edit_checkpoint,  # noqa: E402
                   make_tiny_wan_v2v_checkpoint)

torch.set_num_threads(2)

GEN = dict(prompt="repaint the sky purple", height=32, width=48,
           num_frames=9, seed=3, num_inference_steps=3, guidance_scale=1.0,
           save_video=False)


@pytest.fixture(scope="module")
def v2v_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("v2v")
    with rbg_prng():
        return make_tiny_wan_v2v_checkpoint(
            str(root / "Wan2.1-V2V-tiny-Diffusers"))


def _clip(t, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((t, h, w, 3)) * 255).astype(np.uint8)


def _resized_as_jax_means(frames, w, h):
    """The JAX stage's resize branch as it is written, with PIL: [0, 1]
    frames to uint8 (truncating), LANCZOS to (w, h), back to [0, 1]."""
    return np.stack([
        np.asarray(PIL.Image.fromarray(
            (np.clip(fr, 0, 1) * 255).astype(np.uint8)).resize(
                (w, h), PIL.Image.LANCZOS), np.float32) / 255.0
        for fr in frames])


@pytest.mark.parametrize("source", ["npy_truncated", "extra_padded_resized"])
def test_v2v_generation_matches_jax(source, v2v_ckpt, tmp_path, monkeypatch,
                                    jax_plain_attention):
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    import fastvideo_tpu.parallel as par
    from fastvideo_tpu import VideoGenerator as JaxGenerator

    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.pipelines.basic.wan.wan_v2v_pipeline import (
        WanVideoToVideoPipeline)
    from fastvideo_tpu_torch.pipelines.stages.image_encoding import (
        VideoVAEEncodingStage)

    if source == "npy_truncated":
        path = str(tmp_path / "control.npy")
        np.save(path, _clip(13, 32, 48))
        gen_kw = jax_kw = dict(GEN, video_path=path)
    else:
        src = _clip(5, 40, 56, seed=1)
        gen_kw = dict(GEN, video=src)
        jax_kw = dict(GEN, video=_resized_as_jax_means(
            np.asarray(src, np.float32) / 255.0, 48, 32))

    par.destroy_mesh()
    with rbg_prng():
        jax_gen = JaxGenerator.from_pretrained(v2v_ckpt, num_gpus=1, **FP32)
    want = jax_gen.generate_video(**jax_kw)
    par.destroy_mesh()

    gen = VideoGenerator.from_pretrained(v2v_ckpt, device="cpu", **FP32)
    pipe = gen.pipeline
    assert type(pipe) is WanVideoToVideoPipeline
    names = [type(s).__name__ for s in pipe.stages]
    assert names.index("VideoVAEEncodingStage") == names.index(
        "DenoisingStage") - 1
    stage = pipe.video_vae_encoding_stage
    assert isinstance(stage, VideoVAEEncodingStage)
    assert stage.sample_mode == "sample"
    got = gen.generate_video(**gen_kw)

    lat_want = np.asarray(want["latents"], np.float32)
    lat_got = got["latents"].numpy()
    assert lat_got.shape == lat_want.shape == (1, 4, 5, 16, 24)
    np.testing.assert_allclose(lat_got, lat_want, atol=2e-3, rtol=0)
    f_want, f_got = want["frames"][0], got["frames"][0]
    assert f_got.shape == f_want.shape == (9, 32, 48, 3)
    assert psnr(f_got, f_want) > 50.0
    assert np.abs(f_got.astype(np.int16) - f_want.astype(np.int16)).max() <= 1


def test_control_latent_matches_jax(v2v_ckpt):
    """VideoVAEEncodingStage alone, both modes, on a clip that is shorter
    and of another size than the generation (pad and resize), against the
    JAX stage on the same VAE weights."""
    from fastvideo_tpu.configs.pipelines.wan import WanV2VConfig as JaxV2V
    from fastvideo_tpu.models.loader.component_loader import (
        load_model_component as jax_load)
    from fastvideo_tpu.pipelines.batch import ForwardBatch as JaxBatch
    from fastvideo_tpu.pipelines.stages import image_encoding as jstages

    from fastvideo_tpu_torch.configs.pipelines.wan import WanV2VConfig
    from fastvideo_tpu_torch.models.loader.component_loader import (
        load_model_component)
    from fastvideo_tpu_torch.pipelines.batch import ForwardBatch
    from fastvideo_tpu_torch.pipelines.stages import image_encoding as stages

    dev = torch.device("cpu")
    vdir = os.path.join(v2v_ckpt, "vae")
    with rbg_prng():
        jvae = jax_load(vdir, precision="fp32",
                        model_config=JaxV2V().vae_config)
    vae = load_model_component(vdir, device=dev, precision="fp32",
                               model_config=WanV2VConfig().vae_config)
    frames = _clip(6, 24, 40, seed=2).astype(np.float32) / 255.0
    size = dict(height=32, width=48, num_frames=9, seed=4)
    jax_frames = _resized_as_jax_means(frames, 48, 32)
    for mode in ("argmax", "sample"):
        jb = JaxBatch(**size, extra={"video": jax_frames})
        jb.seeds = [4]
        jb = jstages.VideoVAEEncodingStage(jvae, sample_mode=mode).forward(
            jb, None)
        b = ForwardBatch(**size, extra={"video": frames})
        with torch.no_grad():
            b = stages.VideoVAEEncodingStage(vae, sample_mode=mode,
                                             device=dev).forward(b, None)
        want = np.asarray(jb.video_latent)
        got = b.video_latent.numpy()
        assert got.shape == want.shape == (1, 4, 5, 16, 24)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), mode
    with pytest.raises(ValueError, match="sample_mode"):
        stages.VideoVAEEncodingStage(vae, sample_mode="mean", device=dev)
    with pytest.raises(ValueError, match="video_path"):
        stages.VideoVAEEncodingStage(vae, device=dev).load_frames(
            ForwardBatch(**size))


def test_lucy_edit_raises(tmp_path):
    """Lucy Edit is ported: its name gives LucyEditDevConfig and its
    class LucyEditPipeline (the control clip's posterior mode). A
    checkpoint whose name does not give it away builds the class with the
    Wan T2V config, as in JAX (whose generation then feeds the V2V
    channels; the Lucy Edit generation is test_torch_wan22_ti2v.py's)."""
    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.configs.pipelines.wan import (LucyEditDevConfig,
                                                           WanT2V480PConfig)
    from fastvideo_tpu_torch.pipelines.basic.wan.wan_v2v_pipeline import (
        LucyEditPipeline)
    from fastvideo_tpu_torch.pipelines.pipeline_registry import (
        resolve_pipeline_cls)

    ckpt = str(tmp_path / "Lucy-Edit-Dev")
    with rbg_prng():
        make_tiny_lucy_edit_checkpoint(ckpt)
    gen = VideoGenerator.from_pretrained(ckpt, device="cpu")
    assert type(gen.pipeline) is LucyEditPipeline
    assert type(gen.fastvideo_args.pipeline_config) is LucyEditDevConfig
    assert gen.pipeline.video_vae_encoding_stage.sample_mode == "argmax"
    renamed = shutil.copytree(ckpt, str(tmp_path / "Wan2.1-T2V-edit"))
    gen = VideoGenerator.from_pretrained(renamed, device="cpu")
    assert type(gen.pipeline) is LucyEditPipeline
    assert type(gen.fastvideo_args.pipeline_config) is WanT2V480PConfig
    assert resolve_pipeline_cls("LucyEditPipeline") is LucyEditPipeline