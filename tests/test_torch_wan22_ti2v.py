"""The Wan2.2 family through the port's VideoGenerator against the JAX
package's on the CPU in fp32, on tiny checkpoints this file writes: TI2V
(the Wan2.2-layout VAE of test_torch_wan22_vae.py, the request's image as
latent frame 0), Lucy Edit ([noise | video] on the channels, the control
clip's posterior mode, a timestep per token), and every Wan-family
registry name. The T2V-A14B's experts are test_torch_wan22_experts.py's.

The checkpoints' weights come from numpy (``numpy_model``), not from the
JAX initialisers. The JAX stages encode eagerly (TI2V's first frame,
Lucy's control clip); here the JAX VAE's encode runs under ``nnx.jit``
instead, the same function at a fraction of the compile.

Tolerances: as the I2V and V2V tests, the generations' latents within
2e-3 (fp32 through the DiT passes, the guidance scale and UniPC's
corrector), their uint8 frames above 50 dB PSNR and at most one level
apart.
"""

import json
import os
import shutil
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import fastvideo_tpu  # noqa: F401  (the JAX reference)
from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu.configs.models.encoders.t5 import T5ArchConfig
from fastvideo_tpu.configs.models.vaes.wan import WanVAEArchConfig
from fastvideo_tpu.models.dits.wan import WanTransformer3DModel
from fastvideo_tpu.models.encoders.t5 import T5EncoderModel
from fastvideo_tpu.models.loader.export import (export_torch_layout,
                                                make_word_level_tokenizer,
                                                save_safetensors)
from fastvideo_tpu.models.vaes.wan import AutoencoderKLWan

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_jax_reference import jax_plain_attention  # noqa: E402,F401
from test_torch_wan_dit import numpy_model  # noqa: E402
from test_torch_wan_i2v import FP32, psnr, rbg_prng  # noqa: E402
from test_torch_wan22_vae import TINY_VAE22, _arch  # noqa: E402
from utils import TINY_DIT, TINY_T5, TINY_VAE  # noqa: E402

torch.set_num_threads(2)

GEN = dict(prompt="w1 w2 w3", negative_prompt="w9 w8", height=32, width=48,
           num_frames=5, seed=11, num_inference_steps=3, guidance_scale=5.0,
           save_video=False)


def _component(directory: str, config: dict, module, filename: str) -> None:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as fh:
        json.dump(config, fh)
    save_safetensors(os.path.join(directory, filename),
                     export_torch_layout(module))


def _dit(root: str, name: str, seed: int, **over) -> None:
    cfg = dict(TINY_DIT, **over)
    model = numpy_model(lambda: WanTransformer3DModel(
        _arch(WanArchConfig, cfg), param_dtype=jnp.float32,
        rngs=nnx.Rngs(0)), seed=seed)
    _component(os.path.join(root, name),
               {"_class_name": "WanTransformer3DModel", **cfg}, model,
               "diffusion_pytorch_model.safetensors")


def _vae(root: str, cfg: dict, seed: int) -> None:
    vae = numpy_model(lambda: AutoencoderKLWan(
        _arch(WanVAEArchConfig, cfg), param_dtype=jnp.float32,
        rngs=nnx.Rngs(1)), seed=seed)
    _component(os.path.join(root, "vae"),
               {"_class_name": "AutoencoderKLWan", **cfg}, vae,
               "diffusion_pytorch_model.safetensors")


def tiny_checkpoint(root: str, class_name: str = "WanPipeline",
                    vae_cfg: dict | None = None, in_channels: int = 4,
                    experts: int = 1) -> str:
    """A tiny Wan checkpoint in the diffusers layout: UMT5, its tokenizer,
    the scheduler, the VAE (Wan2.1's tiny one by default) and ``experts``
    DiTs (``transformer``, then ``transformer_2`` with other weights,
    listed in model_index.json)."""
    os.makedirs(root, exist_ok=True)
    index = {"_class_name": class_name, "_diffusers_version": "0.33.0",
             "scheduler": ["diffusers", "UniPCMultistepScheduler"],
             "text_encoder": ["transformers", "UMT5EncoderModel"],
             "tokenizer": ["transformers", "T5TokenizerFast"],
             "transformer": ["diffusers", "WanTransformer3DModel"],
             "vae": ["diffusers", "AutoencoderKLWan"]}
    _dit(root, "transformer", 9, in_channels=in_channels)
    if experts == 2:
        _dit(root, "transformer_2", 21, in_channels=in_channels)
        index["transformer_2"] = ["diffusers", "WanTransformer3DModel"]
    with open(os.path.join(root, "model_index.json"), "w") as fh:
        json.dump(index, fh)
    _vae(root, vae_cfg or TINY_VAE, 8)
    t5 = {k: v for k, v in TINY_T5.items() if k != "model_type"}
    enc = numpy_model(lambda: T5EncoderModel(
        T5ArchConfig(**t5, is_umt5=True), param_dtype=jnp.float32,
        rngs=nnx.Rngs(2)), seed=10)
    _component(os.path.join(root, "text_encoder"),
               {"architectures": ["UMT5EncoderModel"], **TINY_T5}, enc,
               "model.safetensors")
    make_word_level_tokenizer(os.path.join(root, "tokenizer"),
                              TINY_T5["vocab_size"])
    os.makedirs(os.path.join(root, "scheduler"), exist_ok=True)
    with open(os.path.join(root, "scheduler", "scheduler_config.json"),
              "w") as fh:
        json.dump({"_class_name": "UniPCMultistepScheduler",
                   "num_train_timesteps": 1000, "solver_order": 2}, fh)
    return root


class JitEncodeVAE:
    """The JAX VAE with ``encode`` under ``nnx.jit``; its posterior's mean
    (which TI2V reads) and mode (Lucy Edit's "argmax") are the same
    array."""

    def __init__(self, vae):
        self._vae = vae
        self._mean = nnx.jit(lambda m, x: m.encode(x).mean)

    def encode(self, x):
        mean = self._mean(self._vae, x)
        return types.SimpleNamespace(mean=mean, mode=lambda: mean)

    def __getattr__(self, name):
        return getattr(self._vae, name)


def _jax_generator(ckpt: str):
    import fastvideo_tpu.parallel as par
    from fastvideo_tpu import VideoGenerator as JaxGenerator

    par.destroy_mesh()
    with rbg_prng():
        return JaxGenerator.from_pretrained(ckpt, num_gpus=1, **FP32)


def _same(got: dict, want: dict, shape: tuple) -> None:
    lat_want = np.asarray(want["latents"], np.float32)
    lat_got = got["latents"].numpy()
    assert lat_got.shape == lat_want.shape == shape
    np.testing.assert_allclose(lat_got, lat_want, atol=2e-3, rtol=0)
    f_want, f_got = want["frames"][0], got["frames"][0]
    assert f_got.shape == f_want.shape
    assert psnr(f_got, f_want) > 50.0
    assert np.abs(f_got.astype(np.int16) - f_want.astype(np.int16)).max() <= 1


def _image(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (GEN["height"], GEN["width"], 3), np.uint8)


def test_ti2v_generation_matches_jax(tmp_path, monkeypatch,
                                     jax_plain_attention):
    """TI2V with ``pil_image``: latent frame 0 is the image's (normalized)
    latent before, during and after the steps, its tokens at timestep 0;
    frame 0 is the same across seeds (the JAX e2e test's check). With
    ``image_path`` alone JAX's stage sees no ``pil_image`` and runs T2V on
    the 5B; so does the port."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    import fastvideo_tpu.parallel as par

    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.configs.pipelines.wan import (
        Wan2_2_TI2V_5B_Config)
    from fastvideo_tpu_torch.pipelines.basic.wan.wan_pipeline import (
        WanPipeline)

    ckpt = tiny_checkpoint(str(tmp_path / "Wan2.2-TI2V-5B-tiny"),
                           vae_cfg=TINY_VAE22)
    image = _image()
    jax_gen = _jax_generator(ckpt)
    stage = jax_gen.executor.pipeline.denoising_stage
    stage.vae = JitEncodeVAE(stage.vae)
    want = jax_gen.generate_video(**GEN, pil_image=image)
    par.destroy_mesh()

    gen = VideoGenerator.from_pretrained(ckpt, device="cpu", **FP32)
    assert type(gen.pipeline) is WanPipeline
    cfg = gen.fastvideo_args.pipeline_config
    assert type(cfg) is Wan2_2_TI2V_5B_Config and cfg.ti2v_task
    assert gen.pipeline.denoising_stage.vae is gen.pipeline.modules["vae"]
    got = gen.generate_video(**GEN, pil_image=image)
    _same(got, want, (1, 4, 3, 4, 6))
    assert got["frames"][0].shape == (5, 32, 48, 3)

    other = gen.generate_video(**dict(GEN, seed=12), pil_image=image)
    assert torch.equal(other["latents"][:, :, 0], got["latents"][:, :, 0])
    assert not torch.equal(other["latents"][:, :, 1:],
                           got["latents"][:, :, 1:])
    np.testing.assert_array_equal(other["frames"][0][0], got["frames"][0][0])

    path = str(tmp_path / "first.npy")
    np.save(path, image)
    by_path = gen.generate_video(**GEN, image_path=path)
    no_image = gen.generate_video(**GEN)
    assert torch.equal(by_path["latents"], no_image["latents"])
    assert not torch.allclose(by_path["latents"][:, :, 0],
                              got["latents"][:, :, 0])


def test_lucy_edit_generation_matches_jax(tmp_path, monkeypatch,
                                          jax_plain_attention):
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    import fastvideo_tpu.parallel as par

    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.configs.pipelines.wan import LucyEditDevConfig
    from fastvideo_tpu_torch.pipelines.basic.wan.wan_v2v_pipeline import (
        LucyEditPipeline)

    ckpt = tiny_checkpoint(str(tmp_path / "Lucy-Edit-Dev-tiny"),
                           "LucyEditPipeline", TINY_VAE22,
                           in_channels=2 * TINY_VAE22["z_dim"])
    rng = np.random.default_rng(5)
    clip = rng.integers(0, 256, (5, 32, 48, 3), np.uint8)
    kw = dict(GEN, prompt="repaint the sky", video=clip)
    jax_gen = _jax_generator(ckpt)
    stage = jax_gen.executor.pipeline.video_vae_encoding_stage
    stage.vae = JitEncodeVAE(stage.vae)
    want = jax_gen.generate_video(**kw)
    par.destroy_mesh()

    gen = VideoGenerator.from_pretrained(ckpt, device="cpu", **FP32)
    assert type(gen.pipeline) is LucyEditPipeline
    assert type(gen.fastvideo_args.pipeline_config) is LucyEditDevConfig
    assert gen.pipeline.video_vae_encoding_stage.sample_mode == "argmax"
    got = gen.generate_video(**kw)
    _same(got, want, (1, 4, 3, 4, 6))
    with pytest.raises(AssertionError):
        LucyEditDevConfig(ti2v_task=True)


WAN_NAMES = (
    "FastWan2.1-T2V-1.3B-Diffusers", "FastWan2.2-TI2V-5B-Diffusers",
    "FastWan2.2-TI2V-5B-FullAttn-Diffusers", "Wan2.1-T2V-1.3B-Diffusers",
    "Wan2.1-T2V-14B-Diffusers", "Wan2.1-I2V-14B-480P-Diffusers",
    "Wan2.1-I2V-14B-720P-Diffusers", "Wan2.1-V2V-14B",
    "Wan2.2-TI2V-5B-Diffusers", "Wan2.2-T2V-A14B-Diffusers",
    "Wan2.2-I2V-A14B-Diffusers", "Lucy-Edit-Dev", "decart-ai/Lucy-Edit-Dev",
    "TurboDiffusion-T2V-1.3B-480P", "TurboDiffusion-T2V-14B-720P",
    "TurboDiffusion-I2V-A14B-720P", "Wan-AI/Wan2.2-TI2V-5B-Diffusers")


@pytest.mark.parametrize("name", WAN_NAMES)
def test_wan_names_resolve_as_jax(name):
    """Every Wan-family name resolves to the JAX registry's class, none
    raises; FastWan2.2-TI2V-5B takes FastWan's config, without TI2V."""
    from fastvideo_tpu.registry import (
        get_pipeline_config_cls_for_name as jax_config_for)

    from fastvideo_tpu_torch.registry import get_pipeline_config_cls_for_name

    ours = get_pipeline_config_cls_for_name(name)
    assert ours.__name__ == jax_config_for(name).__name__
    cfg = ours()
    for key in ("flow_shift", "ti2v_task", "lucy_edit_task",
                "boundary_ratio", "dmd_denoising_steps"):
        assert getattr(cfg, key) == getattr(jax_config_for(name)(), key), key
    if name.startswith("FastWan2.2"):
        assert not cfg.ti2v_task
