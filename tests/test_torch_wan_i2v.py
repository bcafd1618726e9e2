"""The port's Wan image-to-video path against the JAX package's on the CPU
in fp32: the I2V DiT forward, the CLIP image embeds, the first-frame
condition latent with its mask and the posterior sample under one seed,
and whole I2V generations through VideoGenerator (WanImageToVideoPipeline
with FlowUniPC + CFG, and TurboDiffusion I2V with rCM) on the tiny I2V
checkpoint of tests/utils.py.

Tolerances: the DiT forward as the T2V DiT's test (2e-5 + 1e-4 |JAX|,
fp32 through 2 blocks); the CLIP embeds within 1e-5 + 1e-5 |JAX| (fp32,
one layer); the condition latent within 1e-5 of the largest magnitude
(fp32 encodes that sum in another order); its mask exactly; the
generations' latents within 2e-3 (fp32 through 8 DiT passes, the guidance
scale and UniPC's corrector, as the T2V test), their uint8 frames above
50 dB PSNR and at most one level apart (the golden gate's bar is 35 dB).
"""

import contextlib
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch
from flax import nnx

import fastvideo_tpu  # noqa: F401  (the JAX reference)
from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu.models.dits.wan import WanTransformer3DModel
from fastvideo_tpu_torch.configs.models.dits.wan import (
    WanArchConfig as TorchWanArchConfig)
from fastvideo_tpu_torch.models.dits.wan import (
    WanTransformer3DModel as TorchWanTransformer3DModel)
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_jax_reference import jax_plain_attention  # noqa: E402,F401
from test_torch_wan_dit import jax_params, numpy_model  # noqa: E402
from utils import (TINY_CLIP, TINY_DIT,  # noqa: E402
                   make_tiny_wan_i2v_checkpoint)

torch.set_num_threads(2)

I2V_DIT = dict(TINY_DIT, in_channels=10, image_dim=TINY_CLIP["hidden_size"],
               added_kv_proj_dim=TINY_DIT["num_attention_heads"] *
               TINY_DIT["attention_head_dim"])
GEN = dict(prompt="w1 w2 w3", negative_prompt="w9 w8", height=32, width=48,
           num_frames=5, seed=11, num_inference_steps=4, guidance_scale=5.0,
           save_video=False)
FP32 = dict(precision="fp32", vae_decode_precision="fp32",
            text_encoder_precisions=("fp32",))


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64))**2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def _arch(cls, cfg):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in cfg.items()})


@contextlib.contextmanager
def rbg_prng():
    """JAX's "rbg" PRNG while JAX modules initialise (a tiny checkpoint's,
    and the JAX loader's before it loads), the default after: under
    threefry each nnx initialiser compiles a program of its own for each
    shape, about 30 s on the CPU for the tiny Wan. The initial values are
    random either way: a checkpoint's are written once and both packages
    load them, and the loader overwrites its own."""
    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "rbg")
    try:
        yield
    finally:
        jax.config.update("jax_default_prng_impl", prev)


@pytest.fixture(scope="module")
def i2v_ckpt(tmp_path_factory):
    """The tiny I2V checkpoint, built once."""
    root = tmp_path_factory.mktemp("i2v")
    with rbg_prng():
        return make_tiny_wan_i2v_checkpoint(str(root / "Wan2.1-I2V-tiny"))


def _write_image(tmp_path, h=45, w=61, seed=0) -> str:
    """An RGB PNG of a size other than the generation's, so that the
    LANCZOS resize runs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 4, yy * 5, (xx + yy) * 2], -1) + rng.normal(
        0, 25, (h, w, 3))
    path = str(tmp_path / "first_frame.png")
    PIL.Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path)
    return path


def test_i2v_dit_forward_matches_jax(monkeypatch):
    """257 CLIP tokens through image_embedder in front of the text, split
    off again by the I2V cross-attention (the generations below run the
    tiny CLIP's 5 tokens, where the split at 257 takes the first 252 text
    tokens into the image projections, as in JAX)."""
    n_img, n_txt = 257, 24
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    jmodel = numpy_model(lambda: WanTransformer3DModel(
        _arch(WanArchConfig, I2V_DIT), param_dtype=jnp.float32,
        rngs=nnx.Rngs(0)), seed=2)
    tmodel = TorchWanTransformer3DModel(_arch(TorchWanArchConfig, I2V_DIT),
                                        dtype=torch.float32)
    tmodel.load_state_dict(state_dict_from_jax(jax_params(jmodel)),
                           strict=True)
    assert type(tmodel.blocks[0].attn2).__name__ == "WanI2VCrossAttention"
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 10, 3, 8, 8), dtype=np.float32)
    ctx = rng.standard_normal((1, n_txt, TINY_DIT["text_dim"]),
                              dtype=np.float32)
    img = rng.standard_normal((1, n_img, TINY_CLIP["hidden_size"]),
                              dtype=np.float32)
    t = np.array([640.0], np.float32)
    want = nnx.jit(lambda m, x_, c_, t_, i_: m(
        x_, c_, t_, encoder_hidden_states_image=i_))(
            jmodel, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(t),
            jnp.asarray(img))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(ctx),
                     torch.from_numpy(t),
                     encoder_hidden_states_image=torch.from_numpy(img))
        other = tmodel(torch.from_numpy(x), torch.from_numpy(ctx),
                       torch.from_numpy(t),
                       encoder_hidden_states_image=torch.from_numpy(-img))
    assert got.shape == (1, 4, 3, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    assert not torch.allclose(got, other)  # the image tokens count


def test_image_conditioning_matches_jax(tmp_path, i2v_ckpt,
                                        jax_plain_attention):
    """ImageEncodingStage's CLIP embeds and WanImageVAEEncodingStage's
    image_latent (the mask, then the posterior sample under the seed),
    the port's stages and modules against the JAX ones from one tiny I2V
    checkpoint and one PNG."""
    from fastvideo_tpu.configs.pipelines.wan import (
        WanI2V480PConfig as JaxI2VConfig)
    from fastvideo_tpu.models.loader.component_loader import (
        load_model_component as jax_load)
    from fastvideo_tpu.pipelines.batch import ForwardBatch as JaxBatch
    from fastvideo_tpu.pipelines.stages import image_encoding as jstages

    from fastvideo_tpu_torch.configs.pipelines.wan import WanI2V480PConfig
    from fastvideo_tpu_torch.models.loader.component_loader import (
        load_model_component)
    from fastvideo_tpu_torch.pipelines.batch import ForwardBatch
    from fastvideo_tpu_torch.pipelines.stages import image_encoding as stages

    ckpt = i2v_ckpt
    image = _write_image(tmp_path)
    size = dict(height=32, width=48, num_frames=5, seed=5)
    jcfg, cfg = JaxI2VConfig(), WanI2V480PConfig()
    dev = torch.device("cpu")
    with rbg_prng():  # the JAX loader initialises, then loads
        jclip = jax_load(os.path.join(ckpt, "image_encoder"),
                         precision="fp32")
        jvae = jax_load(os.path.join(ckpt, "vae"), precision="fp32",
                        model_config=jcfg.vae_config)
    clip = load_model_component(os.path.join(ckpt, "image_encoder"),
                                device=dev, precision="fp32")
    vae = load_model_component(os.path.join(ckpt, "vae"), device=dev,
                               precision="fp32", model_config=cfg.vae_config)

    jb = JaxBatch(image_path=image, **size)
    jb.seeds = [5]
    jb = jstages.ImageEncodingStage(jclip).forward(jb, None)
    jb = jstages.WanImageVAEEncodingStage(jvae).forward(jb, None)
    b = ForwardBatch(image_path=image, **size)
    with torch.no_grad():
        b = stages.ImageEncodingStage(clip, device=dev).forward(b, None)
        b = stages.WanImageVAEEncodingStage(vae, device=dev).forward(b, None)

    want_emb = np.asarray(jb.image_embeds[0])
    assert b.image_embeds[0].shape == want_emb.shape == (1, 5, 32)
    np.testing.assert_allclose(b.image_embeds[0].numpy(), want_emb,
                               atol=1e-5, rtol=1e-5)
    want = np.asarray(jb.image_latent)
    got = b.image_latent.numpy()
    assert got.shape == want.shape == (1, 6, 3, 16, 24)
    assert np.array_equal(got[:, :2], want[:, :2])  # the mask
    assert got[:, :2, 0].min() == 1 and got[:, :2, 1:].max() == 0
    scale = np.abs(want[:, 2:]).max()
    assert np.abs(got[:, 2:] - want[:, 2:]).max() <= 1e-5 * scale
    # the posterior sample: another seed draws other noise
    b2 = ForwardBatch(image_path=image, **dict(size, seed=6))
    with torch.no_grad():
        b2 = stages.WanImageVAEEncodingStage(vae, device=dev).forward(b2,
                                                                      None)
    assert not torch.allclose(b2.image_latent[:, 2:], b.image_latent[:, 2:])
    # pil_image: the array itself, as the PNG decodes
    b3 = ForwardBatch(pil_image=np.asarray(PIL.Image.open(image)), **size)
    with torch.no_grad():
        b3 = stages.WanImageVAEEncodingStage(vae, device=dev).forward(b3,
                                                                      None)
    assert torch.equal(b3.image_latent, b.image_latent)
    with pytest.raises(ValueError, match="uint8"):
        stages.load_request_image(ForwardBatch(pil_image=np.zeros((4, 4))))


@pytest.mark.parametrize("variant", ["wan", "turbodiffusion"])
def test_i2v_generation_matches_jax(variant, tmp_path, i2v_ckpt,
                                    monkeypatch, jax_plain_attention):
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    import fastvideo_tpu.parallel as par
    from fastvideo_tpu import VideoGenerator as JaxGenerator

    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.models.schedulers.scheduling_rcm import (
        RCMScheduler)
    from fastvideo_tpu_torch.pipelines.basic.turbodiffusion import (
        turbodiffusion_pipeline as turbo)
    from fastvideo_tpu_torch.pipelines.basic.wan.wan_pipeline import (
        WanImageToVideoPipeline)

    name = ("Wan2.1-I2V-tiny-Diffusers" if variant == "wan" else
            "TurboDiffusion-I2V-tiny")
    ckpt = shutil.copytree(i2v_ckpt, str(tmp_path / name))
    gen_kw = dict(GEN, image_path=_write_image(tmp_path))
    if variant == "turbodiffusion":
        index_path = os.path.join(ckpt, "model_index.json")
        with open(index_path) as fh:
            index = json.load(fh)
        index["_class_name"] = "TurboDiffusionI2VPipeline"
        with open(index_path, "w") as fh:
            json.dump(index, fh)
        gen_kw.update(guidance_scale=1.0)

    par.destroy_mesh()
    with rbg_prng():
        jax_gen = JaxGenerator.from_pretrained(ckpt, num_gpus=1, **FP32)
    want = jax_gen.generate_video(**gen_kw)
    par.destroy_mesh()

    gen = VideoGenerator.from_pretrained(ckpt, device="cpu", **FP32)
    pipe = gen.pipeline
    if variant == "wan":
        assert type(pipe) is WanImageToVideoPipeline
    else:
        assert type(pipe) is turbo.TurboDiffusionI2VPipeline
        assert isinstance(pipe.modules["scheduler"], RCMScheduler)
        assert pipe.modules["scheduler"].sigma_max == 200.0
    names = [type(s).__name__ for s in pipe.stages]
    assert names.index("ImageEncodingStage") < names.index(
        "WanImageVAEEncodingStage") < names.index("TimestepPreparationStage")
    got = gen.generate_video(**gen_kw)
    assert {"ImageEncodingStage", "WanImageVAEEncodingStage"} <= set(
        got["stage_times"])

    lat_want = np.asarray(want["latents"], np.float32)
    lat_got = got["latents"].numpy()
    assert lat_got.shape == lat_want.shape == (1, 4, 3, 16, 24)
    np.testing.assert_allclose(lat_got, lat_want, atol=2e-3, rtol=0)
    f_want, f_got = want["frames"][0], got["frames"][0]
    assert f_got.shape == f_want.shape == (5, 32, 48, 3)
    assert psnr(f_got, f_want) > 50.0
    assert np.abs(f_got.astype(np.int16) - f_want.astype(np.int16)).max() <= 1
