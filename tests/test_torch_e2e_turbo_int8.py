"""The port's int8 serving paths against the JAX package's, through
``VideoGenerator`` on the CPU in fp32: a tiny TurboDiffusion T2V checkpoint
(rCM, SLA attention, W8A8 DiT linears, "kf_int8" decode convs), and a tiny
FastWan one with all three int8 forms (W8A8 DiT, weight-only UMT5 quantized
at load, int8 decode convs). The VAE is 32 channels wide, so that its convs
take the int8 route."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

import fastvideo_tpu  # noqa: F401  (the JAX reference)
import fastvideo_tpu_torch  # noqa: F401
from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu.configs.models.encoders.t5 import T5ArchConfig
from fastvideo_tpu.configs.models.vaes.wan import WanVAEArchConfig
from fastvideo_tpu.models.dits.wan import WanTransformer3DModel
from fastvideo_tpu.models.encoders.t5 import T5EncoderModel
from fastvideo_tpu.models.vaes.wan import AutoencoderKLWan

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_int8_linear import _arch, numpy_model  # noqa: E402
from utils import (TINY_DIT, TINY_T5, _export_torch_layout,  # noqa: E402
                   _make_tokenizer, _save_safetensors)

torch.set_num_threads(2)

# dims (32, 32, 32): every 3x3 conv but conv_in (4 channels) and conv_out
# (3) is a multiple of 32 wide
INT8_VAE = dict(base_dim=32, z_dim=4, dim_mult=[1, 1], num_res_blocks=1,
                attn_scales=[], temperal_downsample=[True],
                latents_mean=[0.0] * 4, latents_std=[1.0] * 4,
                scale_factor_temporal=2, scale_factor_spatial=2)
# 5 frames at 32x32 -> latents [1, 4, 3, 16, 16] -> token grid (3, 8, 8)
GEN = dict(prompt="w1 w2 w3", height=32, width=32, num_frames=5, seed=2,
           save_video=False)
FP32 = dict(precision="fp32", vae_decode_precision="fp32",
            text_encoder_precisions=("fp32",))


def _write(root: str, class_name: str, seed: int) -> str:
    """A diffusers-format Wan checkpoint; the DiT has the blocks of the
    attention backend set when this is called."""
    os.makedirs(root)

    def dump(path, obj):
        with open(path, "w") as fh:
            json.dump(obj, fh)

    dump(os.path.join(root, "model_index.json"), {"_class_name": class_name})
    parts = [
        ("transformer", {"_class_name": "WanTransformer3DModel", **TINY_DIT},
         lambda: WanTransformer3DModel(_arch(WanArchConfig, TINY_DIT),
                                       rngs=nnx.Rngs(0)),
         "diffusion_pytorch_model.safetensors"),
        ("vae", {"_class_name": "AutoencoderKLWan", **INT8_VAE},
         lambda: AutoencoderKLWan(_arch(WanVAEArchConfig, INT8_VAE),
                                  rngs=nnx.Rngs(0)),
         "diffusion_pytorch_model.safetensors"),
        ("text_encoder", {"architectures": ["UMT5EncoderModel"], **TINY_T5},
         lambda: T5EncoderModel(_arch(T5ArchConfig, TINY_T5, is_umt5=True),
                                rngs=nnx.Rngs(0)),
         "model.safetensors"),
    ]
    for i, (sub, cfg, build, fname) in enumerate(parts):
        os.makedirs(os.path.join(root, sub))
        dump(os.path.join(root, sub, "config.json"), cfg)
        _save_safetensors(os.path.join(root, sub, fname),
                          _export_torch_layout(numpy_model(build, seed + i)))
    _make_tokenizer(os.path.join(root, "tokenizer"), TINY_T5["vocab_size"])
    os.makedirs(os.path.join(root, "scheduler"))
    dump(os.path.join(root, "scheduler", "scheduler_config.json"),
         {"_class_name": "UniPCMultistepScheduler",
          "num_train_timesteps": 1000})
    return root


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64))**2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def _generate_both(ckpt, from_kw, gen_kw, monkeypatch):
    """The JAX package's generation and the port's, on the same checkpoint.

    The JAX loader builds each module with eager random initialisation (a
    compile per parameter shape, half a minute for this VAE) and then
    overwrites every parameter from the checkpoint, strictly. Here it
    builds the module abstractly with zero parameters instead: every module
    of these models holds parameters only, so the loaded model is the
    same."""
    import fastvideo_tpu.models.loader.component_loader as jax_loader
    import fastvideo_tpu.parallel as par
    from fastvideo_tpu import VideoGenerator as JaxGenerator

    from fastvideo_tpu_torch import VideoGenerator

    resolve = jax_loader.resolve_model_cls

    def resolve_abstract(class_name):
        cls, arch_cls = resolve(class_name)

        def build(*args, rngs, **kwargs):
            graphdef, state = nnx.split(nnx.eval_shape(
                lambda: cls(*args, rngs=nnx.Rngs(0), **kwargs)))
            return nnx.merge(graphdef, jax.tree_util.tree_map(
                lambda s: jnp.asarray(np.zeros(s.shape, s.dtype)), state))

        return build, arch_cls

    monkeypatch.setattr(jax_loader, "resolve_model_cls", resolve_abstract)
    par.destroy_mesh()
    want = JaxGenerator.from_pretrained(ckpt, num_gpus=1, **from_kw,
                                        **FP32).generate_video(**gen_kw)
    par.destroy_mesh()
    gen = VideoGenerator.from_pretrained(ckpt, device="cpu", **from_kw,
                                         **FP32)
    return want, gen, gen.generate_video(**gen_kw)


def _compare(want, got, label):
    """Frames PSNR >= 35 dB. The latents are stated beside it: per-token
    int8 quantization turns fp32 summation-order differences into whole
    quantization steps wherever a value sits on a rounding boundary."""
    lat_w = np.asarray(want["latents"], np.float32)
    lat_g = got["latents"].numpy()
    assert lat_g.shape == lat_w.shape
    assert np.isfinite(lat_g).all()
    rel = np.linalg.norm(lat_g - lat_w) / np.linalg.norm(lat_w)
    f_w, f_g = want["frames"][0], got["frames"][0]
    assert f_g.shape == f_w.shape == (5, 32, 32, 3) and f_g.dtype == np.uint8
    p = _psnr(f_g, f_w)
    print(f"{label}: frames PSNR {p:.2f} dB, latents relative L2 error "
          f"{rel:.2e}, max abs {np.abs(lat_g - lat_w).max():.2e}")
    assert p >= 35.0
    assert rel <= 1e-2


def test_turbodiffusion_w8a8_sla_kf_int8_matches_jax(tmp_path, monkeypatch):
    from fastvideo_tpu_torch.layers.quantization import int8
    from fastvideo_tpu_torch.models.schedulers.scheduling_rcm import (
        RCMScheduler)
    from fastvideo_tpu_torch.ops import _build

    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "SLA_ATTN")
    monkeypatch.setenv("FASTVIDEO_VAE_CONV3D", "kf_int8")
    ckpt = _write(str(tmp_path / "TurboDiffusion-T2V-1.3B-tiny"),
                  "TurboDiffusionPipeline", seed=10)
    _build.reset_counts()
    int8.reset_forward_calls()
    want, gen, got = _generate_both(
        ckpt, dict(transformer_quant="int8"),
        dict(GEN, num_inference_steps=4, guidance_scale=1.0), monkeypatch)
    sched = gen.pipeline.modules["scheduler"]
    assert isinstance(sched, RCMScheduler) and sched.sigma_max == 80.0
    assert "DenoisingStage" in got["stage_times"]
    # 4 steps x (2 blocks x 4 W8A8 linears + the patch embedding), no CFG
    assert int8.FORWARD_CALLS["int8_w8a8"] == 4 * 9
    assert _build.PLAIN_CALLS["conv3d_int8"] > 0
    _compare(want, got, "TurboDiffusion W8A8 + SLA + kf_int8")


def test_fastwan_all_int8_forms_match_jax(tmp_path, monkeypatch):
    from fastvideo_tpu_torch.layers.quantization import int8

    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    monkeypatch.setenv("FASTVIDEO_VAE_CONV3D", "kf_int8")
    ckpt = _write(str(tmp_path / "FastWan2.1-T2V-tiny-Diffusers"),
                  "WanPipeline", seed=20)
    int8.reset_forward_calls()
    want, gen, got = _generate_both(
        ckpt, dict(transformer_quant="int8",
                   text_encoder_quant="int8-weight-only", VSA_sparsity=0.5),
        GEN, monkeypatch)
    enc = gen.pipeline.modules["text_encoder"]
    assert sum(isinstance(m, int8.Int8Linear) for m in enc.modules()) == \
        7 * TINY_T5["num_layers"]
    # the prompt and, at the default guidance scale, the negative prompt
    assert int8.FORWARD_CALLS["int8_weight_only"] == \
        2 * 7 * TINY_T5["num_layers"]
    assert "DmdDenoisingStage" in got["stage_times"]
    _compare(want, got, "FastWan W8A8 + weight-only UMT5 + kf_int8")
