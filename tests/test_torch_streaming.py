"""Port streaming path against the JAX package's: the VAE's streaming
decode (first and later chunks), its frame-split invariant, and a tiny
StreamingVideoGenerator (reset, three steps, finalize) with the same
checkpoint on both sides: uint8 frames within 1 LSB, 3 then 4 frames a
block."""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu.configs.pipelines.wan import (
    WanT2V480PConfig as JaxWanConfig)
from fastvideo_tpu.entrypoints.streaming_generator import (
    StreamingVideoGenerator as JaxStreaming)
from fastvideo_tpu.models.loader.component_loader import (
    PipelineComponentLoader as JaxLoader)
from fastvideo_tpu.models.schedulers.flow_match_euler import (
    FlowMatchEulerDiscreteScheduler as JaxEuler)
from fastvideo_tpu_torch.configs.pipelines.wan import WanT2V480PConfig
from fastvideo_tpu_torch.entrypoints.streaming_generator import (
    StreamingVideoGenerator)
from fastvideo_tpu_torch.models.loader.component_loader import (
    PipelineComponentLoader)
from fastvideo_tpu_torch.models.schedulers.flow_match_euler import (
    FlowMatchEulerDiscreteScheduler)

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_jax_reference import jax_plain_attention  # noqa: E402,F401
from test_torch_wan_dit import numpy_model  # noqa: E402
from utils import (  # noqa: E402
    TINY_DIT, TINY_T5, TINY_VAE, _export_torch_layout, _make_tokenizer,
    _save_safetensors)

torch.set_num_threads(2)

FP32 = dict(precision="fp32", text_encoder_precisions=("fp32",))
MODULES = ("transformer", "vae", "text_encoder", "tokenizer")
# two latent frames a block; the default 21-frame window holds the stream
CAUSAL_DIT = dict(TINY_DIT, num_frames_per_block=2, local_attn_size=-1,
                  sink_size=0)


def write_causal_checkpoint(root: str, seed: int = 0) -> dict:
    """Write a tiny WanCausalDMDPipeline checkpoint in the diffusers layout
    from JAX modules with numpy-seeded weights (``numpy_model``: an eager
    flax init of the VAE alone takes half a minute here). Returns those
    JAX modules by component name."""
    from flax import nnx

    from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
    from fastvideo_tpu.configs.models.encoders.t5 import T5ArchConfig
    from fastvideo_tpu.configs.models.vaes.wan import WanVAEArchConfig
    from fastvideo_tpu.models.dits.causal_wan import (
        CausalWanTransformer3DModel)
    from fastvideo_tpu.models.encoders.t5 import T5EncoderModel
    from fastvideo_tpu.models.vaes.wan import AutoencoderKLWan

    def arch(cls, cfg):
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in cfg.items()})

    t5_kw = {k: v for k, v in TINY_T5.items() if k != "model_type"}
    parts = [
        ("transformer", "CausalWanTransformer3DModel", CAUSAL_DIT,
         lambda: CausalWanTransformer3DModel(
             arch(WanArchConfig, CAUSAL_DIT), param_dtype=jnp.float32,
             rngs=nnx.Rngs(0)), "diffusion_pytorch_model.safetensors"),
        ("vae", "AutoencoderKLWan", TINY_VAE,
         lambda: AutoencoderKLWan(arch(WanVAEArchConfig, TINY_VAE),
                                  param_dtype=jnp.float32, rngs=nnx.Rngs(0)),
         "diffusion_pytorch_model.safetensors"),
        ("text_encoder", "UMT5EncoderModel", TINY_T5,
         lambda: T5EncoderModel(T5ArchConfig(**t5_kw, is_umt5=True),
                                param_dtype=jnp.float32, rngs=nnx.Rngs(0)),
         "model.safetensors"),
    ]
    os.makedirs(root, exist_ok=True)
    modules = {}

    def dump(path, obj):
        with open(path, "w") as fh:
            json.dump(obj, fh)

    dump(os.path.join(root, "model_index.json"), {
        "_class_name": "WanCausalDMDPipeline",
        "_diffusers_version": "0.33.0",
        "scheduler": ["diffusers", "FlowMatchEulerDiscreteScheduler"],
        "text_encoder": ["transformers", "UMT5EncoderModel"],
        "tokenizer": ["transformers", "T5TokenizerFast"],
        "transformer": ["diffusers", "CausalWanTransformer3DModel"],
        "vae": ["diffusers", "AutoencoderKLWan"]})
    for i, (sub, cls_name, cfg, build, fname) in enumerate(parts):
        d = os.path.join(root, sub)
        os.makedirs(d, exist_ok=True)
        key = "architectures" if sub == "text_encoder" else "_class_name"
        dump(os.path.join(d, "config.json"),
             {key: [cls_name] if sub == "text_encoder" else cls_name, **cfg})
        modules[sub] = numpy_model(build, seed + i)
        _save_safetensors(os.path.join(d, fname),
                          _export_torch_layout(modules[sub]))
    _make_tokenizer(os.path.join(root, "tokenizer"), TINY_T5["vocab_size"])
    os.makedirs(os.path.join(root, "scheduler"), exist_ok=True)
    dump(os.path.join(root, "scheduler", "scheduler_config.json"), {
        "_class_name": "FlowMatchEulerDiscreteScheduler",
        "num_train_timesteps": 1000, "shift": 5.0})
    return modules


@pytest.fixture(scope="module")
def modules(tmp_path_factory):
    """The JAX modules as written, and the port's loaded from the
    checkpoint (the JAX loader's eager VAE init would cost half a minute)."""
    ckpt = str(tmp_path_factory.mktemp("causal") / "Wan2.1-T2V-causal-tiny")
    # the blocks build their (unused) self-attention backend from the
    # environment, which other tests may leave set
    mp = pytest.MonkeyPatch()
    mp.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    jax_mods = write_causal_checkpoint(ckpt)
    jax_mods["tokenizer"] = JaxLoader.load_module(
        "tokenizer", os.path.join(ckpt, "tokenizer"),
        JaxWanConfig(model_path=ckpt, **FP32))
    tcfg = WanT2V480PConfig(model_path=ckpt, **FP32)
    try:
        torch_mods = {n: PipelineComponentLoader.load_module(
            n, os.path.join(ckpt, n), tcfg, torch.device("cpu"))
            for n in MODULES}
    finally:
        mp.undo()
    return jax_mods, torch_mods


def _z(seed, t):
    return np.random.default_rng(seed).standard_normal((1, 4, t, 8, 8),
                                                       dtype=np.float32)


def test_streaming_decode_matches_jax(modules):
    jvae, tvae = modules[0]["vae"], modules[1]["vae"]
    jcache = tcache = None
    for i, (z, first) in enumerate(((_z(0, 3), True), (_z(1, 2), False),
                                    (_z(2, 1), False))):
        want, jcache = jvae.streaming_decode(jnp.asarray(z), jcache,
                                             is_first_chunk=first)
        with torch.no_grad():
            got, tcache = tvae.streaming_decode(torch.from_numpy(z), tcache,
                                                is_first_chunk=first)
        assert got.shape == want.shape
        assert got.shape[2] == (5 if i == 0 else 2 * z.shape[2])
        # fp32 decoders: summation order only
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=1e-5)
        assert len(tcache) == len(jcache)


def test_streaming_decode_frame_split(modules):
    """One latent frame at a time through the carried cache gives the
    whole chunk's pixels, for the first chunk and for a later one."""
    vae = modules[1]["vae"]
    z, z2 = torch.from_numpy(_z(0, 3)), torch.from_numpy(_z(1, 2))
    with torch.no_grad():
        whole, cache_w = vae.streaming_decode(z, None, is_first_chunk=True)
        parts, cache = [], None
        for i in range(z.shape[2]):
            px, cache = vae.streaming_decode(z[:, :, i:i + 1], cache,
                                             is_first_chunk=i == 0)
            parts.append(px)
        torch.testing.assert_close(torch.cat(parts, dim=2), whole,
                                   atol=2e-5, rtol=1e-5)
        whole2, _ = vae.streaming_decode(z2, cache_w)
        parts2 = []
        for i in range(z2.shape[2]):
            px, cache = vae.streaming_decode(z2[:, :, i:i + 1], cache)
            parts2.append(px)
        torch.testing.assert_close(torch.cat(parts2, dim=2), whole2,
                                   atol=2e-5, rtol=1e-5)


def _decode_in_fp32(monkeypatch, vae, cast):
    """Make ``vae.streaming_decode`` take its chunk in fp32 whatever the
    generator hands it."""
    orig = vae.streaming_decode
    monkeypatch.setattr(vae, "streaming_decode",
                        lambda z, cache, is_first_chunk=False: orig(
                            cast(z), cache, is_first_chunk=is_first_chunk))


@pytest.mark.parametrize("decode", ["bf16", "fp32"])
def test_streaming_generator_matches_jax(modules, tmp_path, monkeypatch,
                                         decode, jax_plain_attention):
    """Both generators decode in bf16 as shipped. bf16 elementwise
    roundings (RMSNorm, SiLU, residual adds) differ between XLA and
    PyTorch, and through the tiny decoder's layers they move a uint8 pixel
    by up to 4 levels, while the same latents decoded in fp32 agree to
    1e-6. So the frames are held within 1 LSB with the decode in fp32,
    and within 4 LSB (85 % within 1) as shipped; the committed caches,
    the fp32 DiT's keys and values, within fp32 summation order."""
    jm, tm = modules
    if decode == "fp32":
        _decode_in_fp32(monkeypatch, jm["vae"],
                        lambda z: z.astype(jnp.float32))
        _decode_in_fp32(monkeypatch, tm["vae"], lambda z: z.float())
    kw = dict(num_inference_steps=2, height=16, width=16, seed=7)
    jgen = JaxStreaming(jm["transformer"], jm["vae"], jm["text_encoder"],
                        jm["tokenizer"], JaxEuler(shift=5.0),
                        dtype=jnp.float32, **kw)
    tgen = StreamingVideoGenerator(tm["transformer"], tm["vae"],
                                   tm["text_encoder"], tm["tokenizer"],
                                   FlowMatchEulerDiscreteScheduler(shift=5.0),
                                   dtype=torch.float32, device="cpu", **kw)
    jgen.reset("w1 w2 w3 w4")
    out = str(tmp_path / "stream.mp4")
    tgen.reset("w1 w2 w3 w4", output_path=out)
    frames = []
    for _ in range(3):
        want, got = jgen.step(), tgen.step()
        assert got.shape == want.shape and got.dtype == np.uint8
        for tc, jc in zip(tgen.kv_caches, jgen.kv_caches, strict=True):
            for key in ("k", "v"):
                np.testing.assert_allclose(tc[key].numpy(),
                                           np.asarray(jc[key]), atol=2e-5,
                                           rtol=1e-4)
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        if decode == "fp32":
            assert diff.max() <= 1
        else:
            assert diff.max() <= 4 and (diff <= 1).mean() >= 0.85
        frames.append(got.shape[0])
    assert frames == [3, 4, 4]
    assert tgen.finalize() == jgen.finalize() == 11
    if os.path.exists(out + ".npy"):  # no mp4 writer: the buffered frames
        assert np.load(out + ".npy").shape == (11, 16, 16, 3)
    else:
        assert os.path.getsize(out) > 0


def test_streaming_generator_needs_a_card_unless_cpu(modules, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = modules[1]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        StreamingVideoGenerator(tm["transformer"], tm["vae"])
