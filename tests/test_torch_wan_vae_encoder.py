"""The port's Wan VAE encoder against the JAX AutoencoderKLWan.encode on the
CPU in fp32, its chunked encode against its whole-clip encode, and the
loading of the checkpoint's encoder half.

Tolerances: the posterior's mean and logvar (and std = exp(logvar / 2))
within 1e-5 of the JAX values relative to their largest magnitude: fp32 on
both sides, the same convs summed in another order (XLA's convolutions,
the port's tap-by-tap matmuls). The chunked encode runs the same convs on
the same frames cut into chunks: within 1e-5 of the whole-clip encode,
relative to its largest magnitude.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from flax import nnx

import jax.numpy as jnp
from fastvideo_tpu.configs.models.vaes.wan import WanVAEArchConfig
from fastvideo_tpu.models.vaes.wan import AutoencoderKLWan
from fastvideo_tpu_torch.configs.models.vaes.wan import (
    WanVAEArchConfig as TorchWanVAEArchConfig)
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.vaes.wan import (
    AutoencoderKLWan as TorchAutoencoderKLWan)

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_jax_reference import jax_plain_attention  # noqa: E402,F401
from test_torch_wan_vae import numpy_model  # noqa: E402
from utils import TINY_VAE  # noqa: E402

torch.set_num_threads(2)

# the tiny test VAE (one downsample3d), one with a downsample2d before a
# downsample3d (Wan2.1's first two levels) and one with two downsample3d
# (Wan2.1's 4x time compression, 4-frame chunks), the last with the
# encoder's attention at its second scale
CONFIGS = {
    "tiny": dict(TINY_VAE),
    "2d_3d": dict(TINY_VAE, dim_mult=[1, 2, 2], temperal_downsample=[
        False, True], scale_factor_spatial=4),
    "3d_3d": dict(TINY_VAE, dim_mult=[1, 2, 2], temperal_downsample=[
        True, True], attn_scales=[0.5], scale_factor_temporal=4,
        scale_factor_spatial=4),
}


def _arch(cls, cfg):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in cfg.items()})


def _models(cfg, seed=3):
    jvae = numpy_model(lambda: AutoencoderKLWan(
        _arch(WanVAEArchConfig, cfg), param_dtype=jnp.float32,
        rngs=nnx.Rngs(1)), seed=seed)
    flat = {".".join(map(str, p)): np.asarray(v.get_value())
            for p, v in nnx.state(jvae, nnx.Param).flat_state()}
    tvae = TorchAutoencoderKLWan(_arch(TorchWanVAEArchConfig, cfg),
                                 dtype=torch.float32)
    tvae.load_state_dict(state_dict_from_jax(flat), strict=True)
    return jvae, tvae


def _pixels(frames, size=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (1, 3, frames, size, size)).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * scale, f"max abs err {err:.3e}, scale {scale:.3e}"


@pytest.mark.parametrize("name,frames", [
    ("tiny", 9),      # 1 + 4 chunks of 2
    ("tiny", 8),      # a short last chunk of 1 frame
    ("2d_3d", 7),     # 1 + 3 chunks of 2
    ("3d_3d", 9),     # 1 + 2 chunks of 4
    ("3d_3d", 7),     # 1 + 4 + a short last chunk of 2
])
def test_encode_matches_jax_whole_clip(name, frames, jax_plain_attention):
    cfg = CONFIGS[name]
    jvae, tvae = _models(cfg)
    x = _pixels(frames)
    mean, logvar, std, mode = nnx.jit(lambda m, x_: (
        m.encode(x_).mean, m.encode(x_).logvar, m.encode(x_).std,
        m.encode_latents(x_)))(jvae, jnp.asarray(x))
    want = types.SimpleNamespace(mean=mean, logvar=logvar, std=std)
    with torch.no_grad():
        got = tvae.encode(torch.from_numpy(x))
    ratio = cfg["scale_factor_temporal"]
    t_lat = 1 + (frames - 1) // ratio  # a short last chunk adds none
    assert got.mean.shape == (1, t_lat, 16 // cfg["scale_factor_spatial"],
                              16 // cfg["scale_factor_spatial"],
                              cfg["z_dim"])
    _close(got.mean.numpy(), want.mean)
    _close(got.logvar.numpy(), want.logvar)
    _close(got.std.numpy(), want.std)
    # encode_latents' mode, NCDHW
    with torch.no_grad():
        z = tvae.encode_latents(torch.from_numpy(x))
    _close(z.numpy(), mode)


@pytest.mark.parametrize("name,frames", [("tiny", 9), ("tiny", 8),
                                         ("3d_3d", 13), ("3d_3d", 11)])
def test_chunked_encode_equals_whole_clip(name, frames):
    cfg = CONFIGS[name]
    _, tvae = _models(cfg, seed=4)
    x = torch.from_numpy(_pixels(frames, seed=1))
    ratio = cfg["scale_factor_temporal"]
    with torch.no_grad():
        whole = tvae.encode(x, chunk_frames=frames).parameters
        for chunk in (ratio, 2 * ratio):
            got = tvae.encode(x, chunk_frames=chunk).parameters
            _close(got.numpy(), whole.numpy())
        # the default chunk is scale_factor_temporal frames
        _close(tvae.encode(x).parameters.numpy(), whole.numpy())
        with pytest.raises(ValueError, match="multiple"):
            tvae.encode(x, chunk_frames=ratio + 1)


def test_posterior_clips_logvar_and_samples():
    from fastvideo_tpu_torch.models.vaes.wan import (
        DiagonalGaussianDistribution)

    params = torch.zeros(1, 2, 2, 2, 8)
    params[..., 4:] = torch.tensor([-40.0, -1.0, 1.0, 30.0])
    dist = DiagonalGaussianDistribution(params)
    assert dist.logvar[0, 0, 0, 0].tolist() == [-30.0, -1.0, 1.0, 20.0]
    torch.testing.assert_close(dist.std, torch.exp(0.5 * dist.logvar))
    assert torch.equal(dist.mode(), dist.mean)
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    torch.testing.assert_close(dist.sample(g1), dist.sample(g2))


def _write_vae(root, state, cfg):
    from fastvideo_tpu_torch.models.loader.safetensors_io import save_file

    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "config.json"), "w") as fh:
        json.dump({"_class_name": "AutoencoderKLWan", **cfg}, fh)
    save_file(state, os.path.join(root,
                                  "diffusion_pytorch_model.safetensors"))
    return root


def test_loads_the_encoder_half_strictly(tmp_path):
    """The checkpoint's encoder.* and quant_conv.* load into the encoder; a
    checkpoint without them loads the decoder alone (encode then refuses),
    as the JAX loader accepts one; a partial encoder is refused."""
    from fastvideo_tpu_torch.configs.models.vaes.wan import WanVAEConfig
    from fastvideo_tpu_torch.models.loader.component_loader import (
        load_model_component)

    cfg = CONFIGS["tiny"]
    _, tvae = _models(cfg)
    full = {k: v.contiguous() for k, v in tvae.state_dict().items()}
    kw = dict(device=torch.device("cpu"), precision="fp32",
              model_config=WanVAEConfig())
    vae = load_model_component(_write_vae(str(tmp_path / "full"), full, cfg),
                               **kw)
    assert vae.encoder is not None and vae.quant_conv is not None
    for k, v in vae.state_dict().items():
        assert torch.equal(v, full[k]), k
    x = torch.from_numpy(_pixels(5))
    with torch.no_grad():
        torch.testing.assert_close(vae.encode(x).parameters,
                                   tvae.encode(x).parameters)

    halves = ("encoder.", "quant_conv.")
    dec = {k: v for k, v in full.items() if not k.startswith(halves)}
    vae = load_model_component(_write_vae(str(tmp_path / "dec"), dec, cfg),
                               **kw)
    assert vae.encoder is None and vae.quant_conv is None
    assert set(vae.state_dict()) == set(dec)
    with pytest.raises(RuntimeError, match="without its encoder"):
        vae.encode(x)

    part = dict(full)
    part.pop("encoder.conv_out.bias")
    with pytest.raises(KeyError, match="part of"):
        load_model_component(_write_vae(str(tmp_path / "part"), part, cfg),
                             **kw)
    extra = dict(full, **{"encoder.extra.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="no matching parameter"):
        load_model_component(_write_vae(str(tmp_path / "extra"), extra, cfg),
                             **kw)


def test_wan22_layout_still_raises():
    """The Wan2.2 layout no longer raises: ``is_residual`` builds one
    WanResidualDownBlock a level (the encoder) and WanResidualUpBlocks
    (the decoder); ``patch_size`` 2 folds 2x2 pixels into 12 channels (its
    encode and decode against JAX: test_torch_wan22_vae.py)."""
    from fastvideo_tpu_torch.models.vaes.wan import (WanResidualDownBlock,
                                                     WanResidualUpBlock)

    cfg = _arch(TorchWanVAEArchConfig, dict(
        CONFIGS["tiny"], dim_mult=[1, 2, 2], temperal_downsample=[True, True],
        is_residual=True, patch_size=2, in_channels=12, out_channels=12))
    vae = TorchAutoencoderKLWan(cfg, device="meta")
    assert all(isinstance(b, WanResidualDownBlock)
               for b in vae.encoder.down_blocks)
    assert all(isinstance(b, WanResidualUpBlock)
               for b in vae.decoder.up_blocks)
    assert vae.encoder.conv_in.weight.shape[1] == 12
    assert vae.decoder.conv_out.weight.shape[0] == 12
