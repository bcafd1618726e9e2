"""The Wan2.2 pieces of the port against the JAX package on the CPU in fp32:
the Wan2.2-layout VAE (``is_residual``, ``patch_size`` 2, a decoder wider
than its encoder) encoding and decoding in one pass, in chunks and as a
stream, its spatially tiled decode, K1's plain version at the VAE's heads
of 640 and 1024 against JAX's ``flash_attention`` (interpret mode), the
DiT with a timestep per token (FLASH_ATTN and VSA's tile-major order), and
the latent grid JAX's latent preparation makes for a Wan2.2 VAE config.

The JAX VAE runs under ``nnx.jit`` (one program per shape: its eager encode
and decode take over a minute on the CPU).

Tolerances: the posterior and the decoded pixels within 1e-5 of the JAX
values relative to their largest magnitude (fp32 convs summed in another
order, as the Wan2.1 VAE tests); the chunked and streamed forms run the
same convs on the same frames: within 1e-5 of the one-pass values. K1's
plain version within 2e-6 + 1e-5 |JAX| (fp32 scores and softmax, sums
over 1024 products in another order). The DiT forward within 2e-5 + 1e-4
|JAX| (fp32 through 2 blocks, as the T2V DiT's test).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import fastvideo_tpu  # noqa: F401  (the JAX reference)
from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu.configs.models.vaes.wan import WanVAEArchConfig
from fastvideo_tpu.models.dits.wan import WanTransformer3DModel
from fastvideo_tpu.models.vaes.wan import AutoencoderKLWan
from fastvideo_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention)
from fastvideo_tpu_torch.configs.models.dits.wan import (
    WanArchConfig as TorchWanArchConfig)
from fastvideo_tpu_torch.configs.models.vaes.wan import (
    WanVAEArchConfig as TorchWanVAEArchConfig)
from fastvideo_tpu_torch.models.dits.wan import (
    WanTransformer3DModel as TorchWanTransformer3DModel)
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.vaes.wan import (
    AutoencoderKLWan as TorchAutoencoderKLWan, pixel_patchify,
    pixel_unpatchify)
from fastvideo_tpu_torch.ops import _build
from fastvideo_tpu_torch.ops import flash_attention as fa

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_jax_reference import jax_plain_attention  # noqa: E402,F401
from test_torch_wan_dit import jax_params, numpy_model  # noqa: E402
from utils import TINY_DIT  # noqa: E402

torch.set_num_threads(2)

# the published Wan2.2 VAE's layout at tiny widths: residual levels, 2x2
# pixel patches (12 channels in and out), a decoder 1.5x as wide as the
# encoder, one time compression (frames 1 + 2k), no output clip
TINY_VAE22 = dict(base_dim=8, decoder_base_dim=12, z_dim=4,
                  dim_mult=[1, 2, 2], num_res_blocks=1, attn_scales=[],
                  temperal_downsample=[False, True], is_residual=True,
                  patch_size=2, in_channels=12, out_channels=12,
                  latents_mean=[0.1, -0.2, 0.3, 0.0],
                  latents_std=[1.5, 0.5, 2.0, 1.0],
                  scale_factor_temporal=2, scale_factor_spatial=4,
                  clip_output=False)


def _arch(cls, cfg):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in cfg.items()})


def vae22_models(cfg=None, seed=3):
    """(JAX VAE, the port's) on the same numpy-drawn weights."""
    cfg = cfg or TINY_VAE22
    jvae = numpy_model(lambda: AutoencoderKLWan(
        _arch(WanVAEArchConfig, cfg), param_dtype=jnp.float32,
        rngs=nnx.Rngs(1)), seed=seed)
    tvae = TorchAutoencoderKLWan(_arch(TorchWanVAEArchConfig, cfg),
                                 dtype=torch.float32)
    tvae.load_state_dict(state_dict_from_jax(jax_params(jvae)), strict=True)
    return jvae, tvae


@pytest.fixture(scope="module")
def vae22():
    return vae22_models()


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err:.3e}, scale {scale:.3e}"


def test_pixel_patchify_matches_jax():
    from fastvideo_tpu.models.vaes.wan import (
        pixel_patchify as jax_patchify, pixel_unpatchify as jax_unpatchify)

    x = np.random.default_rng(0).standard_normal((2, 3, 3, 8, 12)).astype(
        np.float32)
    got = pixel_patchify(torch.from_numpy(x), 2)
    assert got.shape == (2, 12, 3, 4, 6)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_patchify(jnp.asarray(x), 2)))
    back = pixel_unpatchify(got, 2)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_unpatchify(jax_patchify(
            jnp.asarray(x), 2), 2)))
    assert pixel_patchify(torch.from_numpy(x), None) is not None


def test_wan22_vae_encode_matches_jax(vae22, jax_plain_attention):
    """5 frames (1 + 2 chunks of 2): the posterior of the one-pass and the
    chunked encodes against JAX's whole-clip encode; a clip of 4 frames
    (not 1 + 2k) encodes in one pass."""
    jvae, tvae = vae22
    enc = nnx.jit(lambda m, x: (m.encode(x).mean, m.encode(x).logvar))
    for frames in (5, 4):
        x = np.random.default_rng(frames).uniform(
            -1, 1, (1, 3, frames, 32, 32)).astype(np.float32)
        want_mean, want_logvar = enc(jvae, jnp.asarray(x))
        with torch.no_grad():
            chunked = tvae.encode(torch.from_numpy(x))
            whole = tvae.encode(torch.from_numpy(x), chunk_frames=8)
        t_lat = 1 + (frames - 1) // 2
        assert chunked.mean.shape == (1, t_lat, 4, 4, 4)
        for got in (chunked, whole):
            _close(got.mean.numpy(), want_mean)
            _close(got.logvar.numpy(), want_logvar)


def test_wan22_vae_decode_matches_jax(vae22, jax_plain_attention):
    """3 latent frames -> 5 frames of 64x64 pixels (patch 2 unfolded, no
    clip): the one-pass decode, the chunked decode (1 latent frame a
    chunk) and a stream of chunks against JAX's decode."""
    jvae, tvae = vae22
    z = np.random.default_rng(1).standard_normal((1, 4, 3, 8, 8)).astype(
        np.float32)
    want = np.asarray(nnx.jit(lambda m, z_: m.decode(z_))(jvae,
                                                          jnp.asarray(z)))
    assert want.shape == (1, 3, 5, 64, 64)
    zt = torch.from_numpy(z)
    with torch.no_grad():
        _close(tvae.decode(zt).numpy(), want)
        _close(tvae.decode(zt, chunk_frames=1).numpy(), want)
        # the stream: frame 0 first, then one latent frame a chunk, its
        # output still patchified (as JAX's streaming_decode)
        outs, cache = [], None
        for i in range(3):
            out, cache = tvae.streaming_decode(zt[:, :, i:i + 1], cache,
                                               is_first_chunk=i == 0)
            assert out.shape[1] == 12
            outs.append(out)
    _close(pixel_unpatchify(torch.cat(outs, dim=2), 2).numpy(), want)
    jout, _ = jvae.streaming_decode(jnp.asarray(z[:, :, :1]), None,
                                    is_first_chunk=True)
    _close(outs[0].numpy(), jout)


def test_wan22_spatial_tiled_decode_matches_jax(vae22, jax_plain_attention):
    """A 1-frame latent of 12x10 in tiles of 8x8 every 4x4 (3 x 2 tiles,
    edge-padded), blended over the patchified pixel factor of 8."""
    jvae, tvae = vae22
    z = np.random.default_rng(2).standard_normal((1, 4, 1, 12, 10)).astype(
        np.float32)
    kw = dict(tile_latent_min=(8, 8), tile_latent_stride=(4, 4))
    want = np.asarray(nnx.jit(
        lambda m, z_: m.spatial_tiled_decode(z_, **kw))(jvae,
                                                        jnp.asarray(z)))
    with torch.no_grad():
        got = tvae.spatial_tiled_decode(torch.from_numpy(z), **kw)
    assert got.shape == want.shape == (1, 3, 1, 96, 80)
    _close(got.numpy(), want)


@pytest.mark.parametrize("d,dtype", [(640, jnp.float32), (1024, jnp.float32),
                                     (1024, jnp.bfloat16),
                                     (640, jnp.bfloat16)])
def test_k1_plain_at_the_vae_heads_matches_jax(d, dtype):
    """One head of 640 (the encoder's) or 1024 (the decoder's) over 40
    tokens of 2 frames, against the Pallas kernel in interpret mode; bf16
    holds the output to one bf16 ulp of its magnitude."""
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((2, 40, 1, d)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_flash_attention(
        *(jnp.asarray(t, dtype) for t in (q, k, v)))).astype(np.float32)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    before = _build.PLAIN_CALLS[fa.NAME_COLS]
    got = fa.flash_attention(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)))
    assert _build.PLAIN_CALLS[fa.NAME_COLS] == before + 1
    assert got.dtype == tdt and got.shape == (2, 40, 1, d)
    if tdt == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)
    else:
        err = np.abs(got.float().numpy() - want)
        assert err.max() <= 2.0**-7 * np.abs(want).max() + 1e-3


@pytest.mark.parametrize("backend", ["FLASH_ATTN", "VIDEO_SPARSE_ATTN"])
def test_dit_per_token_timesteps_match_jax(backend, monkeypatch,
                                           jax_plain_attention):
    """[B, S] timesteps (TI2V's: 0 on latent frame 0's tokens) through the
    per-token modulation of every block and of the head; under VSA the
    modulation follows the tokens into tile-major order (a 3 x 4 x 6 grid
    on padded 2 x 4 x 4 tiles)."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", backend)
    if backend == "VIDEO_SPARSE_ATTN":
        monkeypatch.setenv("FASTVIDEO_VSA_TILE", "2,4,4")
    jmodel = numpy_model(lambda: WanTransformer3DModel(
        _arch(WanArchConfig, TINY_DIT), param_dtype=jnp.float32,
        rngs=nnx.Rngs(0)), seed=5)
    tmodel = TorchWanTransformer3DModel(_arch(TorchWanArchConfig, TINY_DIT),
                                        dtype=torch.float32)
    tmodel.load_state_dict(state_dict_from_jax(jax_params(jmodel)),
                           strict=True)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 4, 3, 8, 12), dtype=np.float32)
    ctx = rng.standard_normal((1, 7, TINY_DIT["text_dim"]), dtype=np.float32)
    per_frame, seq = 4 * 6, 3 * 4 * 6
    t = np.full((1, seq), 700.0, np.float32)
    t[:, :per_frame] = 0.0
    want = nnx.jit(lambda m, x_, c_, t_: m(x_, c_, t_))(
        jmodel, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(t))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(ctx),
                     torch.from_numpy(t))
        flat = tmodel(torch.from_numpy(x), torch.from_numpy(ctx),
                      torch.full((1,), 700.0))
    assert got.shape == (1, 4, 3, 8, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
    # frames past 0 see t = 700 as the scalar form does; frame 0 does not
    # (self-attention mixes frames, so they differ, but far less)
    assert (got[:, :, 0] - flat[:, :, 0]).abs().max() > 1e-3


@pytest.mark.parametrize("keys,want_hw", [
    # the published Wan2.2 vae/config.json counts the patch in its spatial
    # factor (16): JAX multiplies by the patch again and divides by 32
    (dict(scale_factor_spatial=16, patch_size=2, z_dim=48), (22, 40)),
    # the config chip_smoke.py writes: the VAE's own factor (8) times the
    # patch, the 44 x 80 grid of 704 x 1280
    (dict(patch_size=2, z_dim=48), (44, 80)),
    (dict(), (88, 160)),  # Wan2.1
])
def test_latent_shape_rule_is_jax(keys, want_hw):
    from fastvideo_tpu.configs.models.vaes.wan import WanVAEConfig
    from fastvideo_tpu.pipelines.batch import ForwardBatch as JaxBatch
    from fastvideo_tpu.pipelines.stages.latent_preparation import (
        LatentPreparationStage as JaxStage)

    from fastvideo_tpu_torch.configs.models.vaes.wan import (
        WanVAEConfig as TorchVAEConfig)
    from fastvideo_tpu_torch.pipelines.batch import ForwardBatch
    from fastvideo_tpu_torch.pipelines.stages.latent_preparation import (
        LatentPreparationStage)

    jcfg, tcfg = WanVAEConfig(), TorchVAEConfig()
    jcfg.arch_config.update_from_hf(keys)
    tcfg.arch_config.update_from_hf(keys)
    size = dict(prompt="p", height=704, width=1280, num_frames=121)
    want = JaxStage(vae_config=jcfg).latent_shape(JaxBatch(**size))
    got = LatentPreparationStage(tcfg, device=torch.device("cpu")
                                 ).latent_shape(ForwardBatch(**size))
    assert got == want == (1, keys.get("z_dim", 16), 31, *want_hw)
