"""The Wan VAE decoder's int8 convs in chunked decode, the port against the
JAX package: the convs see the JAX package's chunk tensors, so each takes
the same activation scale."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import fastvideo_tpu  # noqa: F401  (the JAX reference)
import fastvideo_tpu_torch  # noqa: F401
from fastvideo_tpu.configs.models.vaes.wan import WanVAEArchConfig
from fastvideo_tpu.models.vaes.wan import AutoencoderKLWan

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_e2e_turbo_int8 import INT8_VAE  # noqa: E402
from test_torch_int8_linear import _arch, numpy_model  # noqa: E402

torch.set_num_threads(2)


def test_chunked_int8_decode_matches_jax(monkeypatch):
    """The decoder's int8 convs see the JAX package's chunk tensors: chunks
    of one latent frame, each temporal conv's cached frames concatenated in
    front of the chunk, one activation scale per chunk tensor."""
    from fastvideo_tpu_torch.configs.models.vaes.wan import (
        WanVAEArchConfig as TorchWanVAEArchConfig)
    from fastvideo_tpu_torch.models.loader.jax_params import (
        state_dict_from_jax)
    from fastvideo_tpu_torch.models.vaes.wan import (
        AutoencoderKLWan as TorchAutoencoderKLWan)
    from fastvideo_tpu_torch.ops import _build

    monkeypatch.setenv("FASTVIDEO_VAE_CONV3D", "kf_int8")
    jvae = numpy_model(lambda: AutoencoderKLWan(
        _arch(WanVAEArchConfig, INT8_VAE), rngs=nnx.Rngs(0)), seed=30)
    tvae = TorchAutoencoderKLWan(_arch(TorchWanVAEArchConfig, INT8_VAE),
                                 dtype=torch.float32)
    flat = {".".join(map(str, p)): np.asarray(v.get_value())
            for p, v in nnx.state(jvae, nnx.Param).flat_state()}
    skip = TorchAutoencoderKLWan.ignored_checkpoint_prefixes
    tvae.load_state_dict({k: v for k, v in state_dict_from_jax(flat).items()
                          if not k.startswith(skip)}, strict=True)
    z = np.random.default_rng(7).standard_normal((1, 4, 4, 8, 8),
                                                 dtype=np.float32)
    want = np.asarray(jvae.decode(jnp.asarray(z), chunk_frames=1))
    before = _build.PLAIN_CALLS["conv3d_int8"]
    with torch.no_grad():
        got = tvae.decode(torch.from_numpy(z), chunk_frames=1).numpy()
    # 11 of the decoder's 3x3 convs are 32 wide on both sides, 4 chunks
    assert _build.PLAIN_CALLS["conv3d_int8"] == before + 11 * 4
    assert got.shape == want.shape == (1, 3, 7, 16, 16)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"chunked kf_int8 decode: relative L2 error {rel:.2e}, max abs "
          f"{np.abs(got - want).max():.2e}")
    assert rel <= 1e-3


@pytest.mark.parametrize("latent", [(21, 60, 104), (21, 60, 106),
                                    (6, 60, 104), (3, 60, 104), (21, 30, 52)])
def test_decode_stage_chunks_as_the_jax_dispatched_decode(latent):
    """The port's DecodingStage cuts the latent frames into the chunks of
    the JAX DecodingStage: one pass up to 7e8 full-resolution elements, else
    ``decode_dispatched``'s chunks (the first frame, then 2 at a time at
    480p). The JAX side runs its own stage and chunk loop over a VAE whose
    chunk programs only record the frames they are given."""
    import types

    import jax

    from fastvideo_tpu.pipelines.stages.decoding import (
        DecodingStage as JaxDecodingStage)

    from fastvideo_tpu_torch.configs.models.vaes.wan import (
        WanVAEArchConfig as TorchWanVAEArchConfig)
    from fastvideo_tpu_torch.pipelines.stages.decoding import (
        dispatched_chunk_frames)

    seen = []

    def chunk_fn(st, zc, *args):
        seen.append(zc.shape[1])
        return jnp.zeros((1, 1, 1, 1, 1)), None

    wide = dict(INT8_VAE, base_dim=96, z_dim=16, latents_mean=[0.0] * 16,
                latents_std=[1.0] * 16, scale_factor_spatial=8,
                scale_factor_temporal=4)
    cfg = _arch(WanVAEArchConfig, wide)
    vae = types.SimpleNamespace(
        config=cfg, decoder=object(), _disp=(chunk_fn, chunk_fn, None))
    vae.decode_dispatched = types.MethodType(
        AutoencoderKLWan.decode_dispatched, vae)
    stage = JaxDecodingStage(vae)
    stage._get_decode_fn = lambda: (
        lambda st, z: seen.append(z.shape[2]) or z, None)
    z = np.zeros((1, 16, *latent), np.float32)
    batch = types.SimpleNamespace(latents=jax.numpy.asarray(z), extra={})
    stage.forward(batch, None)

    t = latent[0]
    chunk = dispatched_chunk_frames(
        torch.empty(1, 16, *latent, device="meta"),
        _arch(TorchWanVAEArchConfig, wide))
    port = ([t] if chunk is None or t <= chunk else
            [1] + [min(chunk, t - s) for s in range(1, t, chunk)])
    assert port == seen
