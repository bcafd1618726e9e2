"""Port Wan VAE decoder against the JAX AutoencoderKLWan at the tiny test
config, and the chunked decode against the whole-clip decode."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from fastvideo_tpu.configs.models.vaes.wan import WanVAEArchConfig
from fastvideo_tpu.models.vaes.wan import AutoencoderKLWan
from fastvideo_tpu_torch.configs.models.vaes.wan import (
    WanVAEArchConfig as TorchWanVAEArchConfig)
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.vaes.wan import (
    AutoencoderKLWan as TorchAutoencoderKLWan)

sys.path.insert(0, os.path.dirname(__file__))

from utils import TINY_VAE  # noqa: E402

torch.set_num_threads(2)


def numpy_model(build, seed: int):
    """Build a JAX module abstractly and fill its parameters from a numpy
    generator (eager nnx initialisation of the small test models costs
    tens of seconds on the CPU): weights ~ N(0, 1/fan_in), 1-D scales
    near 1 and biases near 0."""
    graphdef, state = nnx.split(nnx.eval_shape(build))
    rng = np.random.default_rng(seed)

    def init(path, leaf):
        shape, name = leaf.shape, str(path[-1])
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1]))
            val = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name in ("gamma", "weight"):
            val = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            val = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(val, jnp.float32)

    state = jax.tree_util.tree_map_with_path(init, state)
    return nnx.merge(graphdef, state)


def _arch(cls):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in TINY_VAE.items()})


def _models():
    jvae = numpy_model(lambda: AutoencoderKLWan(
        _arch(WanVAEArchConfig), param_dtype=jnp.float32, rngs=nnx.Rngs(1)),
        seed=1)
    flat = {".".join(map(str, p)): np.asarray(v.get_value())
            for p, v in nnx.state(jvae, nnx.Param).flat_state()}
    state = {k: v for k, v in state_dict_from_jax(flat).items()
             if not k.startswith(TorchAutoencoderKLWan.ignored_checkpoint_prefixes)}
    tvae = TorchAutoencoderKLWan(_arch(TorchWanVAEArchConfig),
                                 dtype=torch.float32)
    tvae.load_state_dict(state, strict=True)
    return jvae, tvae


def test_decode_matches_jax():
    jvae, tvae = _models()
    z = np.random.default_rng(0).standard_normal((1, 4, 5, 8, 8),
                                                 dtype=np.float32)
    want = np.asarray(nnx.jit(lambda m, x: m.decode(x))(jvae, jnp.asarray(z)))
    with torch.no_grad():
        got = tvae.decode(torch.from_numpy(z))
    assert got.shape == want.shape == (1, 3, 9, 16, 16)
    # fp32 through 14 convs and the mid-block attention, outputs in [-1, 1]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_chunked_decode_equals_whole_clip():
    _, tvae = _models()
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 4, 6, 8, 8), dtype=np.float32))
    with torch.no_grad():
        whole = tvae.decode(z)
        for chunk in (1, 2, 4):
            # the same convs over the same frames, batched differently
            torch.testing.assert_close(tvae.decode(z, chunk_frames=chunk),
                                       whole, atol=1e-5, rtol=1e-5)
