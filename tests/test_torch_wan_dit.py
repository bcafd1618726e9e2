"""Port Wan DiT forward against the JAX WanTransformer3DModel at the tiny
test config, with the JAX weights carried over by state_dict_from_jax:
once dense (FLASH_ATTN) and once with VSA on an exact-tile grid."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from fastvideo_tpu.attention.backends.abstract import AttentionMetadata
from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu.forward_context import set_forward_context
from fastvideo_tpu.models.dits.wan import WanTransformer3DModel
from fastvideo_tpu_torch.attention.backends.abstract import (
    AttentionMetadata as TorchAttentionMetadata)
from fastvideo_tpu_torch.configs.models.dits.wan import (
    WanArchConfig as TorchWanArchConfig)
from fastvideo_tpu_torch.forward_context import (
    set_forward_context as torch_forward_context)
from fastvideo_tpu_torch.models.dits.wan import (
    WanTransformer3DModel as TorchWanTransformer3DModel)
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax

sys.path.insert(0, os.path.dirname(__file__))

from utils import TINY_DIT  # noqa: E402

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


# fp32 through 2 blocks: summation-order differences only
ATOL, RTOL = 2e-5, 1e-4
SPARSITY = 0.5


def jax_params(model) -> dict[str, np.ndarray]:
    return {".".join(map(str, path)): np.asarray(var.get_value())
            for path, var in nnx.state(model, nnx.Param).flat_state()}


def _arch(cls):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in TINY_DIT.items()})


@pytest.mark.parametrize("backend,latent_shape", [
    ("FLASH_ATTN", (1, 4, 3, 8, 8)),
    # token grid (5, 16, 16): select_vsa_tile gives exact (1, 16, 16) tiles
    ("VIDEO_SPARSE_ATTN", (1, 4, 5, 32, 32)),
])
def test_dit_forward_matches_jax(backend, latent_shape, monkeypatch):
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", backend)
    jmodel = numpy_model(lambda: WanTransformer3DModel(
        _arch(WanArchConfig), param_dtype=jnp.float32, rngs=nnx.Rngs(0)),
        seed=0)
    tmodel = TorchWanTransformer3DModel(_arch(TorchWanArchConfig),
                                        dtype=torch.float32)
    assert tmodel.vsa_tiled_order == (backend == "VIDEO_SPARSE_ATTN")
    tmodel.load_state_dict(state_dict_from_jax(jax_params(jmodel)),
                           strict=True)

    rng = np.random.default_rng(0)
    x = rng.standard_normal(latent_shape, dtype=np.float32)
    ctx = rng.standard_normal((1, 12, TINY_DIT["text_dim"]),
                              dtype=np.float32)
    t = np.array([757.0], np.float32)
    with set_forward_context(attn_metadata=AttentionMetadata(
            extra={"VSA_sparsity": SPARSITY})):
        want = jmodel(jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(t))
    with torch_forward_context(attn_metadata=TorchAttentionMetadata(
            extra={"VSA_sparsity": SPARSITY})), torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(ctx),
                     torch.from_numpy(t))
    assert got.shape == latent_shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
