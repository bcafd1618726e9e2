"""The port's rCM scheduler against the JAX package's: timesteps for 1-4
steps and the SDE steps with their CPU-generator noise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu.models.schedulers.scheduling_rcm import (
    RCMScheduler as JaxRCM)
from fastvideo_tpu_torch.models.schedulers.scheduling_rcm import RCMScheduler

torch.set_num_threads(2)


@pytest.mark.parametrize("steps", [1, 2, 3, 4])
@pytest.mark.parametrize("sigma_max", [80.0, 200.0])
def test_timesteps_match_jax(steps, sigma_max):
    j, t = JaxRCM(sigma_max=sigma_max), RCMScheduler(sigma_max=sigma_max)
    j.set_timesteps(steps)
    t.set_timesteps(steps)
    np.testing.assert_array_equal(t.sigmas, j.sigmas)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    assert len(t.timesteps) == steps
    assert t.init_noise_sigma == j.init_noise_sigma


@pytest.mark.parametrize("steps", [1, 2, 3, 4])
def test_steps_match_jax(steps):
    """The whole trajectory from the same numpy latents and predictions:
    the noise of each step comes from the same seeded CPU generator."""
    rng = np.random.default_rng(steps)
    shape = (1, 4, 3, 8, 8)
    j, t = JaxRCM(), RCMScheduler()
    j.set_timesteps(steps)
    t.set_timesteps(steps)
    xj = xt = rng.standard_normal(shape, dtype=np.float32)
    xj, xt = jnp.asarray(xj), torch.from_numpy(xt)
    for ts_j, ts_t in zip(j.timesteps, t.timesteps, strict=True):
        v = rng.standard_normal(shape, dtype=np.float32)
        xj = j.step(jnp.asarray(v), ts_j, xj).prev_sample
        xt = t.step(torch.from_numpy(v), ts_t, xt).prev_sample
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-6,
                                   rtol=1e-6)
    assert xt.dtype == torch.float32


def test_noise_seed_and_shift():
    """``set_noise_seed`` moves the step noise as in JAX; ``set_shift`` does
    nothing. Nothing in either package sets the seed, so the pipelines draw
    the noise of seed 0 whatever the request's seed."""
    shape = (1, 2, 1, 4, 4)
    x = np.ones(shape, np.float32)
    v = np.zeros(shape, np.float32)
    outs = []
    for seed in (0, 7):
        j, t = JaxRCM(), RCMScheduler()
        for s in (j, t):
            s.set_shift(5.0)
            s.set_noise_seed(seed)
            s.set_timesteps(2)
        want = j.step(jnp.asarray(v), j.timesteps[0], jnp.asarray(x))
        got = t.step(torch.from_numpy(v), t.timesteps[0], torch.from_numpy(x))
        np.testing.assert_allclose(got.prev_sample.numpy(),
                                   np.asarray(want.prev_sample), atol=1e-6)
        outs.append(got.prev_sample)
    assert not torch.equal(outs[0], outs[1])
    assert RCMScheduler()._noise_seed == 0
