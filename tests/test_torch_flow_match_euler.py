"""Port FlowMatchEulerDiscreteScheduler against the JAX scheduler: the
schedules (static and dynamic shift, terminal stretch, Karras ramp, given
sigmas with a shift override), the Euler step in both branches (scalar and
per-token, whose dt has the opposite sign), stochastic sampling, add_noise
and scale_noise. Same numpy inputs on both sides, fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu.models.schedulers.flow_match_euler import (
    FlowMatchEulerDiscreteScheduler as JaxEuler)
from fastvideo_tpu_torch.models.registry import resolve_scheduler_cls
from fastvideo_tpu_torch.models.schedulers.flow_match_euler import (
    FlowMatchEulerDiscreteScheduler)

# the update is one fp32 multiply-add on both sides
ATOL = 1e-6


def _pair(**kw):
    return JaxEuler(**kw), FlowMatchEulerDiscreteScheduler(**kw)


@pytest.mark.parametrize("shift", [3.0, 5.0])
@pytest.mark.parametrize("steps", [3, 4, 50])
def test_schedule_and_steps_match_jax(shift, steps):
    js, ts = _pair(shift=shift)
    np.testing.assert_array_equal(ts.sigmas, js.sigmas)
    js.set_timesteps(steps)
    ts.set_timesteps(steps)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    np.testing.assert_array_equal(ts.sigmas, js.sigmas)
    rng = np.random.default_rng(steps)
    x = rng.standard_normal((1, 4, 3, 8, 8), dtype=np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for t in js.timesteps:
        v = rng.standard_normal(x.shape, dtype=np.float32)
        jx = js.step(jnp.asarray(v), t, jx).prev_sample
        tx = ts.step(torch.from_numpy(v), t, tx).prev_sample
        assert ts.step_index == js.step_index
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL)


def test_per_token_step_matches_jax():
    js, ts = _pair(shift=5.0)
    js.set_timesteps(4)
    ts.set_timesteps(4)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4), dtype=np.float32)
    v = rng.standard_normal((2, 6, 4), dtype=np.float32)
    # per-token timesteps between the schedule's entries, and on one
    tok = np.stack([np.linspace(990, 10, 6), np.full(6, js.timesteps[1])])
    tok = tok.astype(np.float32)
    want = js.step(jnp.asarray(v), js.timesteps[0], jnp.asarray(x),
                   per_token_timesteps=jnp.asarray(tok)).prev_sample
    got = ts.step(torch.from_numpy(v), ts.timesteps[0], torch.from_numpy(x),
                  per_token_timesteps=torch.from_numpy(tok)).prev_sample
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the copied sign: the per-token branch moves against the scalar one
    sig = tok[0, 0] / 1000
    nxt = max(s for s in ts.sigmas if s < sig - 1e-6)
    np.testing.assert_allclose(got[0, 0].numpy(),
                               x[0, 0] + (sig - nxt) * v[0, 0], atol=ATOL)


def test_stochastic_sampling_matches_jax():
    js, ts = _pair(shift=3.0, stochastic_sampling=True)
    js.set_timesteps(3)
    ts.set_timesteps(3)
    rng = np.random.default_rng(2)
    x, v, n = (rng.standard_normal((1, 4, 2, 4, 4), dtype=np.float32)
               for _ in range(3))
    t = js.timesteps[1]
    js.set_begin_index(1)
    ts.set_begin_index(1)
    want = js.step(jnp.asarray(v), t, jnp.asarray(x),
                   noise=jnp.asarray(n)).prev_sample
    got = ts.step(torch.from_numpy(v), t, torch.from_numpy(x),
                  noise=torch.from_numpy(n)).prev_sample
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("kw,set_kw", [
    (dict(shift=3.0, shift_terminal=0.1), dict()),
    (dict(use_dynamic_shifting=True, time_shift_type="exponential"),
     dict(mu=0.8)),
    (dict(use_dynamic_shifting=True, time_shift_type="linear"),
     dict(mu=1.3)),
    (dict(shift=5.0, use_karras_sigmas=True), dict()),
    (dict(shift=8.0), dict(sigmas=np.array([1.0, 0.757, 0.522]),
                           shift=1.0)),
    (dict(shift=8.0), dict(timesteps=np.array([999.0, 500.0, 100.0]))),
], ids=["terminal", "dynamic_exp", "dynamic_linear", "karras",
        "sigmas_shift1", "timesteps"])
def test_schedule_options_match_jax(kw, set_kw):
    js, ts = _pair(**kw)
    steps = None if {"sigmas", "timesteps"} & set(set_kw) else 5
    js.set_timesteps(steps, **set_kw)
    ts.set_timesteps(steps, **set_kw)
    np.testing.assert_allclose(ts.timesteps, js.timesteps, rtol=1e-6)
    np.testing.assert_allclose(ts.sigmas, js.sigmas, rtol=1e-6)
    assert ts.shift == js.shift  # a per-call shift does not stay


def test_add_noise_scale_noise_and_registry():
    js, ts = _pair(shift=5.0)
    js.set_timesteps(4)
    ts.set_timesteps(4)
    rng = np.random.default_rng(3)
    x, n = (rng.standard_normal((2, 4, 3, 4, 4), dtype=np.float32)
            for _ in range(2))
    t = np.array([900.0, 250.0], np.float32)
    np.testing.assert_allclose(
        ts.add_noise(torch.from_numpy(x), torch.from_numpy(n), t).numpy(),
        np.asarray(js.add_noise(jnp.asarray(x), jnp.asarray(n), t)),
        atol=ATOL)
    t1 = js.timesteps[2]
    np.testing.assert_allclose(
        ts.scale_noise(torch.from_numpy(x), t1, torch.from_numpy(n)).numpy(),
        np.asarray(js.scale_noise(jnp.asarray(x), t1, jnp.asarray(n))),
        atol=ATOL)
    assert resolve_scheduler_cls("FlowMatchEulerDiscreteScheduler") is \
        FlowMatchEulerDiscreteScheduler
