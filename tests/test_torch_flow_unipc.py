"""The port's FlowUniPCMultistepScheduler against the JAX scheduler: the
timesteps and sigmas, and every ``step`` output over an 8-step trajectory
fed with the same numpy-seeded model outputs, for solver orders 1 to 3, with
and without ``lower_order_final``, both solver types and both prediction
modes. fp32 latents on both sides; the scalar coefficients are host floats
computed the same way, so only the fused-multiply order differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideo_tpu.models.schedulers.flow_unipc import (
    FlowUniPCMultistepScheduler as JaxScheduler)
from fastvideo_tpu_torch.models.schedulers.flow_unipc import (
    FlowUniPCMultistepScheduler)

ATOL, RTOL = 1e-5, 1e-5
SHAPE = (2, 4, 3, 8, 8)


def _pair(**kw):
    return JaxScheduler(**kw), FlowUniPCMultistepScheduler(**kw)


@pytest.mark.parametrize("steps,shift", [(50, 3.0), (8, 3.0), (3, 8.0),
                                         (4, 1.0)])
def test_timesteps_and_sigmas_equal_jax(steps, shift):
    js, ts = _pair(shift=shift)
    js.set_timesteps(steps)
    ts.set_timesteps(steps)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    np.testing.assert_array_equal(ts.sigmas, js.sigmas)
    assert ts.num_inference_steps == js.num_inference_steps == steps
    assert ts.sigmas.dtype == np.float32 and ts.sigmas[-1] == 0.0


def test_explicit_sigmas_and_dynamic_shift_equal_jax():
    js, ts = _pair(shift=8.0)
    sig = np.array([1.0, 0.757, 0.522], np.float32)
    js.set_timesteps(sigmas=sig, shift=1.0)
    ts.set_timesteps(sigmas=sig, shift=1.0)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    np.testing.assert_array_equal(ts.sigmas, js.sigmas)
    js, ts = _pair(use_dynamic_shifting=True)
    with pytest.raises(ValueError, match="mu"):
        ts.set_timesteps(6)
    js.set_timesteps(6, mu=0.8)
    ts.set_timesteps(6, mu=0.8)
    np.testing.assert_array_equal(ts.sigmas, js.sigmas)


@pytest.mark.parametrize("kw", [
    dict(solver_order=2),
    dict(solver_order=1),
    dict(solver_order=3),
    dict(solver_order=2, lower_order_final=False),
    dict(solver_order=2, solver_type="bh1"),
    dict(solver_order=2, predict_x0=False),
    dict(solver_order=2, disable_corrector=(0, 3)),
    dict(solver_order=2, final_sigmas_type="sigma_min"),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_every_step_matches_jax(kw):
    steps = 8
    js, ts = _pair(shift=3.0, **kw)
    js.set_timesteps(steps)
    ts.set_timesteps(steps)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    orders = []
    for i, t in enumerate(ts.timesteps):
        out = rng.standard_normal(SHAPE).astype(np.float32)
        jx = js.step(jnp.asarray(out), js.timesteps[i], jx).prev_sample
        tx = ts.step(torch.from_numpy(out), t, tx).prev_sample
        assert tx.dtype == torch.float32
        assert ts.step_index == js.step_index == i + 1
        assert ts.this_order == js.this_order
        orders.append(ts.this_order)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL,
                                   rtol=RTOL, err_msg=f"step {i}")
    order = kw["solver_order"]
    assert orders[0] == 1 and max(orders) == order
    if kw.get("lower_order_final", True):
        assert orders[-1] == 1  # the last step drops to order 1
    elif order > 1:
        assert orders[-1] == order


def test_set_timesteps_resets_the_multistep_state():
    ts = FlowUniPCMultistepScheduler(shift=3.0)
    with pytest.raises(ValueError, match="set_timesteps"):
        ts.step(torch.zeros(SHAPE), 999, torch.zeros(SHAPE))
    ts.set_timesteps(4)
    x = torch.ones(SHAPE)
    first = ts.step(x, ts.timesteps[0], x).prev_sample
    ts.step(x, ts.timesteps[1], first)
    assert ts.step_index == 2 and ts.last_sample is not None
    ts.set_timesteps(4)
    assert ts.step_index is None and ts.last_sample is None
    assert ts.model_outputs == [None, None] and ts.lower_order_nums == 0
    again = ts.step(x, ts.timesteps[0], x).prev_sample
    torch.testing.assert_close(again, first, atol=0, rtol=0)


def test_add_noise_matches_jax():
    js, ts = _pair(shift=3.0)
    js.set_timesteps(8)
    ts.set_timesteps(8)
    rng = np.random.default_rng(1)
    x, n = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([ts.timesteps[2], ts.timesteps[6] + 3], np.float32)
    want = js.add_noise(jnp.asarray(x), jnp.asarray(n), jnp.asarray(t))
    got = ts.add_noise(torch.from_numpy(x), torch.from_numpy(n), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
