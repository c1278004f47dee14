"""The port's float32 rounding against a plain numpy float32 evaluation of
the JAX package's expression forms, with no JAX in the loop.

Some CPU builds of PyTorch vectorise float32 `sqrt` as a reciprocal square
root estimate plus a Newton step, off by one ulp in about a fifth of values;
XLA and numpy round it correctly. The warp's gap interpolation and every
scheduler coefficient take square roots, so on such a host the port left
JAX's bits. These tests hold:

* `device.sqrt` bit-equal to numpy's float32 `sqrt`;
* every DDIM, Euler and PNDM step of the port bit-equal to the same
  expression evaluated in numpy float32, operation by operation in JAX's
  order (the coefficients computed once on the host, then applied to the
  tensors), over every timestep the schedules hold.
"""
import numpy as np
import pytest
import torch

from comfystereo_tpu_torch import device as tdevice
from comfystereo_tpu_torch.diffusion import schedulers as tsched

ONE = np.float32(1.0)
SHAPE = (2, 4, 8, 8)


def _pair(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(SHAPE).astype(np.float32),
            rng.standard_normal(SHAPE).astype(np.float32))


def _alpha(sched, t):
    return (np.float32(sched.final_alpha_cumprod) if t < 0 else
            np.float32(sched.alphas_cumprod[min(t, sched.num_train_timesteps - 1)]))


def _ddim_np(a_t, a_to, eps, x):
    """JAX's `ddim_step` / `ddim_next_step` body in numpy float32."""
    beta_t = ONE - a_t
    pred_x0 = (x - np.sqrt(beta_t) * eps) / np.sqrt(a_t)
    direction = np.sqrt(ONE - a_to) * eps
    return np.sqrt(a_to) * pred_x0 + direction


def _pndm_prev_np(a_t, a_prev, x, eps):
    """JAX's `_pndm_prev_sample` in numpy float32."""
    b_t, b_prev = ONE - a_t, ONE - a_prev
    coeff = np.sqrt(a_prev / a_t)
    denom = a_t * np.sqrt(b_prev) + np.sqrt(a_t * b_t * a_prev)
    return coeff * x - (a_prev - a_t) * eps / denom


def _plms_np(i, eps, e3, e2, e1, e0):
    """The counter branches of JAX's `pndm_scan_step`, in numpy float32."""
    two, three, twelve, twentyfour = (np.float32(v) for v in (2, 3, 12, 24))
    if i == 0:
        return eps
    if i == 1:
        return (eps + e3) / two
    if i == 2:
        return (three * e3 - e2) / two
    if i == 3:
        return (np.float32(23) * e3 - np.float32(16) * e2
                + np.float32(5) * e1) / twelve
    return (np.float32(55) * e3 - np.float32(59) * e2 + np.float32(37) * e1
            - np.float32(9) * e0) / twentyfour


def _eq(port, want):
    np.testing.assert_array_equal(port.numpy(), np.asarray(want, np.float32))


def test_sqrt_is_correctly_rounded():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.random(100_000, dtype=np.float32),
        rng.random(1_000, dtype=np.float32) * np.float32(1e6),
        np.array([0.0, 1e-45, 1e-38, 0.25, 1.0, 2.0, 3.4e38], np.float32)])
    got = tdevice.sqrt(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.sqrt(x))
    np.testing.assert_array_equal(
        got.numpy(), np.sqrt(x.astype(np.float64)).astype(np.float32))


@pytest.mark.parametrize("steps", [10, 50])
def test_ddim_steps_bit_equal_to_numpy_float32(steps):
    sched = tsched.make_ddim(steps)
    ratio = sched.step_ratio()
    x, e = _pair(steps)
    xt, et = torch.from_numpy(x), torch.from_numpy(e)
    for t in [int(v) for v in sched.timesteps] + [0, 999]:
        _eq(tsched.ddim_step(sched, et, t, xt),
            _ddim_np(_alpha(sched, t), _alpha(sched, t - ratio), e, x))
        cur = min(t - ratio, sched.num_train_timesteps - 1)
        _eq(tsched.ddim_next_step(sched, et, t, xt),
            _ddim_np(_alpha(sched, cur), _alpha(sched, t), e, x))
        a_t = _alpha(sched, t)
        _eq(tsched.add_noise(sched, xt, et, t),
            np.sqrt(a_t) * x + np.sqrt(ONE - a_t) * e)
        _eq(tsched.to_sigma_space(sched, xt, t), x / np.sqrt(a_t))
    _eq(tsched.add_noise(sched, xt, et, -1),
        np.sqrt(_alpha(sched, -1)) * x + np.sqrt(ONE - _alpha(sched, -1)) * e)


def test_euler_steps_bit_equal_to_numpy_float32():
    sched = tsched.make_euler(20)
    x, e = _pair(1)
    xt, et = torch.from_numpy(x), torch.from_numpy(e)
    for idx, t in enumerate(int(v) for v in sched.timesteps):
        sigma = np.float32(sched.sigmas[idx])
        _eq(tsched.scale_model_input(sched, xt, t), x / np.sqrt(sigma * sigma + ONE))
        pred_x0 = x - sigma * e
        dt = np.float32(sched.sigmas[idx + 1]) - sigma
        _eq(tsched.euler_step(sched, et, t, xt), x + (x - pred_x0) / sigma * dt)


def test_pndm_transfer_bit_equal_to_numpy_float32():
    """Every (t, prev_t) pair a PLMS loop asks for, the Heun re-step's
    (t + ratio, t) included, and the final step to t < 0."""
    for steps in (20, 50):
        sched = tsched.make_pndm(steps)
        ratio = sched.step_ratio()
        x, e = _pair(steps)
        xt, et = torch.from_numpy(x), torch.from_numpy(e)
        for t in sorted({int(v) for v in sched.timesteps}):
            for t_from, t_to in ((t, t - ratio), (t + ratio, t)):
                _eq(tsched._pndm_prev_sample(sched, xt, t_from, t_to, et),
                    _pndm_prev_np(_alpha(sched, t_from), _alpha(sched, t_to), x, e))


def test_pndm_scan_step_bit_equal_to_numpy_float32():
    """Six steps of the scan form through the node's strength-truncated
    schedule: the history, the Heun re-step and the Adams-Bashforth orders
    2-4, each bit-equal to JAX's `pndm_scan_step` evaluated in numpy
    float32 one operation at a time."""
    sched = tsched.make_pndm(20)
    ratio = sched.step_ratio()
    ts = [int(v) for v in tsched.pndm_skip_timesteps(sched, 0.6)]
    rng = np.random.default_rng(0)
    sample = rng.standard_normal(SHAPE).astype(np.float32)
    ets = np.zeros((4,) + SHAPE, np.float32)
    cur = np.zeros(SHAPE, np.float32)
    port = (torch.from_numpy(sample), torch.from_numpy(ets), torch.from_numpy(cur))
    for i in range(6):
        eps = rng.standard_normal(SHAPE).astype(np.float32)
        t = ts[i]
        new_ets = ets if i == 1 else np.concatenate([ets[1:], eps[None]])
        mo = _plms_np(min(i, 4), eps, new_ets[3], new_ets[2], new_ets[1], new_ets[0])
        if i == 1:
            prev = _pndm_prev_np(_alpha(sched, t + ratio), _alpha(sched, t), cur, mo)
        else:
            prev = _pndm_prev_np(_alpha(sched, t), _alpha(sched, t - ratio), sample, mo)
        new_cur = sample if i == 0 else cur
        got = tsched.pndm_scan_step(sched, i, t, port[1], port[2],
                                    torch.from_numpy(eps), port[0])
        for a, b in zip(got, (prev, new_ets, new_cur)):
            _eq(a, b)
        sample, ets, cur, port = prev, new_ets, new_cur, got
