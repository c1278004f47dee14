"""Functional diffusion schedulers (DDIM / Euler / PNDM-PLMS).

Port of `comfystereo_tpu/diffusion/schedulers.py`: a frozen schedule of
host constants plus step functions. Timesteps and loop indices are Python
ints (the port's sampling loops run on the host). The coefficients are
computed on the host as numpy float32 scalars, in the JAX package's
expression forms and order, so they round as JAX's eager float32 does (and
do not depend on the host's vectorised `torch.sqrt`, which some CPU builds
round to within an ulp only). Each then becomes a 0-d tensor on the
sample's device: a 0-d tensor on the card divides truly, where a Python or
CPU scalar would be multiplied by its rounded reciprocal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import true_divide


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed noise schedule (immutable, hashable by identity)."""

    num_train_timesteps: int
    alphas_cumprod: np.ndarray          # [T] float32 (host constants)
    final_alpha_cumprod: float
    timesteps: np.ndarray               # [num_inference_steps] descending
    num_inference_steps: int
    sigmas: np.ndarray | None = None    # Euler only

    def step_ratio(self) -> int:
        return self.num_train_timesteps // self.num_inference_steps


_ONE = np.float32(1.0)


def _on(x: np.float32, like: torch.Tensor) -> torch.Tensor:
    """A host float32 scalar as a 0-d float32 tensor on `like`'s device (a
    fill, so no copy from the host and no wait for the card)."""
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def _beta_schedule(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                   beta_end: float = 0.012, kind: str = "scaled_linear"):
    if kind == "scaled_linear":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps, dtype=np.float64) ** 2
    else:
        betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                            dtype=np.float64)
    alphas = 1.0 - betas
    return np.cumprod(alphas).astype(np.float32)


def make_ddim(num_inference_steps: int = 50, num_train_timesteps: int = 1000,
              beta_start: float = 0.00085, beta_end: float = 0.012,
              set_alpha_to_one: bool = False,
              steps_offset: int = 1) -> DiffusionSchedule:
    """DDIM schedule with diffusers-compatible timestep spacing."""
    ac = _beta_schedule(num_train_timesteps, beta_start, beta_end)
    ratio = num_train_timesteps // num_inference_steps
    timesteps = (np.arange(0, num_inference_steps) * ratio).round()[::-1]
    timesteps = (timesteps + steps_offset).clip(0, num_train_timesteps - 1)
    final = 1.0 if set_alpha_to_one else float(ac[0])
    return DiffusionSchedule(
        num_train_timesteps=num_train_timesteps,
        alphas_cumprod=ac, final_alpha_cumprod=final,
        timesteps=timesteps.astype(np.int32),
        num_inference_steps=num_inference_steps)


def _alpha_at(sched: DiffusionSchedule, t) -> np.float32:
    """alphas_cumprod[t] as a host float32; t < 0 -> final_alpha_cumprod."""
    t = int(t)
    if t < 0:
        return np.float32(sched.final_alpha_cumprod)
    return np.float32(sched.alphas_cumprod[min(t, sched.num_train_timesteps - 1)])


def _ddim_transfer(a_t: np.float32, a_to: np.float32, model_output: torch.Tensor,
                   sample: torch.Tensor) -> torch.Tensor:
    """sqrt(a_to) * pred_x0 + sqrt(1 - a_to) * eps, pred_x0 from (a_t, eps)."""
    beta_t = _ONE - a_t
    pred_x0 = ((sample - _on(np.sqrt(beta_t), sample) * model_output)
               / _on(np.sqrt(a_t), sample))
    direction = _on(np.sqrt(_ONE - a_to), sample) * model_output
    return _on(np.sqrt(a_to), sample) * pred_x0 + direction


def ddim_step(sched: DiffusionSchedule, model_output: torch.Tensor,
              t, sample: torch.Tensor, eta: float = 0.0) -> torch.Tensor:
    """One deterministic DDIM denoising step: x_t -> x_{t-ratio}."""
    del eta
    return _ddim_transfer(_alpha_at(sched, t),
                          _alpha_at(sched, int(t) - sched.step_ratio()),
                          model_output, sample)


def ddim_next_step(sched: DiffusionSchedule, model_output: torch.Tensor,
                   t, sample: torch.Tensor) -> torch.Tensor:
    """Inverse DDIM step x_t -> x_{t+ratio} (inversion)."""
    cur_t = min(int(t) - sched.step_ratio(), sched.num_train_timesteps - 1)
    return _ddim_transfer(_alpha_at(sched, cur_t), _alpha_at(sched, t),
                          model_output, sample)


def add_noise(sched: DiffusionSchedule, original: torch.Tensor,
              noise: torch.Tensor, t) -> torch.Tensor:
    a_t = _alpha_at(sched, t)
    return (_on(np.sqrt(a_t), original) * original
            + _on(np.sqrt(_ONE - a_t), original) * noise)


def scale_model_input(sched: DiffusionSchedule, sample: torch.Tensor,
                      t) -> torch.Tensor:
    """DDIM: identity. Euler: divide by sqrt(sigma^2+1)."""
    if sched.sigmas is None:
        return sample
    sigma = np.float32(sched.sigmas[_sigma_index(sched, t)])
    return sample / _on(np.sqrt(sigma * sigma + _ONE), sample)


def make_euler(num_inference_steps: int = 50, num_train_timesteps: int = 1000,
               beta_start: float = 0.00085,
               beta_end: float = 0.012) -> DiffusionSchedule:
    """Euler discrete schedule (karras-free, linspace timesteps)."""
    ac = _beta_schedule(num_train_timesteps, beta_start, beta_end)
    sigmas_full = np.sqrt((1.0 - ac) / ac)
    timesteps = np.linspace(0, num_train_timesteps - 1,
                            num_inference_steps)[::-1].copy()
    sigmas = np.interp(timesteps, np.arange(num_train_timesteps), sigmas_full)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return DiffusionSchedule(
        num_train_timesteps=num_train_timesteps, alphas_cumprod=ac,
        final_alpha_cumprod=float(ac[0]),
        timesteps=timesteps.astype(np.int32),
        num_inference_steps=num_inference_steps, sigmas=sigmas)


def _sigma_index(sched: DiffusionSchedule, t) -> int:
    return int(np.argmin(np.abs(sched.timesteps.astype(np.int64) - int(t))))


def euler_step(sched: DiffusionSchedule, model_output: torch.Tensor,
               t, sample: torch.Tensor) -> torch.Tensor:
    idx = _sigma_index(sched, t)
    sigma = np.float32(sched.sigmas[idx])
    pred_x0 = sample - _on(sigma, sample) * model_output
    derivative = (sample - pred_x0) / _on(sigma, sample)
    dt = np.float32(sched.sigmas[idx + 1]) - sigma
    return sample + derivative * _on(dt, sample)


def pndm_skip_timesteps(sched: DiffusionSchedule, strength: float):
    """Strength-based step skipping for img2img/inpaint: keep the last
    strength fraction."""
    n = sched.num_inference_steps
    start = min(int(n * (1.0 - strength)), n - 1)
    return sched.timesteps[start:]


# ---------------------------------------------------------------------------
# PNDM (PLMS variant, skip_prk_steps=True, what SD inpainting ships with)
# ---------------------------------------------------------------------------

def make_pndm(num_inference_steps: int = 50, num_train_timesteps: int = 1000,
              beta_start: float = 0.00085, beta_end: float = 0.012,
              steps_offset: int = 1) -> DiffusionSchedule:
    """PLMS timestep schedule: ascending stride-ratio timesteps (+offset)
    with the SECOND-highest timestep duplicated, reversed. len(timesteps) =
    steps + 1."""
    ac = _beta_schedule(num_train_timesteps, beta_start, beta_end)
    ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * ratio).round().astype(
        np.int64) + steps_offset
    plms = np.concatenate([ts[:-1], ts[-2:-1], ts[-1:]])[::-1]
    return DiffusionSchedule(
        num_train_timesteps=num_train_timesteps, alphas_cumprod=ac,
        final_alpha_cumprod=float(ac[0]),
        timesteps=plms.astype(np.int32),
        num_inference_steps=num_inference_steps)


@dataclasses.dataclass
class PNDMState:
    """Linear-multistep state of a host-side sampling loop (ets = eps
    history, newest last; cur_sample backs the counter==1 Heun correction)."""

    ets: list = dataclasses.field(default_factory=list)
    cur_sample: Optional[torch.Tensor] = None
    counter: int = 0


def _pndm_prev_sample(sched: DiffusionSchedule, sample, t, prev_t,
                      model_output):
    """The PNDM transfer formula (published form)."""
    a_t = _alpha_at(sched, t)
    a_prev = _alpha_at(sched, prev_t)
    b_t = _ONE - a_t
    b_prev = _ONE - a_prev
    coeff = np.sqrt(a_prev / a_t)
    denom = a_t * np.sqrt(b_prev) + np.sqrt(a_t * b_t * a_prev)
    return (_on(coeff, sample) * sample
            - _on(a_prev - a_t, sample) * model_output / _on(denom, sample))


def _plms_output(counter: int, model_output, e3, e2, e1, e0):
    """The published counter branches: plain eps, the Heun average, then
    2nd-, 3rd- and 4th-order Adams-Bashforth (divided truly on every
    device: the card would multiply by the rounded 1/12 and 1/24)."""
    if counter == 0:
        return model_output
    if counter == 1:
        return true_divide(model_output + e3, 2.0)
    if counter == 2:
        return true_divide(3.0 * e3 - e2, 2.0)
    if counter == 3:
        return true_divide(23.0 * e3 - 16.0 * e2 + 5.0 * e1, 12.0)
    return true_divide(55.0 * e3 - 59.0 * e2 + 37.0 * e1 - 9.0 * e0, 24.0)


def pndm_step(sched: DiffusionSchedule, state: PNDMState,
              model_output: torch.Tensor, t, sample: torch.Tensor
              ) -> Tuple[torch.Tensor, PNDMState]:
    """One PLMS step with list state; returns (prev_sample, new_state)."""
    ratio = sched.step_ratio()
    t = int(t)
    prev_t = t - ratio
    ets = list(state.ets)
    cur_sample = state.cur_sample
    if state.counter != 1:
        ets = ets[-3:] + [model_output]
    else:
        prev_t = t
        t = t + ratio
    if len(ets) == 1 and state.counter == 0:
        mo = model_output
        cur_sample = sample
    elif len(ets) == 1 and state.counter == 1:
        mo = true_divide(model_output + ets[-1], 2.0)
        sample = cur_sample
        cur_sample = None
    else:
        padded = [None] * (4 - len(ets)) + ets
        mo = _plms_output(len(ets), model_output, *padded[::-1])
    prev = _pndm_prev_sample(sched, sample, t, prev_t, mo)
    return prev, PNDMState(ets=ets, cur_sample=cur_sample,
                           counter=state.counter + 1)


def pndm_scan_step(sched: DiffusionSchedule, i, t, ets: torch.Tensor,
                   cur_sample: torch.Tensor, model_output: torch.Tensor,
                   sample: torch.Tensor):
    """PLMS step with every decision derived from the loop position `i`
    (0-based within the possibly strength-truncated timestep list), the
    JAX package's scan form: `ets` is a stacked 4-slot eps history, newest
    last, zeros-initialised; step 0 appends, step 1 re-steps from
    `cur_sample` with the Heun average and appends nothing, later steps
    shift-append. Returns (prev_sample, new_ets, new_cur_sample)."""
    ratio = sched.step_ratio()
    i, t = int(i), int(t)
    new_ets = ets if i == 1 else torch.cat([ets[1:], model_output[None]], dim=0)
    mo = _plms_output(min(max(i, 0), 4), model_output,
                      new_ets[3], new_ets[2], new_ets[1], new_ets[0])
    if i == 1:
        prev = _pndm_prev_sample(sched, cur_sample, t + ratio, t, mo)
    else:
        prev = _pndm_prev_sample(sched, sample, t, t - ratio, mo)
    return prev, new_ets, sample if i == 0 else cur_sample


# ---------------------------------------------------------------------------
# Per-model-type selection + generic stepping
# ---------------------------------------------------------------------------

def make_for_model_type(model_type: str,
                        num_inference_steps: int = 50) -> DiffusionSchedule:
    """SD2.x gets EulerDiscrete, SD1.x/default gets DDIM. (The inpaint
    runner separately uses PNDM: `make_pndm`.)"""
    if model_type == "SD2":
        return make_euler(num_inference_steps)
    return make_ddim(num_inference_steps)


def scheduler_step(sched: DiffusionSchedule, model_output: torch.Tensor,
                   t, sample: torch.Tensor) -> torch.Tensor:
    """Generic single step: Euler when the schedule carries sigmas, DDIM
    otherwise. (PNDM is stateful: use `pndm_step` directly.)"""
    if sched.sigmas is not None:
        return euler_step(sched, model_output, t, sample)
    return ddim_step(sched, model_output, t, sample)


def to_sigma_space(sched: DiffusionSchedule, sample: torch.Tensor, t):
    """Alpha-parameterised latent (what DDIM inversion produces) -> Euler's
    sigma parameterisation: divide by sqrt(alphas_cumprod[t])."""
    return sample / _on(np.sqrt(_alpha_at(sched, t)), sample)
