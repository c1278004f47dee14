"""Denoising-step helpers (prompt-to-prompt style).

Port of `comfystereo_tpu/diffusion/helpers.py`: the CFG step, the no-CFG
step (turbo/LCM distilled models) and latent initialisation. The
reference's `controller.step_callback` hook is an optional callable.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from . import schedulers
from .models import DiffusionModel


def diffusion_step(model: DiffusionModel, sched: schedulers.DiffusionSchedule,
                   latents: torch.Tensor, context: torch.Tensor, t: int,
                   guidance_scale: float, controller: Optional[Callable] = None,
                   mode=None, stereo_active: bool = False) -> torch.Tensor:
    """One CFG denoising step. context = cat([uncond, cond]) along the
    batch, each repeated to match the latents' batch."""
    scaled = schedulers.scale_model_input(sched, latents, t)
    eps = model.unet_apply(torch.cat([scaled] * 2, dim=0), t, context, mode=mode,
                           stereo_active=stereo_active)
    eps_u, eps_c = eps.chunk(2, dim=0)
    eps = eps_u + guidance_scale * (eps_c - eps_u)
    out = schedulers.ddim_step(sched, eps, t, latents)
    return controller(out) if controller is not None else out


def diffusion_step_no_cfg(model: DiffusionModel, sched: schedulers.DiffusionSchedule,
                          latents: torch.Tensor, context: torch.Tensor, t: int,
                          controller: Optional[Callable] = None, mode=None,
                          stereo_active: bool = False) -> torch.Tensor:
    """Single-pass step for distilled models where CFG is baked in."""
    scaled = schedulers.scale_model_input(sched, latents, t)
    eps = model.unet_apply(scaled, t, context, mode=mode, stereo_active=stereo_active)
    out = schedulers.ddim_step(sched, eps, t, latents)
    return controller(out) if controller is not None else out


def init_latent(latent: Optional[torch.Tensor], generator: Optional[torch.Generator],
                latent_channels: int, height: int, width: int,
                batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw (from `generator`, on the CPU) or expand the initial latent:
    returns (latent [1, C, h/8, w/8], latents [batch_size, C, h/8, w/8])."""
    shape = (1, latent_channels, height // 8, width // 8)
    if latent is None:
        latent = torch.randn(shape, generator=generator)
    latents = latent.expand((batch_size,) + shape[1:])
    return latent, latents
