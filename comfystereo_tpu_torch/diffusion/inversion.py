"""DDIM inversion with null-text optimisation.

Port of `comfystereo_tpu/diffusion/inversion.py`: VAE-encode the image
(times the bundle's latent scale), run the forward DDIM loop with the
conditional embedding, then per timestep optimise the unconditional
embedding with Adam (lr 1e-2 * (1 - i/100), at most `num_inner_steps`
iterations, early stop at epsilon + i * 2e-5) so that the CFG step
reproduces the inversion trajectory.

The JAX package's scanned and `lax.while_loop` forms become host loops: the
inner loop reads each loss back to decide whether to go on, as the JAX
loop's condition does on the device. Adam is `torch.optim.Adam` with optax's
defaults (betas 0.9 and 0.999, eps 1e-8), built anew for each timestep as
the JAX loop calls `opt.init` per timestep. The gradient flows through the
UNet, through the flash kernel's autograd in every bf16 self-attention
(`kernels/flash_attention.py`). `null_text_optimize_step` enables autograd
itself, so it also optimises when called under `torch.no_grad()`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import schedulers
from .models import DiffusionModel


class InversionResult(NamedTuple):
    latents: torch.Tensor            # [T+1, B, C, H, W] DDIM trajectory
    uncond_embeddings: torch.Tensor  # [T, 1, L, D] per-step optimised embeddings
    image_rec: torch.Tensor          # VAE round-trip reconstruction (NCHW)


def image_to_latent(model: DiffusionModel, image_nchw: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW image -> latents scaled by the bundle's `latent_scale`."""
    return model.vae_encode(image_nchw) * model.latent_scale


def latent_to_image(model: DiffusionModel, latents: torch.Tensor) -> torch.Tensor:
    """Scaled latents -> [-1, 1] NCHW image."""
    return model.vae_decode(latents / model.latent_scale)


def ddim_invert_loop(model: DiffusionModel, sched: schedulers.DiffusionSchedule,
                     latent: torch.Tensor, cond_embeddings: torch.Tensor) -> torch.Tensor:
    """Forward DDIM loop: the whole trajectory [T+1, ...], index 0 the clean
    latent."""
    traj = [latent]
    for t in sched.timesteps[::-1]:  # ascending
        eps = model.unet_apply(traj[-1], int(t), cond_embeddings)
        traj.append(schedulers.ddim_next_step(sched, eps, int(t), traj[-1]))
    return torch.stack(traj, dim=0)


def null_text_optimize_step(model: DiffusionModel, sched: schedulers.DiffusionSchedule,
                            latent_cur: torch.Tensor, latent_prev: torch.Tensor, t: int,
                            uncond: torch.Tensor, cond: torch.Tensor,
                            guidance_scale: float, num_inner_steps: int, lr: float,
                            stop_eps: float):
    """One timestep of null-text optimisation; returns (uncond', latent').

    Adam steps on the unconditional embedding while fewer than
    `num_inner_steps` have run and the loss computed before the latest step
    is >= `stop_eps` (the first test sees 1e9)."""
    with torch.no_grad():
        eps_cond = model.unet_apply(latent_cur, t, cond)
    u = uncond.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([u], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    j, loss_prev = 0, 1e9
    with torch.enable_grad():
        while j < num_inner_steps and loss_prev >= stop_eps:
            eps_u = model.unet_apply(latent_cur, t, u)
            eps = eps_u + guidance_scale * (eps_cond - eps_u)
            prev_rec = schedulers.ddim_step(sched, eps, t, latent_cur)
            loss = torch.mean((prev_rec - latent_prev) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            loss_prev = float(loss.detach())
            j += 1
    u = u.detach()
    # Advance the latent with the optimised embedding under CFG.
    with torch.no_grad():
        eps_u = model.unet_apply(latent_cur, t, u)
        eps = eps_u + guidance_scale * (eps_cond - eps_u)
        latent_next = schedulers.ddim_step(sched, eps, t, latent_cur)
    return u, latent_next


def invert(model: DiffusionModel, image_nchw: torch.Tensor, prompt: str,
           num_ddim_steps: int = 50, guidance_scale: float = 7.5,
           num_inner_steps: int = 10, early_stop_epsilon: float = 1e-5,
           null_text_optimization: bool = True) -> InversionResult:
    """Full inversion: encode, invert, and optimise the null text."""
    sched = schedulers.make_ddim(num_ddim_steps)
    cond = model.text_encode(prompt)
    uncond = model.text_encode("")

    with torch.no_grad():
        latent = image_to_latent(model, image_nchw)
        image_rec = latent_to_image(model, latent)
        traj = ddim_invert_loop(model, sched, latent, cond)

    if not null_text_optimization:
        return InversionResult(traj, torch.stack([uncond] * num_ddim_steps, dim=0), image_rec)

    latent_cur = traj[-1]
    unconds = []
    u = uncond
    for i in range(num_ddim_steps):
        t = int(sched.timesteps[i])
        latent_prev = traj[num_ddim_steps - i - 1]
        # float32 values of the expressions, as the JAX loop passes them
        lr = float(np.float32(1e-2 * (1.0 - i / 100.0)))
        stop = float(np.float32(early_stop_epsilon + i * 2e-5))
        u, latent_cur = null_text_optimize_step(model, sched, latent_cur, latent_prev, t, u,
                                                cond, guidance_scale, num_inner_steps, lr,
                                                stop)
        unconds.append(u)
    return InversionResult(traj, torch.stack(unconds, dim=0), image_rec)
