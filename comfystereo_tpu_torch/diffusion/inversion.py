"""Latent <-> image helpers of the diffusion pipelines.

Port of part of `comfystereo_tpu/diffusion/inversion.py`: `image_to_latent`
and `latent_to_image`. DDIM inversion and null-text optimisation come with
the Standard-mode slice.
"""
from __future__ import annotations

import torch

from .models import LATENT_SCALE, DiffusionModel


def image_to_latent(model: DiffusionModel, image_nchw: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW image -> scaled latents."""
    return model.vae_encode(image_nchw) * LATENT_SCALE


def latent_to_image(model: DiffusionModel, latents: torch.Tensor) -> torch.Tensor:
    """Scaled latents -> [-1, 1] NCHW image."""
    return model.vae_decode(latents / LATENT_SCALE)
