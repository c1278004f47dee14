"""Latent-space stereo shift (the StereoDiffusion method).

Port of `comfystereo_tpu/diffusion/stereo_latent.py`: a per-pixel
depth-scaled shift of [B, C, H, W] latents with swipe-order z-ordering,
written as a deterministic scatter-min (positive shift) or scatter-max
(negative shift) of source columns (`ops/fills.scatter_min_w` and
`scatter_max_w`), then a gather of the winning columns. The offset is
monotone in depth (depth^exp is non-negative and increasing), so "first in
swipe order wins" is "min (or max) source column wins".
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops import fills


def _norm_depth01(depth: torch.Tensor) -> torch.Tensor:
    """Per-image min/max normalisation over the last two axes (0 where the
    depth is flat)."""
    dmin = depth.amin(dim=(-2, -1), keepdim=True)
    dmax = depth.amax(dim=(-2, -1), keepdim=True)
    rng = dmax - dmin
    return torch.where(rng > 1e-7, (depth - dmin) / torch.clamp(rng, min=1e-7), 0.0)


def _shift_one(images: torch.Tensor, norm_depth: torch.Tensor,
               scale_factor: float, exponent: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift [B, C, H, W] by trunc(depth^exp * scale) columns, z-ordered in
    swipe order. Returns (shifted [B, C, H, W], filled mask [B, H, W])."""
    b, c, h, w = images.shape
    scale_px = (scale_factor / 100.0) * w
    cols = torch.arange(w, dtype=torch.int32, device=images.device)
    dv = torch.pow(norm_depth, exponent)
    col_d = cols + torch.trunc(dv * scale_px).to(torch.int32)
    valid = (col_d >= 0) & (col_d < w)
    src_cols = cols.expand(norm_depth.shape)
    if scale_px < 0:
        winner = fills.scatter_max_w(col_d, src_cols, valid, w, -1)
        hit = winner >= 0
    else:
        winner = fills.scatter_min_w(col_d, src_cols, valid, w, 2 ** 30)
        hit = winner < 2 ** 30
    wc = torch.clamp(winner, 0, w - 1).long()
    gathered = torch.gather(images, -1, wc[:, None].expand(b, c, h, w))
    shifted = torch.where(hit[:, None], gathered, 0.0)
    return shifted, hit


def stereo_shift(latents: torch.Tensor, depth: torch.Tensor,
                 scale_factor: float = 8.0, shift_both: bool = False,
                 stereo_offset_exponent: float = 1.0) -> torch.Tensor:
    """[B, C, H, W] latents + [B, H, W] depth -> [2B, C, H, W] (left, right).

    The right view shifts by -scale; with `shift_both` the divergence is
    split 50/50 across both eyes."""
    nd = _norm_depth01(depth.float())
    if shift_both:
        left, _ = _shift_one(latents, nd, +0.5 * scale_factor, stereo_offset_exponent)
        right, _ = _shift_one(latents, nd, -0.5 * scale_factor, stereo_offset_exponent)
    else:
        left = latents
        right, _ = _shift_one(latents, nd, -1.0 * scale_factor, stereo_offset_exponent)
    return torch.cat([left, right], dim=0)


def stereo_shift_with_mask(latents: torch.Tensor, depth: torch.Tensor,
                           scale_factor: float = 8.0,
                           stereo_offset_exponent: float = 1.0):
    """The right-view shift and its coverage mask [B, H, W] (the denoising
    loop's masked re-shift and deblur noise use both)."""
    nd = _norm_depth01(depth.float())
    return _shift_one(latents, nd, -1.0 * scale_factor, stereo_offset_exponent)
