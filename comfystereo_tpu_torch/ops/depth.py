"""Depth-to-disparity math, in the same float32 forms as the JAX package:

    normalize (per-image min/max) -> subtract convergence_point
    -> signed power curve  offset = sign(d) * |d|^exponent
    -> pixel scale         px = offset * divergence_px + separation_px

Depth convention: white = near, black = far (reference :1434).
"""
from __future__ import annotations

import torch


def normalize_depth(depth: torch.Tensor, batch_axes: int = 1) -> torch.Tensor:
    """Per-image min/max normalization of a depth map [..., H, W] to [0, 1].

    A flat depth map maps to all-zeros (reference :1591-1594). batch_axes is
    accepted and ignored, as in the JAX package: the min and max are always
    over the trailing (H, W) axes.
    """
    del batch_axes
    d = depth.float()
    return normalize_between(d, d.amin(dim=(-2, -1), keepdim=True),
                             d.amax(dim=(-2, -1), keepdim=True))


def normalize_between(d: torch.Tensor, dmin: torch.Tensor,
                      dmax: torch.Tensor) -> torch.Tensor:
    """(d - dmin) / (dmax - dmin) for float32 d and a min and max that
    broadcast against it; zeros where dmax - dmin <= 1e-6."""
    rng = dmax - dmin
    return torch.where(rng > 1e-6, (d - dmin) / torch.clamp(rng, min=1e-6),
                       0.0)


def signed_power(x: torch.Tensor, exponent: float) -> torch.Tensor:
    """sign(x) * |x| ** exponent (reference :94-96)."""
    return torch.sign(x) * torch.pow(torch.abs(x), exponent)


def depth_offsets(normalized_depth: torch.Tensor, convergence_point: float,
                  stereo_offset_exponent: float) -> torch.Tensor:
    """Unit offset in [-1, 1]-ish from normalized depth (before pixel scaling)."""
    return signed_power(normalized_depth - convergence_point,
                        stereo_offset_exponent)


def pixel_offsets(depth: torch.Tensor, divergence_px: float,
                  separation_px: float, stereo_offset_exponent: float,
                  convergence_point: float, *,
                  prenormalized: bool = False) -> torch.Tensor:
    """Full chain: depth map -> per-pixel horizontal offset in pixels."""
    nd = depth if prenormalized else normalize_depth(depth)
    off = depth_offsets(nd, convergence_point, stereo_offset_exponent)
    return off * divergence_px + separation_px


def percent_to_px(divergence: float, separation: float, width: int):
    """Percent-of-width -> pixels (reference :1602-1603, :1063-1065)."""
    return (divergence / 100.0) * width, (separation / 100.0) * width


def rgb_to_gray_depth(depth_rgb: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> [..., H, W] with the node's Rec.601 weights
    (GenerateStereo.py:135) in the input's dtype: the weighted sum of a
    3-channel input, the channel of a 1-channel one, and any other input
    unchanged. The sum is r*0.2989 + g*0.5870 + b*0.1140 in that order; the
    JAX package's XLA contracts it into FMAs, so the two differ by at most
    an ulp."""
    if depth_rgb.dim() >= 3 and depth_rgb.shape[-1] == 3:
        w = torch.tensor([0.2989, 0.5870, 0.1140], dtype=depth_rgb.dtype,
                         device=depth_rgb.device)
        return depth_rgb[..., 0] * w[0] + depth_rgb[..., 1] * w[1] + depth_rgb[..., 2] * w[2]
    if depth_rgb.dim() >= 3 and depth_rgb.shape[-1] == 1:
        return depth_rgb[..., 0]
    return depth_rgb
