"""Forward stereo warp with z-buffer semantics (reference forward_warp_gpu,
stereoimage_generation.py:277-450).

Each source pixel moves by its depth-derived offset; adjacent pixels whose
offsets differ by less than `gradient_threshold` form segments; overlapping
segments are z-buffered (nearer depth wins, strict `z > best + 1e-6`, ties to
the lowest source index); disocclusion gaps are filled by interpolating
source positions between the gap borders with a sqrt bias toward the
background side; colours are sampled bilinearly.

The work is done row by row in `kernels/warp_kernel.py`: its fused entry
forms the normalised depth and the offsets from the eye's depth and each
image's min and max, then warps (the CUDA kernel for CUDA tensors, the
plain PyTorch composition for CPU tensors).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..kernels.warp_kernel import warp_rows_fused, warp_rows_fused_plain

IMPLS = ("auto", "kernel", "twin")


def forward_warp(image: torch.Tensor, depth: torch.Tensor, divergence_px: float,
                 separation_px: float, stereo_offset_exponent: float,
                 convergence_point: float = 0.5,
                 gradient_threshold: float = 1.5,
                 max_stretch: int = 8,
                 impl: str = "auto",
                 depth_range=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward warp one eye.

    image: [B, H, W, C] float 0-1 (float32 or bfloat16 colour); depth:
    [B, H, W] (any scale, normalized per image). divergence_px /
    separation_px: floats (pixels). impl: 'auto' or 'kernel' (the CUDA
    kernel for CUDA tensors, any C, rows up to 65,536 columns; the plain
    version for CPU tensors) | 'twin' (the plain version, the JAX package's
    XLA path, on any device). depth_range: each image's (min
    [B], max [B]) float32 to normalise by, where `depth` holds only some of
    an image's rows (the sharded pipeline); by default each image's own.
    Returns (warped [B,H,W,C] in the colour dtype, gap_mask [B,H,W] bool,
    True = disocclusion).
    """
    if impl not in IMPLS:
        raise ValueError(f"forward_warp: impl {impl!r} not in {IMPLS}")
    # Static displacement bound: |offset| <= max(conv, 1-conv)^exp * |div| + |sep|.
    cmax = max(abs(convergence_point), abs(1.0 - convergence_point))
    bound = (cmax ** stereo_offset_exponent) * abs(divergence_px) \
        + abs(separation_px)
    max_disp = int(math.ceil(bound)) + 4
    if image.dtype not in (torch.float32, torch.bfloat16):
        image = image.float()
    b, h, w, c = image.shape
    rows = depth.float().reshape(b * h, w).contiguous()
    if depth_range is None:
        dmin, dmax = torch.aminmax(rows.reshape(b, h * w), dim=-1)
    else:
        dmin, dmax = depth_range
    kw = dict(divergence_px=divergence_px, separation_px=separation_px,
              exponent=stereo_offset_exponent, convergence_point=convergence_point,
              gradient_threshold=float(gradient_threshold), max_stretch=int(max_stretch),
              max_disp=max_disp, height=h)
    image_rows = image.reshape(b * h, w, c).contiguous()
    if impl == "twin":
        warped, gap = warp_rows_fused_plain(rows, dmin, dmax, image_rows, **kw)
    else:
        warped, gap = warp_rows_fused(rows, dmin, dmax, image_rows, **kw)
    return warped.reshape(b, h, w, c), gap.reshape(b, h, w)
