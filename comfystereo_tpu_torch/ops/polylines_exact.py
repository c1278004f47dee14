"""Exact polylines renderer: per-sub-interval integration, bit-parity mode.

Reference spec: `apply_stereo_divergence_polylines`
(stereoimage_generation.py:1912-1992). Per output pixel, the breakpoints are
the sorted warped point positions inside [col, col+1); at each
(epsilon-shrunk) sub-interval's center the ACTIVE segment (x0 < center <=
x1) with the maximum interpolated closeness wins (strict improvement,
0 < ip < 1; the lowest-x0 active segment when none qualifies), and its
colour times the sub-interval's width goes into a 0.5-biased accumulator
truncated to uint8.

The rows are rendered by `kernels/polylines_exact.py`'s fused entry: the
CUDA kernel for CUDA tensors, and for CPU tensors the plain version, which
is the point positions and closeness formed here and then the JAX
package's XLA path (`_piece_geometry`, `_winner_scan_xla`) translated to
PyTorch. Every sweep quantity is float32 in the reference's expression
forms, so the output is bit-equal in uint8 to the JAX package's.
"""
from __future__ import annotations

import math

import torch

from . import depth as depth_ops
from ..kernels.polylines_exact import (polylines_exact_rows_fused,
                                       polylines_exact_rows_fused_plain)

IMPLS = ("auto", "kernel", "twin")


def _exact_core(image: torch.Tensor, coord: torch.Tensor, sep_px: float,
                sharp: bool, max_pieces: int, max_disp: int, twin: bool = False
                ) -> torch.Tensor:
    """image [B,H,W,C] float32, coord [B,H,W] float32 -> [B,H,W,C]. The
    rows' x = col + 0.5 + coord + sep_px and closeness |coord| are formed by
    the fused entry (in the kernel on the card), or by its plain version on
    any device when `twin`."""
    b, h, w = coord.shape
    c = image.shape[-1]
    rows = (coord.reshape(b * h, w).contiguous(), image.reshape(b * h, w, c).contiguous(),
            sep_px)
    kw = dict(sharp=sharp, max_pieces=max_pieces, max_disp=max_disp)
    if twin:
        out = polylines_exact_rows_fused_plain(*rows, **kw)
    else:
        out = polylines_exact_rows_fused(*rows, **kw)
    return out.reshape(b, h, w, c)


def apply_polylines_exact(image: torch.Tensor, norm_depth: torch.Tensor,
                          divergence_px: float, separation_px: float,
                          stereo_offset_exponent: float, sharp: bool = True,
                          max_pieces: int = 12, impl: str = "auto") -> torch.Tensor:
    """Exact-integration polylines projection for one eye.

    image: [B,H,W,C] float32 holding uint8 values; norm_depth: [B,H,W]
    normalized depth minus convergence point (dispatcher convention).
    impl: 'auto' or 'kernel' (the CUDA kernel for CUDA tensors, any C,
    max_pieces 1 to 16; the plain version for CPU tensors) | 'twin' (the
    plain version, the JAX package's XLA path, on any device). Returns
    [B,H,W,C] float32 holding uint8 values.
    """
    if impl not in IMPLS:
        raise ValueError(f"apply_polylines_exact: impl {impl!r} not in {IMPLS}")
    coord = depth_ops.signed_power(norm_depth, stereo_offset_exponent) \
        * divergence_px
    max_off = abs(divergence_px) + abs(separation_px)
    max_disp = int(math.ceil(max_off)) + 4
    return _exact_core(image.float(), coord.float(), float(separation_px),
                       bool(sharp), int(max_pieces), max_disp, impl == "twin")
