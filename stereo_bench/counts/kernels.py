"""Bytes and operations of one launch of each hand-written kernel on the
benchmarked paths, from its shapes. Each input byte is read once and each
output byte written once, whatever the kernel reads again.

- warp (`warp_rows_kernel`, one launch per eye): the eye's depth in (4 B),
  the colour in and out (C values each of the colour's size) and the gap
  mask out (1 B) per pixel: 29 B/px in float32 with C = 3. Operations: the
  per-pixel part of the kernel's count (nd and the offset 12, dl 1, the
  interval 16, the offset range 2, the border search and gap 20, the taps 4
  per channel); the data-dependent candidate walk is left out, so this is a
  floor. At these shapes the bytes bound it.
- distance (`edge_distances_kernel` through the fused edge-weights entry,
  one launch per pass): the depth in (4 B), both weights out (8 B): 12 B/px;
  about 30 operations per pixel.
- exact polylines (`polylines_exact_kernel`, one launch per eye): the
  offsets in (4 B), the colour in and out (4 B per channel each): 28 B/px
  with C = 3. Operations: the per-pixel part (x and |coord| 4, m and its
  ranges 4, the finish 3 per channel); the per-piece scan is left out, so
  this is a floor. At these shapes the bytes bound it.
"""
from __future__ import annotations

from typing import Tuple


def warp(pixels: float, c: int = 3, colour_bytes: int = 4) -> Tuple[float, float]:
    """(bytes, operations) of one warp launch over `pixels` pixels."""
    return pixels * (4 + 2 * c * colour_bytes + 1), pixels * (51.0 + 4 * c)


def distance(pixels: float) -> Tuple[float, float]:
    """(bytes, operations) of one fused edge-weights launch."""
    return pixels * 12.0, pixels * 30.0


def polylines_exact(pixels: float, c: int = 3) -> Tuple[float, float]:
    """(bytes, operations) of one exact polylines launch."""
    return pixels * (4 + 2 * 4 * c), pixels * (8.0 + 3 * c)
