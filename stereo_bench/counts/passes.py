"""The floor of a whole pass, whatever implements it: its inputs read once
and its outputs written once at the memory rate, or its operations at the
float32 rate, whichever is larger (`peaks.floor_s`).

Operations per pixel of a frame, counted from the algorithm at the node's
settings (a floor: only the work every pixel needs):
- depth in: the grey conversion 5, the divide 1, the 0-255 scaling 1;
- the blur: Sobel-x 6, the edge strength and masks 7, per eye the
  distances 4 and the weight 5 (18), per eye the vertical box mean of the
  weights ((2 r + 1) adds, a divide, a clamp: 2 r + 3 with r the vertical
  smoothing), the horizontal box mean of the depth (n adds and a divide
  with n the blur strength), per eye the blend 4;
- per eye the fill: the warp's per-pixel count, or the exact polylines'
  (`kernels`);
- out: per value of the packed pair a clamp (2) and the scale, clamp and
  truncation to uint8 (4). The mask and the depth outputs, which the
  pipeline also makes, are not part of a chunk's output and are not counted.
"""
from __future__ import annotations

from typing import Dict

from . import kernels


def ops_per_pixel(settings: Dict, fill: str, c: int = 3) -> float:
    r = int(settings["depth_blur_vert_smooth"])
    n = int(round(settings["depth_blur_strength"]))
    depth_in = 7.0
    blur = 6 + 7 + 18 + 2 * (2 * r + 3) + (n + 1) + 2 * 4
    if fill == "gpu_warp":
        eye = kernels.warp(1.0, c)[1]
    else:
        eye = kernels.polylines_exact(1.0, c)[1] + 3 * c  # the source's uint8 values
    out = 2 * c * (2 + 4)
    return depth_in + blur + 2 * eye + out


def video_chunk(frames: int, h: int, w: int, settings: Dict, fill: str):
    """(bytes, operations) of one chunk: BGR uint8 frames and BGR uint8
    depth in, the packed pair out as BGR uint8."""
    px = frames * h * w
    nbytes = px * 3 + px * 3 + 2 * px * 3
    return float(nbytes), px * ops_per_pixel(settings, fill)

