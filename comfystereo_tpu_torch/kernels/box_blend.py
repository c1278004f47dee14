"""The depth blur's box means and blends as one kernel.

Kernel: `csrc/box_blend.cu`, CUDA C++ for sm_90a. It replaces no Pallas
kernel: the JAX package leaves the box means to XLA
(`comfystereo_tpu/ops/blur.py:box_blur_h`, `box_blur_w`). After the edge
weights, `ops/blur.py:directional_motion_blur` launches it once for the
weights' vertical box means and clamps, the depth's horizontal box mean and
both eyes' blends; as plain PyTorch that was one launch per tap, clamp and
blend operation (62 a 12-frame 1080p chunk). The plain version,
`box_blend_plain`, is that composition: `box_blur_h` -> clamp -> `box_blur_w`
-> blend. Each box sum adds its taps in ascending window order, as a
sequential `reduce_window` adds them, and divides truly
(`device.true_divide`), so the CPU gives the JAX package's bits and the card
the CPU's; the kernel adds and rounds in the same order and is bit-equal to
the plain version.

Bound on the card: bytes. The depth and both weights are read once and both
eyes written once, 20 B/px: 498 MB, 0.149 ms at 3.35 TB/s, for 12 frames of
1080p; the kernel takes 0.245 ms on an H100 (61% of that). Design (details
in the source): a CTA walks a strip of `STRIP` rows of a `TILE`-column
tile, one column a thread; rows arrive in shared memory through a ring of
cp.async stages; each thread keeps the last 2r + 1 weights of its column in
registers (r up to `RING_RADIUS`; beyond, the taps are read through the
caches) and adds every window anew, never as a running sum, which would
round differently.

`box_blend` launches the kernel for CUDA tensors and runs the plain version
for CPU tensors; it takes [N, H, W] contiguous float32 of any H and W, a
horizontal window of up to `MAX_TAPS` taps and any radius, and raises on
anything else.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ._common import check_rows, launch
from ..device import true_divide

# csrc/box_blend.cu's tiling (kThreads, kStrip, kRingRadius, kMaxTaps there),
# for the numpy model in the tests.
TILE = 128
STRIP = 32
RING_RADIUS = 8
MAX_TAPS = 8192

LAUNCHES = 0  # kernel launches since the last reset (plain-version calls don't count)


def _edge_pad(x: torch.Tensor, dim: int, left: int, right: int) -> torch.Tensor:
    n = x.shape[dim]
    first = x.narrow(dim, 0, 1)
    last = x.narrow(dim, n - 1, 1)
    lshape = list(x.shape)
    lshape[dim] = left
    rshape = list(x.shape)
    rshape[dim] = right
    return torch.cat([first.expand(lshape), x, last.expand(rshape)], dim=dim)


def _window_sum(xp: torch.Tensor, dim: int, n: int, out_len: int) -> torch.Tensor:
    """sum_{k=0}^{n-1} xp[..., k:k+out_len] along `dim`, added in ascending k."""
    acc = xp.narrow(dim, 0, out_len)
    for k in range(1, n):
        acc = acc + xp.narrow(dim, k, out_len)
    return acc


def box_blur_w(x: torch.Tensor, n: int) -> torch.Tensor:
    """Box mean of width n along W with edge-replicate padding; window
    placement of scipy.ndimage.convolve1d(mode='nearest'):
    output[i] = mean(x[i + n//2 - n + 1 : i + n//2 + 1])."""
    if n <= 1:
        return x
    xp = _edge_pad(x, -1, n - 1 - n // 2, n // 2)
    return true_divide(_window_sum(xp, -1, n, x.shape[-1]), n)


def box_blur_h(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Box mean of width 2*radius+1 along H with edge-replicate padding."""
    if radius <= 0:
        return x
    n = 2 * radius + 1
    xp = _edge_pad(x, -2, radius, radius)
    return true_divide(_window_sum(xp, -2, n, x.shape[-2]), n)


def box_blend_plain(depth: torch.Tensor, wl: torch.Tensor, wr: torch.Tensor, *, taps: int,
                    radius: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The composition the kernel replaces: with radius > 0 each weight's
    vertical box mean clamped to [0, 1], the depth's horizontal box mean of
    `taps` taps (the depth itself for taps <= 1), and each eye's blend
    w * blurred + (1 - w) * depth."""
    if radius > 0:
        wl = torch.clamp(box_blur_h(wl, radius), 0.0, 1.0)
        wr = torch.clamp(box_blur_h(wr, radius), 0.0, 1.0)
    blurred = box_blur_w(depth, taps)
    return wl * blurred + (1.0 - wl) * depth, wr * blurred + (1.0 - wr) * depth


def box_blend(depth: torch.Tensor, wl: torch.Tensor, wr: torch.Tensor, *, taps: int,
              radius: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both eyes' blurred depth from the depth and the two eyes' edge
    weights, [N, H, W] float32 each: the CUDA kernel for CUDA tensors,
    `box_blend_plain` for CPU tensors. `taps` <= 1 leaves the depth
    unblurred, `radius` <= 0 the weights unsmoothed."""
    global LAUNCHES
    check_rows("box_blend", (depth, wl, wr), torch.float32, dims=("N", "H", "W"))
    taps, radius = max(int(taps), 1), max(int(radius), 0)
    if depth.device.type == "cpu":
        return box_blend_plain(depth, wl, wr, taps=taps, radius=radius)
    if taps > MAX_TAPS:
        raise ValueError(f"box_blend: a window of {taps} taps is over the {MAX_TAPS} taps "
                         "the CUDA kernel takes")
    if depth.device.type != "cuda":
        raise ValueError(f"box_blend: unsupported device {depth.device}")
    from . import _build

    left = torch.empty_like(depth)
    right = torch.empty_like(depth)
    n, h, w = depth.shape
    err = launch(_build.library("box_blend").cs_box_blend, depth.data_ptr(), wl.data_ptr(),
                 wr.data_ptr(), left.data_ptr(), right.data_ptr(), n, h, w, taps, radius,
                 device=depth.device)
    _build.check(err, "cs_box_blend kernel launch")
    LAUNCHES += 1
    return left, right
