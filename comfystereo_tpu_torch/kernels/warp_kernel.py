"""Exact z-buffer forward warp of image rows (the gpu_warp fill technique).

Kernel: `csrc/warp_kernel.cu`, CUDA C++ for sm_90a, replacing the Pallas
kernel `comfystereo_tpu/pallas/warp_kernel.py:warp_scanline`. One CTA per
image row: the row's offset range sets the candidate window, the segment
planes sit in shared memory, each column walks the window in ascending
source order with the strict `zz > zbest + 1e-6` rule, block scans find the
gap borders, and the bilinear taps read the HWC image directly. At the main
path's shapes it is bound by bytes (about 33 B per pixel in float32); the
candidate walk, about 8 float operations per candidate, comes next. See the
source's header for the design.

`warp_rows` launches the kernel for CUDA tensors and runs the plain version,
`warp_rows_plain`, for CPU tensors. The plain version is the PyTorch
translation of the JAX package's `ops/warp.py:_forward_warp_monotone`, in its
float32 expression forms (no lerp or addcmul, which may fuse into FMAs), with
one addition: each row's candidates are limited to that row's own window, as
the kernel limits them, which the tests show changes no winner.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _common
from ..ops import scan

LAUNCHES = 0  # kernel launches since the last reset (plain-version calls don't count)

_COLOR_DTYPES = (torch.float32, torch.bfloat16)


def _window(offset: torch.Tensor, max_disp: int):
    """Per-row candidate window [d_lo, d_hi] of d = i - col, as [N, 1] ints:
    a segment i covering col has col - i within the row's offset range."""
    r_static = max_disp + 2
    d_lo = torch.floor(-offset.amax(-1, keepdim=True) - 1.0).long()
    d_hi = torch.ceil(-offset.amin(-1, keepdim=True)).long()
    return d_lo.clamp(min=-r_static), d_hi.clamp(max=r_static)


def warp_rows_plain(offset: torch.Tensor, nd: torch.Tensor, image: torch.Tensor,
                    gradient_threshold: float, max_stretch: int, max_disp: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """offset, nd: [N, W] float32; image: [N, W, C]. Returns (warped
    [N, W, C] in image's dtype, gap [N, W] bool)."""
    n, w = offset.shape
    dev = offset.device
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    colsi = torch.arange(w, device=dev)
    dest = cols + offset

    # Segment i joins columns i and i + 1; column w-1 holds no segment, and
    # the window pads R columns of no segment on each side.
    r = max_disp + 2
    conn = (offset[:, 1:] - offset[:, :-1]).abs() < gradient_threshold
    dl = dest[:, :-1]
    dr = dest[:, 1:]
    width = dr - dl
    safe_w = torch.where(width.abs() < 1e-4, 1.0, width)
    mstart = torch.floor(torch.minimum(dl, dr))
    segs = torch.stack([dl, safe_w, nd[:, :-1], nd[:, 1:], mstart])
    segs = torch.nn.functional.pad(segs, (r, r + 1))
    conn = torch.nn.functional.pad(conn, (r, r + 1))

    d_lo_row, d_hi_row = _window(offset, max_disp)
    zbest = torch.full((n, w), -1.0, dtype=torch.float32, device=dev)
    src = torch.full((n, w), -1.0, dtype=torch.float32, device=dev)
    for d in range(int(d_lo_row.min()), int(d_hi_row.max()) + 1):
        i = colsi + d
        dl_t, sw_t, zl_t, zr_t, ms_t = segs[:, :, r + d:r + d + w]
        frac = (cols - dl_t) / sw_t
        zz = zl_t * (1.0 - frac) + zr_t * frac
        valid = (conn[:, r + d:r + d + w] & (i >= 0) & (i <= w - 2)
                 & (frac >= 0.0) & (frac < 1.0)
                 & (cols - ms_t < max_stretch)
                 & (d >= d_lo_row) & (d <= d_hi_row))
        better = valid & (zz > zbest + 1e-6)
        zbest = torch.where(better, zz, zbest)
        src = torch.where(better, i.float() + frac, src)

    filled = src >= 0.0
    gap = ~filled

    # Disocclusion fill: interpolate source positions between the gap's
    # borders with a sqrt bias toward the background (lower z) side. The
    # right border is the row's rightmost filled column (reference :399-404).
    (left_src, left_z), has_l = scan.forward_fill((src, zbest), filled)
    ln = scan.nearest_true_left(filled)
    rn = torch.where(filled, colsi, -1).amax(-1, keepdim=True)
    rn_c = rn.clamp(0, w - 1)
    right_src = src.gather(-1, rn_c)
    right_z = zbest.gather(-1, rn_c)
    has_r = colsi <= rn

    left_dist = cols - ln.float()
    right_dist = (rn - colsi).float()
    total = torch.clamp(left_dist + right_dist, min=1.0)
    t = left_dist / total
    t = torch.where(~has_l, 1.0, t)
    t = torch.where(~has_r, 0.0, t)
    left_is_bg = left_z < right_z
    t_biased = torch.where(left_is_bg, torch.sqrt(t), 1.0 - torch.sqrt(1.0 - t))
    gap_src = left_src * (1.0 - t_biased) + right_src * t_biased

    src = torch.where(gap & (has_l | has_r), gap_src, src)
    bil = max_disp + 126
    src = torch.minimum(torch.maximum(src, cols - bil), cols + bil)
    src = src.clamp(0.0, w - 1.0)

    # Bilinear taps (align_corners convention, border clamp).
    x0 = torch.floor(src)
    fr = (src - x0)[..., None]
    i0 = x0.long()
    i1 = (i0 + 1).clamp(max=w - 1)
    c = image.shape[-1]
    g0 = image.gather(1, i0[..., None].expand(n, w, c)).float()
    g1 = image.gather(1, i1[..., None].expand(n, w, c)).float()
    out = g0 * (1.0 - fr) + g1 * fr
    return out.to(image.dtype), gap


def warp_rows(offset: torch.Tensor, nd: torch.Tensor, image: torch.Tensor, *,
              gradient_threshold: float, max_stretch: int, max_disp: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp [N, W] rows: the CUDA kernel for CUDA tensors (C of 1 or 3), the
    plain version for CPU tensors. offset, nd: [N, W] float32, contiguous;
    image: [N, W, C] float32 or bfloat16, contiguous."""
    global LAUNCHES
    _common.check_rows("warp_rows", (offset, nd), torch.float32)
    n, w = offset.shape
    if image.dim() != 3 or tuple(image.shape[:2]) != (n, w):
        raise ValueError(f"warp_rows: image must be [{n}, {w}, C], got "
                         f"{tuple(image.shape)}")
    if image.dtype not in _COLOR_DTYPES:
        raise TypeError(f"warp_rows: colour dtype {image.dtype} not in {_COLOR_DTYPES}")
    if image.device != offset.device:
        raise ValueError("warp_rows: image and offsets on different devices")
    if offset.device.type == "cpu":
        return warp_rows_plain(offset, nd, image, gradient_threshold,
                               max_stretch, max_disp)
    if offset.device.type != "cuda":
        raise ValueError(f"warp_rows: unsupported device {offset.device}")
    c = image.shape[-1]
    if c not in (1, 3):
        raise ValueError(f"warp_rows: the CUDA kernel takes 1 or 3 channels, got {c}")
    if not image.is_contiguous():
        raise ValueError("warp_rows: image must be contiguous")
    from . import _build

    out = torch.empty_like(image)
    gap = torch.empty((n, w), dtype=torch.bool, device=offset.device)
    lib = _build.library("warp_kernel")
    fn = lib.cs_warp_rows_f32 if image.dtype == torch.float32 else lib.cs_warp_rows_bf16
    err = fn(offset.data_ptr(), nd.data_ptr(), image.data_ptr(), out.data_ptr(),
             gap.data_ptr(), n, w, c, float(gradient_threshold), int(max_stretch),
             int(max_disp), _common.stream_ptr(offset.device))
    _build.check(err, "warp_rows kernel launch")
    LAUNCHES += 1
    return out, gap
