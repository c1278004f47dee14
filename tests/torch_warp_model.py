"""Float32 models of the warp kernel's prefilter (csrc/warp_kernel.cu).

The kernel keeps per segment (columns i and i + 1) the interval of columns
it can cover, narrows each warp's candidate window to the segments whose
intervals meet its 32 columns, and forms the exact test only inside an
interval. These models repeat those steps on [N, W] rows with PyTorch, so
the tests can show that the prefilter drops no winner and chip_smoke.py can
count the candidates a column walks and those it divides for. Neither the
package nor its plain versions use them.
"""
from __future__ import annotations

import torch

from comfystereo_tpu_torch.kernels import warp_kernel as wk

MARGIN = 2.0 ** -20  # csrc/warp_kernel.cu:kMargin


def segment_intervals(offset: torch.Tensor, gradient_threshold: float, max_stretch: int):
    """The kernel's interval [lo, hi] of columns that segment i (columns i
    and i + 1) can cover, as [N, W] int64 each (lo > hi: none), in the
    kernel's float32 forms (csrc/warp_kernel.cu:interval)."""
    n, w = offset.shape
    cols = torch.arange(w, dtype=torch.float32, device=offset.device)
    dl = cols + offset
    dr = torch.cat([dl[:, 1:], dl[:, -1:]], dim=-1)
    o1 = torch.cat([offset[:, 1:], offset[:, -1:]], dim=-1)
    width = dr - dl
    sw = torch.where(width.abs() < 1e-4, 1.0, width)
    end = dl + sw
    up = sw > 0.0
    lo = torch.where(up, torch.ceil(dl - MARGIN), torch.ceil(end))
    hi = torch.where(up, torch.floor(end), torch.floor(dl + MARGIN))
    hi = torch.minimum(hi, torch.floor(torch.minimum(dl, dr)) + (max_stretch - 1))
    lo = lo.clamp(min=0.0)
    hi = hi.clamp(max=w - 1.0)
    ok = ((o1 - offset).abs() < gradient_threshold) & (lo <= hi)
    ok[:, -1] = False
    return torch.where(ok, lo, 1.0).long(), torch.where(ok, hi, 0.0).long()


def warp_windows(offset: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, max_disp: int):
    """Each warp's window [wlo, whi] of d = i - col, [N, G] int64 for the
    G = ceil(W / 32) groups of 32 columns: the d of every (column, segment)
    pair of the group with the column in the segment's interval, among the
    segments of the row's window; wlo > whi where there is none."""
    n, w = offset.shape
    g = (w + 31) // 32
    d_lo, d_hi = wk._window(offset, max_disp)
    base = torch.arange(g, device=offset.device) * 32
    last = (base + 31).clamp(max=w - 1)
    big = 1 << 30
    wlo = torch.full((n, g), big, dtype=torch.long, device=offset.device)
    whi = torch.full((n, g), -big, dtype=torch.long, device=offset.device)
    for j in range(int(d_lo.min()), 31 + int(d_hi.max()) + 1):
        i = base + j                                            # [G]
        ic = i.clamp(0, w - 1)
        ok = (i >= base + d_lo) & (i <= last + d_hi) & (i >= 0) & (i <= w - 2)
        c0 = torch.maximum(lo[:, ic], base)
        c1 = torch.minimum(hi[:, ic], last)
        ok = ok & (c0 <= c1)
        wlo = torch.where(ok, torch.minimum(wlo, i - c1), wlo)
        whi = torch.where(ok, torch.maximum(whi, i - c0), whi)
    return wlo, whi


def walk_model(offset: torch.Tensor, nd: torch.Tensor, gradient_threshold: float,
               max_stretch: int, max_disp: int):
    """A float32 model of the kernel's column loop: each column walks its
    warp's window and forms the exact tests only inside a segment's
    interval. Returns (src, zbest, walked, tested): the z-buffer's result,
    equal to the plain version's, and per column the candidates walked and
    those that reached the exact tests (and so divided)."""
    n, w = offset.shape
    lo, hi = segment_intervals(offset, gradient_threshold, max_stretch)
    wlo, whi = warp_windows(offset, lo, hi, max_disp)
    colsi = torch.arange(w, device=offset.device)
    group = colsi // 32
    c_lo, c_hi = wlo[:, group], whi[:, group]                  # [N, W]
    d_lo, d_hi = wk._window(offset, max_disp)
    walked = torch.zeros((n, w), dtype=torch.long, device=offset.device)
    tested = torch.zeros_like(walked)

    def allowed(d: int):
        i = colsi + d
        ic = i.clamp(0, w - 1)
        walk = (d >= c_lo) & (d <= c_hi) & (d >= d_lo) & (d <= d_hi) & (i >= 0) & (i <= w - 2)
        inside = walk & (lo[:, ic] <= colsi) & (colsi <= hi[:, ic])
        walked.add_(walk.long())
        tested.add_(inside.long())
        return inside

    src, zbest = wk._zbuffer(offset, nd, gradient_threshold, max_stretch, max_disp, allowed)
    return src, zbest, walked, tested
