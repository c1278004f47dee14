"""Supersampled polylines renderer of image rows: the legacy polylines_soft /
polylines_sharp fills and the hybrid_edge_plus backfill when
`polylines_exact=False`.

Kernel: `csrc/polylines.cu`, CUDA C++ for sm_90a, replacing the Pallas
kernel `comfystereo_tpu/pallas/polylines_kernel.py:polylines_scanline`
(`_poly_kernel`). It computes the function of that kernel, which is not the
function of the JAX package's XLA twin (`ops/polylines.py:_polylines_impl`):
the kernel solves the negative-offset group right to left with a suffix min
and a downward sweep where the twin mirrors the image, its `covered` test
adds `s_pos < sx1`, it falls back to a found group's left colour where
neither group covers a sample, and its downward sweep takes a pixel's flat
segment before its connecting one. The JAX package holds the two to a mean
|err| < 0.05 and < 0.1% of values off by more than 1 LSB; the port keeps
both (the twin in `ops/polylines.py`) and dispatches between them as JAX
does.

Per row, on W + 1 slots (slot j: the segment from point j - 1 to point j,
then, sharp only, the flat top of pixel j; slots 0 and W are the
sentinels):
  * each group's segment endpoint streams, restricted to its members
    (coord >= 0 for the positive group, coord <= 0 for the negative);
  * positive group: the first slot whose prefix max of right endpoints
    exceeds the column; negative group: the last slot whose suffix min of
    left endpoints lies below column + 1; both by a windowed binary search
    of a fixed number of rounds;
  * the K + 1 points around each group's slot, and for each of the S
    sub-samples s = col + (t + 0.5) / S the first candidate segment in the
    group's sweep order that crosses s, its interpolated closeness and
    colour, the closer group, and the sum over the samples.

The kernel works over whole rows; the Pallas kernel's column blocks and
their halos (`cb`, `halo`, `bad_edge`) are a device for TPU instruction
counts and keep every in-block query away from a window edge, so whole rows
give the same bits (tests/test_torch_port_polylines.py holds the plain
version against the Pallas kernel in interpret mode).

`polylines_scanline` launches the kernel for CUDA tensors and runs the plain
version, `polylines_scanline_plain`, for CPU tensors. The plain version keeps
the Pallas kernel's float32 expressions and their order.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import _common

LAUNCHES = 0  # kernel launches since the last reset (plain-version calls don't count)
KERNEL_K = 4  # the k_candidates the CUDA kernel is built for

_NEG_INF = -1e30
_POS_INF = 1e30


def search_rounds(max_disp: int) -> int:
    """Rounds of the windowed binary searches (a window of 2 * max_disp + 1
    slots, one round to spare)."""
    return max(1, math.ceil(math.log2(2 * max_disp + 2))) + 1


def sample_offset(t: int, samples: int) -> float:
    """(t + 0.5) / samples in float32, as the kernel computes it."""
    return float(np.float32(t + 0.5) / np.float32(samples))


def endpoint_streams(x: torch.Tensor, coord: torch.Tensor, sharp: bool):
    """(e_hi of the positive group, e_lo of the negative group), each
    [N, W + 1]: the right endpoints of the member segments of each slot, and
    the left endpoints (`endpoints`, polylines_kernel.py:125-137)."""
    w = x.shape[-1]
    hw = 0.45 if sharp else 0.0
    slot = torch.arange(w + 1, device=x.device)
    sent_l, sent_r = slot == 0, slot == w
    x_pad = F.pad(x, (0, 1), value=3.0 * w)        # slot W: the wrapper's pad value
    bx0 = torch.where(sent_l, -1.0 * w, F.pad(x, (1, 0)) + hw)
    bx1 = torch.where(sent_r, 2.0 * w, x_pad - hw)

    def endpoints(member):
        m_prev = F.pad(member, (1, 0), value=True)
        m_in = F.pad(member, (0, 1), value=False)  # member & in the image
        b_ok = (sent_l | sent_r | m_prev | m_in) & (bx1 > bx0)
        e_hi = torch.where(b_ok, bx1, _NEG_INF)
        e_lo = torch.where(b_ok, bx0, _POS_INF)
        if sharp:
            e_hi = torch.maximum(e_hi, torch.where(m_in, x_pad + hw, _NEG_INF))
            e_lo = torch.minimum(e_lo, torch.where(m_in, x_pad - hw, _POS_INF))
        return e_hi, e_lo

    return endpoints(coord >= 0.0)[0], endpoints(coord <= 0.0)[1]


def search(stream: torch.Tensor, max_disp: int, upward: bool) -> torch.Tensor:
    """Windowed binary search on a scanned [N, W + 1] stream for the W
    columns (`search_up` / `search_dn`, polylines_kernel.py:139-163): the
    first slot whose prefix max exceeds col (upward), or the last slot whose
    suffix min lies below col + 1 (downward). Lanes are not frozen once
    converged: the fixed rounds run on, as the kernel runs them."""
    n, m = stream.shape
    w = m - 1
    cols = torch.arange(w, dtype=torch.int32, device=stream.device)
    colsf = cols.float()
    target = colsf if upward else colsf + 1.0
    lo = torch.clamp(cols - max_disp, min=0).expand(n, w)
    hi = torch.clamp(cols + max_disp, max=w).expand(n, w)
    for _ in range(search_rounds(max_disp)):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = stream.gather(-1, mid.long())
        go = v <= target if upward else v < target
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, mid)
    return torch.clamp(lo if upward else lo - 1, 0, w)


def candidates(base, x, cl, coord, colors, sharp: bool, k_candidates: int,
                upward: bool):
    """The group's candidate segments in sweep order (`iter_candidates`,
    polylines_kernel.py:191-221), each (x0, x1, cl0, cl1, colour left,
    colour right, member); colours [N, W, C]."""
    w = x.shape[-1]
    hw = 0.45 if sharp else 0.0
    sign = 1.0 if upward else -1.0
    dks = range(-1, k_candidates) if upward else range(-k_candidates, 1)
    pts = {}
    for dk in dks:
        p = torch.clamp(base + dk, 0, w - 1).long()
        pts[dk] = (x.gather(-1, p), cl.gather(-1, p), coord.gather(-1, p),
                   colors.gather(-2, p[..., None].expand(p.shape + colors.shape[-1:])))
    out = []
    for k in (range(k_candidates) if upward else range(0, -k_candidates, -1)):
        slot = base + k
        sl, sr = slot == 0, slot == w
        (xl, cll, col, cL), (xr, clr, cor, cR) = pts[k - 1], pts[k]
        m_l, m_r = col * sign >= 0.0, cor * sign >= 0.0
        between = (torch.where(sl, -1.0 * w, xl + hw), torch.where(sr, 2.0 * w, xr - hw),
                   torch.where(sl, 0.0, cll), torch.where(sr, 0.0, clr),
                   torch.where(sl[..., None], cR, cL), torch.where(sr[..., None], cL, cR),
                   (sl | sr | m_l | m_r) & (slot >= 0) & (slot <= w))
        if sharp:
            within = (xr - hw, xr + hw, clr, clr, cR, cR, m_r & (slot < w) & (slot >= 0))
            out += [between, within] if upward else [within, between]
        else:
            out.append(between)
    return out


def _sweep(cands, s_pos: torch.Tensor, upward: bool):
    """First crossing candidate at the sample positions (`sweep`,
    polylines_kernel.py:223-250): (covered, closeness, colour, fallback
    colour, found)."""
    zeros = torch.zeros_like(s_pos)
    found = torch.zeros_like(s_pos, dtype=torch.bool)
    sx0, sx1, scl0, scl1 = zeros, torch.ones_like(s_pos), zeros, zeros
    c_zero = torch.zeros_like(cands[0][4])
    sc_l, sc_r = c_zero, c_zero
    for x0, x1, cl0, cl1, c_l, c_r, mem in cands:
        hit = mem & (x1 > x0) & ((x1 > s_pos) if upward else (x0 < s_pos))
        take = ~found & hit
        sx0 = torch.where(take, x0, sx0)
        sx1 = torch.where(take, x1, sx1)
        scl0 = torch.where(take, cl0, scl0)
        scl1 = torch.where(take, cl1, scl1)
        sc_l = torch.where(take[..., None], c_l, sc_l)
        sc_r = torch.where(take[..., None], c_r, sc_r)
        found = found | hit
    denom = torch.where(torch.abs(sx1 - sx0) < 1e-9, 1.0, sx1 - sx0)
    ip = torch.clamp((s_pos - sx0) / denom, 0.0, 1.0)
    covered = found & (sx0 < s_pos) & (s_pos < sx1)
    return covered, _lerp(scl0, scl1, ip), _lerp(sc_l, sc_r, ip[..., None]), sc_l, found


def _lerp(a: torch.Tensor, b: torch.Tensor, ip: torch.Tensor) -> torch.Tensor:
    """a * (1 - ip) + b * ip, each product and the sum rounded to float32
    (the CUDA kernel builds with -fmad=false)."""
    return a * (1.0 - ip) + b * ip


def polylines_scanline_plain(x: torch.Tensor, coord: torch.Tensor, colors: torch.Tensor,
                             *, sharp: bool, samples: int, k_candidates: int,
                             max_disp: int) -> torch.Tensor:
    """x, coord: [N, W] float32 (point positions, signed offsets; closeness
    is |coord|); colors: [N, W, C] float32. Returns the colour SUMS over the
    S sub-samples, [N, W, C] float32 (divide by `samples` outside)."""
    w = x.shape[-1]
    cl = torch.abs(coord)
    e_hi, e_lo = endpoint_streams(x, coord, sharp)
    idx_p = search(torch.cummax(e_hi, dim=-1).values, max_disp, upward=True)
    idx_n = search(torch.cummin(e_lo.flip(-1), dim=-1).values.flip(-1), max_disp,
                   upward=False)
    cands_p = candidates(idx_p, x, cl, coord, colors, sharp, k_candidates, True)
    cands_n = candidates(idx_n, x, cl, coord, colors, sharp, k_candidates, False)
    colsf = torch.arange(w, dtype=torch.float32, device=x.device)
    acc = torch.zeros_like(colors)
    for t in range(samples):
        s_pos = (colsf + sample_offset(t, samples)).expand(x.shape)
        cov_p, cl_p, col_p, fb_p, fnd_p = _sweep(cands_p, s_pos, True)
        cov_n, cl_n, col_n, fb_n, fnd_n = _sweep(cands_n, s_pos, False)
        use_n = cov_n & (~cov_p | (cl_n > cl_p))
        neither = ~(cov_p | cov_n)
        v = torch.where(use_n[..., None], col_n, col_p)
        v = torch.where(neither[..., None], torch.where(fnd_p[..., None], fb_p, fb_n), v)
        acc = acc + v
    return acc


def polylines_scanline(x: torch.Tensor, coord: torch.Tensor, colors: torch.Tensor, *,
                       sharp: bool, samples: int, k_candidates: int,
                       max_disp: int) -> torch.Tensor:
    """Colour sums over S sub-samples of [N, W] rows (the function of the
    Pallas kernel, not of the XLA twin): the CUDA kernel for CUDA tensors
    (C of 1 to 3, k_candidates 4), the plain version for CPU tensors. x, coord:
    [N, W] float32, contiguous; colors: [N, W, C] float32, contiguous."""
    global LAUNCHES
    _common.check_rows("polylines_scanline", (x, coord), torch.float32)
    n, w = x.shape
    if colors.dim() != 3 or tuple(colors.shape[:2]) != (n, w):
        raise ValueError(f"polylines_scanline: colors must be [{n}, {w}, C], got "
                         f"{tuple(colors.shape)}")
    if colors.dtype != torch.float32:
        raise TypeError(f"polylines_scanline: colors must be float32, got {colors.dtype}")
    if colors.device != x.device:
        raise ValueError("polylines_scanline: colors and x on different devices")
    if samples < 1 or k_candidates < 1 or max_disp < 0:
        raise ValueError(f"polylines_scanline: samples {samples} and k_candidates "
                         f"{k_candidates} must be >= 1, max_disp {max_disp} >= 0")
    kw = dict(sharp=bool(sharp), samples=int(samples), k_candidates=int(k_candidates),
              max_disp=int(max_disp))
    if x.device.type == "cpu":
        return polylines_scanline_plain(x, coord, colors, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"polylines_scanline: unsupported device {x.device}")
    c = colors.shape[-1]
    if not 1 <= c <= 3:
        raise ValueError(f"polylines_scanline: the CUDA kernel takes 1 to 3 channels, got {c}")
    if k_candidates != KERNEL_K:
        raise ValueError(f"polylines_scanline: the CUDA kernel is built for "
                         f"k_candidates={KERNEL_K}, got {k_candidates}")
    if not colors.is_contiguous():
        raise ValueError("polylines_scanline: colors must be contiguous")
    from . import _build

    out = torch.empty_like(colors)
    err = _build.library("polylines").cs_polylines_rows(
        x.data_ptr(), coord.data_ptr(), colors.data_ptr(), out.data_ptr(), n, w, c,
        int(kw["sharp"]), kw["samples"], kw["k_candidates"], kw["max_disp"],
        _common.stream_ptr(x.device))
    _build.check(err, "polylines_scanline kernel launch")
    LAUNCHES += 1
    return out

