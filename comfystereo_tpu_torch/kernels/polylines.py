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

Per column each group's first hit can only move one way as the samples
advance (`hit_indices`), so the kernel keeps each group's winner, its two
colours read from device memory, across samples and rebuilds it only where
it changes.

The kernel takes any C (colours in groups of up to 3 channels),
k_candidates (K) of 1 to 8 (a run-time bound of its candidate loops) and
rows of up to `MAX_WIDTH` columns: rows whose planes fit in one CTA's
shared memory (`smem_bytes`; 9,598 columns at S = 8) stage them there, one
row per CTA; wider rows keep them in a device-memory workspace of one row
per CTA, and each CTA walks rows at a stride of the grid. A K above 8 or a
wider row raises on the card before any launch.

Two entries, each launching the kernel for CUDA tensors and running a plain
version for CPU tensors:
  * `polylines_scanline(x, coord, colors, ...)`, the Pallas kernel's
    contract: colour sums out. Its plain version,
    `polylines_scanline_plain`, keeps the Pallas kernel's float32
    expressions and their order;
  * `polylines_scanline_fused(coord, colors, sep_px, ...)`, what the route
    calls: the kernel forms x = col + 0.5 + coord + sep_px and finishes with
    trunc(clip(sum / S + 0.5, 0, 255)). Its plain version is that
    composition.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import _common

LAUNCHES = 0  # kernel launches since the last reset (plain-version calls don't count)
KERNEL_K = range(1, 9)  # the k_candidates the CUDA kernel takes
_STATIC_SMEM = 2048     # the kernel's own: a block scan's 512 floats
MAX_WIDTH = 1 << 24     # float32 counts every column below it
_CTAS_PER_SM = 8        # 256 threads each

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


def hit_indices(x: torch.Tensor, coord: torch.Tensor, sharp: bool, samples: int,
                k_candidates: int, max_disp: int):
    """Each group's first hit per sample: (upward, downward), each
    [S, N, W] int8, the candidate's index in the group's sweep order, -1
    where none is hit (`sweep`'s `found`)."""
    e_hi, e_lo = endpoint_streams(x, coord, sharp)
    bases = (search(torch.cummax(e_hi, dim=-1).values, max_disp, upward=True),
             search(torch.cummin(e_lo.flip(-1), dim=-1).values.flip(-1), max_disp,
                    upward=False))
    colsf = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    out = []
    for base, up in zip(bases, (True, False)):
        # one stand-in colour channel: the hits need only the ends and members
        cands = candidates(base, x, coord.abs(), coord, x[..., None], sharp, k_candidates, up)
        keys = torch.stack([torch.where(mem & (x1 > x0), x1 if up else x0,
                                        -math.inf if up else math.inf)
                            for x0, x1, _, _, _, _, mem in cands])
        del cands
        idx = torch.empty((samples,) + x.shape, dtype=torch.int8, device=x.device)
        for t in range(samples):
            s_pos = colsf + sample_offset(t, samples)
            hit = keys > s_pos if up else keys < s_pos
            first = hit.to(torch.int8).argmax(0).to(torch.int8)
            idx[t] = torch.where(hit.any(0), first, -1)
        out.append(idx)
    return tuple(out)


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


def row_words(w: int, samples: int) -> int:
    """4-byte words of one row's planes: x and coord, the two endpoint
    streams on W + 1 slots scanned and as they are, and the sample
    offsets."""
    return 2 * w + 4 * (w + 1) + samples


def smem_bytes(w: int, samples: int) -> int:
    """Dynamic shared memory of a CTA that stages its row's planes."""
    return 4 * row_words(w, samples)


def staged(w: int, samples: int) -> bool:
    """True when a row of w columns and S = samples stages its planes in
    shared memory; otherwise the kernel keeps them in its workspace."""
    return smem_bytes(w, samples) + _STATIC_SMEM <= _common.SMEM_LIMIT


def _check(name: str, rows, colors: torch.Tensor, samples: int, k_candidates: int,
           max_disp: int) -> None:
    _common.check_rows(name, rows, torch.float32)
    n, w = rows[0].shape
    if colors.dim() != 3 or tuple(colors.shape[:2]) != (n, w):
        raise ValueError(f"{name}: colors must be [{n}, {w}, C], got {tuple(colors.shape)}")
    if colors.dtype != torch.float32:
        raise TypeError(f"{name}: colors must be float32, got {colors.dtype}")
    if colors.device != rows[0].device:
        raise ValueError(f"{name}: colors and the rows on different devices")
    if samples < 1 or k_candidates < 1 or max_disp < 0:
        raise ValueError(f"{name}: samples {samples} and k_candidates {k_candidates} must "
                         f"be >= 1, max_disp {max_disp} >= 0")


def _launch(name: str, entry: str, rows, colors: torch.Tensor, sharp: bool, samples: int,
            k_candidates: int, max_disp: int) -> torch.Tensor:
    """Check the kernel's own limits and launch `entry` (rows: its leading
    arguments, pointers or the float32 separation)."""
    global LAUNCHES
    if k_candidates not in KERNEL_K:
        raise ValueError(f"{name}: the CUDA kernel takes k_candidates of {KERNEL_K.start} "
                         f"to {KERNEL_K.stop - 1}, got {k_candidates}")
    n, w, c = colors.shape
    if w > MAX_WIDTH:
        raise ValueError(f"{name}: a row of {w} columns is over the {MAX_WIDTH} columns the "
                         "CUDA kernel takes")
    if not colors.is_contiguous():
        raise ValueError(f"{name}: colors must be contiguous")
    if colors.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {colors.device}")
    from . import _build

    out = torch.empty_like(colors)
    ctas, workspace = 0, None
    if not staged(w, samples):
        ctas = min(n, _common.resident_ctas(colors.device, _CTAS_PER_SM))
        workspace = torch.empty(ctas * row_words(w, samples), dtype=torch.float32,
                                device=colors.device)
    err = _common.launch(
        getattr(_build.library("polylines"), entry),
        *rows, colors.data_ptr(), out.data_ptr(),
        None if workspace is None else workspace.data_ptr(), ctas, n, w, c,
        int(bool(sharp)), int(samples), int(k_candidates), int(max_disp),
        device=colors.device)
    _build.check(err, f"{name} kernel launch")
    LAUNCHES += 1
    return out


def polylines_scanline(x: torch.Tensor, coord: torch.Tensor, colors: torch.Tensor, *,
                       sharp: bool, samples: int, k_candidates: int,
                       max_disp: int) -> torch.Tensor:
    """Colour sums over S sub-samples of [N, W] rows (the function of the
    Pallas kernel, not of the XLA twin): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. x, coord: [N, W] float32,
    contiguous; colors: [N, W, C] float32, contiguous."""
    _check("polylines_scanline", (x, coord), colors, samples, k_candidates, max_disp)
    kw = dict(sharp=bool(sharp), samples=int(samples), k_candidates=int(k_candidates),
              max_disp=int(max_disp))
    if x.device.type == "cpu":
        return polylines_scanline_plain(x, coord, colors, **kw)
    return _launch("polylines_scanline", "cs_polylines_rows",
                   (x.data_ptr(), coord.data_ptr()), colors, **kw)


def polylines_scanline_fused_plain(coord: torch.Tensor, colors: torch.Tensor, sep_px: float,
                                   *, sharp: bool, samples: int, k_candidates: int,
                                   max_disp: int) -> torch.Tensor:
    """The route's composition: x = col + 0.5 + coord + sep_px, the sums of
    `polylines_scanline_plain`, then trunc(clip(sum / S + 0.5, 0, 255))."""
    sums = polylines_scanline_plain(_common.point_x(coord, sep_px), coord, colors,
                                    sharp=sharp, samples=samples,
                                    k_candidates=k_candidates, max_disp=max_disp)
    return torch.trunc(torch.clamp(sums / samples + 0.5, 0.0, 255.0))


def polylines_scanline_fused(coord: torch.Tensor, colors: torch.Tensor, sep_px: float, *,
                             sharp: bool, samples: int, k_candidates: int,
                             max_disp: int) -> torch.Tensor:
    """The finished uint8-valued colour of [N, W] rows of signed offsets
    `coord` (float32, contiguous) with separation `sep_px`: the kernel forms
    x and divides the sums itself. Otherwise as `polylines_scanline`."""
    _check("polylines_scanline_fused", (coord,), colors, samples, k_candidates, max_disp)
    kw = dict(sharp=bool(sharp), samples=int(samples), k_candidates=int(k_candidates),
              max_disp=int(max_disp))
    if coord.device.type == "cpu":
        return polylines_scanline_fused_plain(coord, colors, sep_px, **kw)
    return _launch("polylines_scanline_fused", "cs_polylines_coord",
                   (coord.data_ptr(), float(sep_px)), colors, **kw)
