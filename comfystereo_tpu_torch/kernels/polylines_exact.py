"""Exact polylines renderer of image rows (polylines_soft, polylines_sharp and
the hybrid_edge_plus backfill).

Kernel: `csrc/polylines_exact.cu`, CUDA C++ for sm_90a, replacing the Pallas
kernel `comfystereo_tpu/pallas/polylines_exact_kernel.py:
polylines_exact_scanline`. One CTA per image row: the row's m range sets the
candidate window, each column collects its breakpoints in [col, col + 1) by
a register bubble insert, builds its pieces and runs the winner scan per
piece. Its bytes (32 per pixel with three channels) and its operations
(in sharp mode 7 per window step and valid piece, nearly all activity tests,
and a blend for each active candidate) give bounds of about the same size.
See the source's header.

`polylines_exact_rows` launches the kernel for CUDA tensors and runs the
plain version, `polylines_exact_rows_plain`, for CPU tensors. The plain
version is the PyTorch translation of the JAX package's XLA path
(`ops/polylines_exact.py`: `_searchsorted_left_aligned`, `_piece_geometry`,
`_winner_scan_xla`) in its float32 expression forms, with two changes that
the tests show change no output: each row's candidates are limited to that
row's own window, as the kernel limits them (the XLA path takes one window
per 64-row chunk), and pieces that no pixel of the batch reaches are skipped
(they add 0.0 to an accumulator of at least 0.5).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _common

LAUNCHES = 0  # kernel launches since the last reset (plain-version calls don't count)

_EPS = 1e-7        # rounded to float32 wherever it meets a float32 tensor
KERNEL_PIECES = 12  # the max_pieces the CUDA kernel is built for


def window(x: torch.Tensor, max_disp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row candidate window [d_lo, d_hi] of d = source - col, as [N, 1]
    ints, from the row's m = x - (col + 0.5) range (the XLA path's :161-165
    applied to one row)."""
    w = x.shape[-1]
    m = x - (torch.arange(w, dtype=torch.float32, device=x.device) + 0.5)
    r_static = max_disp + 4
    d_lo = torch.floor(-m.amax(-1, keepdim=True)).long() - 2
    d_hi = torch.ceil(-m.amin(-1, keepdim=True)).long() + 2
    return d_lo.clamp(min=-r_static), d_hi.clamp(max=r_static)


def searchsorted_left_aligned(xs: torch.Tensor, ppc: int, win: int) -> torch.Tensor:
    """rank[..., q] = #elements of sorted xs[..., P] strictly below the query
    column q // ppc, on a P-lane grid so that |rank - lane| <= win + ppc. A
    fixed number of rounds that freezes converged lanes, as the JAX code
    runs it."""
    p = xs.shape[-1]
    lanes = torch.arange(p, dtype=torch.int32, device=xs.device)
    queries = torch.div(lanes, ppc, rounding_mode="floor").float()
    lo = torch.clamp(lanes - win, min=0).expand(xs.shape)
    hi = torch.clamp(lanes + win, max=p).expand(xs.shape)
    rounds = max(1, math.ceil(math.log2(2 * win + 2))) + 1
    for _ in range(rounds):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = xs.gather(-1, torch.clamp(mid, 0, p - 1).long())
        cont = lo < hi          # freeze converged lanes (fixed-round loop)
        go = cont & (v < queries)
        lo, hi = torch.where(go, mid + 1, lo), torch.where(cont & ~go, mid, hi)
    return lo


def piece_geometry(x: torch.Tensor, sharp: bool, max_pieces: int,
                   max_disp: int):
    """Breakpoint geometry of [N, W] rows of point centers: (centers, sigs,
    valids), each a list of K [N, W] float32 tensors. Piece k of pixel col
    spans sorted points q0+k .. q0+k+1 clipped to [col, col+1], eps-shrunk
    (reference sweep :1950-1960)."""
    n, w = x.shape
    ppc = 2 if sharp else 1
    hw = 0.45 if sharp else 0.0
    colsf = torch.arange(w, dtype=torch.float32, device=x.device)
    sent_l, sent_r = -1.0 * w, 2.0 * w

    pts = torch.stack([x - hw, x + hw], dim=-1).reshape(n, 2 * w) if sharp else x
    xs = torch.sort(pts, dim=-1).values
    p_total = ppc * w
    rank_all = searchsorted_left_aligned(xs, ppc, ppc * (max_disp + 3))
    # rank for column col lives at lane ppc*col; the left sentinel sorts
    # before any query, so q0 is the interior count.
    q0 = rank_all[..., ::ppc]

    def pt_sorted_at(q):
        """Sorted points with sentinels: 0 = left, 1..P interior, P+1 right."""
        v = xs.gather(-1, torch.clamp(q - 1, 0, p_total - 1).long())
        v = torch.where(q <= 0, sent_l, v)
        return torch.where(q >= p_total + 1, sent_r, v)

    centers, sigs, valids = [], [], []
    xq = pt_sorted_at(q0)
    for k in range(max_pieces):
        xq1 = pt_sorted_at(q0 + k + 1)
        valid = (xq < colsf + 1.0) if k > 0 else torch.ones_like(xq, dtype=torch.bool)
        f_k = torch.maximum(colsf, xq) + _EPS
        t_k = torch.minimum(colsf + 1.0, xq1) - _EPS
        sig = t_k - f_k
        centers.append(f_k + 0.5 * sig)
        sigs.append(sig)
        valids.append(valid.float())
        xq = xq1
    return centers, sigs, valids


def winner_scan(colors: torch.Tensor, x: torch.Tensor, cl: torch.Tensor,
                centers, sigs, valids, sharp: bool, max_disp: int) -> torch.Tensor:
    """The XLA path's winner scan over [N, W] rows with per-row windows;
    colors [N, W, C]. Returns the uint8-valued float32 [N, W, C] result."""
    n, w = x.shape
    dev = x.device
    hw = 0.45 if sharp else 0.0
    colsi = torch.arange(w, device=dev)
    sent_l, sent_r = -1.0 * w, 2.0 * w
    inf = 1e30

    d_lo_row, d_hi_row = window(x, max_disp)
    d_lo, d_hi = int(d_lo_row.min()), int(d_hi_row.max())
    img_p = colors.float().movedim(-1, 0)                 # [C, N, W]
    c = img_p.shape[0]
    r = max_disp + 5  # pad past the widest window (+-(max_disp + 4), and + 1)
    planes = torch.nn.functional.pad(torch.cat([x[None], cl[None], img_p]),
                                     (r, r + 1))

    def scan_piece(center):
        def consider(state, x0, x1, cl0, cl1, col_l, col_r, cand_ok, flat=False):
            best_cl, best_col, fb_x0, fb_col = state
            active = cand_ok & (x0 < center) & (x1 >= center)
            denom = x1 - x0
            safe = torch.where(denom == 0.0, 1.0, denom)
            ip = (center - x0) / safe
            clp = (1.0 - ip) * cl0 + ip * cl1
            qual = active & (ip > 0.0) & (ip < 1.0)
            if flat:  # both endpoints share a source column (:1984-1985)
                cval = col_l
            else:
                cval = col_l * (1.0 - ip[None]) + col_r * ip[None]
            better = qual & (clp > best_cl)
            best_cl = torch.where(better, clp, best_cl)
            best_col = torch.where(better[None], cval, best_col)
            fb_take = active & (x0 < fb_x0)
            fb_x0 = torch.where(fb_take, x0, fb_x0)
            fb_col = torch.where(fb_take[None], cval, fb_col)
            return best_cl, best_col, fb_x0, fb_col

        shape = (n, w)
        zeros = torch.zeros((c,) + shape, dtype=torch.float32, device=dev)
        state = (torch.full(shape, -_EPS, dtype=torch.float32, device=dev), zeros,
                 torch.full(shape, inf, dtype=torch.float32, device=dev), zeros)
        ok = torch.ones(shape, dtype=torch.bool, device=dev)
        state = consider(state, sent_l, x[:, :1] - hw, 0.0, cl[:, :1],
                         img_p[..., :1], img_p[..., :1], ok, flat=True)
        state = consider(state, x[:, -1:] + hw, sent_r, cl[:, -1:], 0.0,
                         img_p[..., -1:], img_p[..., -1:], ok, flat=True)
        for d in range(d_lo, d_hi + 1):
            cur = planes[..., r + d:r + d + w]
            nxt = planes[..., r + d + 1:r + d + 1 + w]
            cp = colsi + d
            in_win = (d >= d_lo_row) & (d <= d_hi_row)
            x_c, cl_c, img_c = cur[0], cur[1], cur[2:]
            if sharp:
                state = consider(state, x_c - hw, x_c + hw, cl_c, cl_c, img_c, img_c,
                                 (cp >= 0) & (cp <= w - 1) & in_win, flat=True)
            state = consider(state, x_c + hw, nxt[0] - hw, cl_c, nxt[1], img_c,
                             nxt[2:], (cp >= 0) & (cp <= w - 2) & in_win)
        best_cl, best_col, _, fb_col = state
        # With one active candidate, best and fallback hold its colour alike.
        return torch.where((best_cl > -_EPS)[None], best_col, fb_col)

    acc = torch.full((c, n, w), 0.5, dtype=torch.float32, device=dev)
    for k in range(len(centers)):
        if not bool((valids[k] > 0.5).any()):
            continue  # no pixel reaches piece k: it would add 0.0 everywhere
        color_k = scan_piece(centers[k])
        acc = acc + torch.where(valids[k][None] > 0.5, color_k * sigs[k][None], 0.0)
    return torch.trunc(torch.clamp(acc.movedim(0, -1), 0.0, 255.0))


def polylines_exact_rows_plain(x: torch.Tensor, cl: torch.Tensor,
                               colors: torch.Tensor, sharp: bool,
                               max_pieces: int, max_disp: int) -> torch.Tensor:
    """x, cl: [N, W] float32 (point centers, closeness); colors: [N, W, C]
    uint8-valued float32. Returns [N, W, C] uint8-valued float32."""
    centers, sigs, valids = piece_geometry(x, sharp, max_pieces, max_disp)
    return winner_scan(colors, x, cl, centers, sigs, valids, sharp, max_disp)


def polylines_exact_rows(x: torch.Tensor, cl: torch.Tensor, colors: torch.Tensor,
                         *, sharp: bool, max_pieces: int, max_disp: int
                         ) -> torch.Tensor:
    """Render [N, W] rows: the CUDA kernel for CUDA tensors (C of 1 to 3,
    max_pieces 12), the plain version for CPU tensors. x, cl: [N, W]
    float32, contiguous; colors: [N, W, C] float32, contiguous."""
    global LAUNCHES
    _common.check_rows("polylines_exact_rows", (x, cl), torch.float32)
    n, w = x.shape
    if colors.dim() != 3 or tuple(colors.shape[:2]) != (n, w):
        raise ValueError(f"polylines_exact_rows: colors must be [{n}, {w}, C], got "
                         f"{tuple(colors.shape)}")
    if colors.dtype != torch.float32:
        raise TypeError(f"polylines_exact_rows: colors must be float32, got {colors.dtype}")
    if colors.device != x.device:
        raise ValueError("polylines_exact_rows: colors and x on different devices")
    if x.device.type == "cpu":
        return polylines_exact_rows_plain(x, cl, colors, sharp, max_pieces, max_disp)
    if x.device.type != "cuda":
        raise ValueError(f"polylines_exact_rows: unsupported device {x.device}")
    c = colors.shape[-1]
    if not 1 <= c <= 3:
        raise ValueError(f"polylines_exact_rows: the CUDA kernel takes 1 to 3 channels, got {c}")
    if max_pieces != KERNEL_PIECES:
        raise ValueError(f"polylines_exact_rows: the CUDA kernel is built for "
                         f"max_pieces={KERNEL_PIECES}, got {max_pieces}")
    if not colors.is_contiguous():
        raise ValueError("polylines_exact_rows: colors must be contiguous")
    from . import _build

    out = torch.empty_like(colors)
    err = _build.library("polylines_exact").cs_polylines_exact_rows(
        x.data_ptr(), cl.data_ptr(), colors.data_ptr(), out.data_ptr(), n, w, c,
        int(bool(sharp)), int(max_pieces), int(max_disp),
        _common.stream_ptr(x.device))
    _build.check(err, "polylines_exact_rows kernel launch")
    LAUNCHES += 1
    return out
