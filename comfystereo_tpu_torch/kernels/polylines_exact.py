"""Exact polylines renderer of image rows (polylines_soft, polylines_sharp and
the hybrid_edge_plus backfill).

Kernel: `csrc/polylines_exact.cu`, CUDA C++ for sm_90a, replacing the Pallas
kernel `comfystereo_tpu/pallas/polylines_exact_kernel.py:
polylines_exact_scanline`. One CTA per image row: the row's m range sets the
candidate window, each warp narrows it to the m range of the sources its
columns can reach, and each column walks it once, collecting its breakpoints
in [col, col + 1) by a register bubble insert and its candidate list (the
segments with x0 < col + 1 and x1 >= col, in the scan's order); then it
builds its pieces and runs the winner scan per piece over that list. A
column whose list outgrows LIST_CAP entries scans the sources from its
first listed one to its last instead. Its bytes (28 per pixel through the
fused entry) bound it, with its operations close behind. See the source's
header.

The kernel takes any C (colours in groups of up to 3 channels), max_pieces
(K) of 1 to 16 (its breakpoint slots are a template of 12 or 16, the
smallest that holds K) and rows of up to `MAX_WIDTH` columns: rows of up to
`SHARED_WIDTH` columns stage their planes in shared memory, one row per
CTA; wider rows keep them in a device-memory workspace of one row per CTA,
and each CTA walks rows at a stride of the grid. A K above 16 or a wider
row raises on the card before any launch.

Two entries, each launching the kernel for CUDA tensors and running a plain
version for CPU tensors:
  * `polylines_exact_rows(x, cl, colors, ...)`, the Pallas kernel's
    contract (point centers and closeness in); its plain version,
    `polylines_exact_rows_plain`, is the PyTorch translation of the JAX
    package's XLA path (`ops/polylines_exact.py`: `_searchsorted_left_aligned`,
    `_piece_geometry`, `_winner_scan_xla`) in its float32 expression forms,
    with two changes that the tests show change no output: each row's
    candidates are limited to that row's own window, as the kernel limits
    them (the XLA path takes one window per 64-row chunk), and pieces that
    no pixel of the batch reaches are skipped (they add 0.0 to an
    accumulator of at least 0.5);
  * `polylines_exact_rows_fused(coord, colors, sep_px, ...)`, what the
    route calls: the kernel forms x = col + 0.5 + coord + sep_px and
    cl = |coord| itself. Its plain version is that composition.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _common

LAUNCHES = 0  # kernel launches since the last reset (plain-version calls don't count)

_EPS = 1e-7        # rounded to float32 wherever it meets a float32 tensor
KERNEL_PIECES = range(1, 17)  # the max_pieces the CUDA kernel takes
LIST_CAP = 16       # entries of a column's candidate list in the CUDA kernel
BLOCK = 32          # columns per warp, and per block of the kernel's m ranges
_STATIC_SMEM = 64   # the kernel's own: a block reduction's 16 floats
MAX_WIDTH = 1 << 24  # float32 counts every column below it
_CTAS_PER_SM = 5     # the kernel's launch bounds


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


def warp_windows(x: torch.Tensor, max_disp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's window [dl, dh] of d = source - col for each column, as
    [N, W] ints: the row window narrowed, per warp of 32 columns, to the m
    range of the 32-column blocks holding the sources those columns can
    reach (col + d and col + d + 1, d in the row window). Empty (1, 0) where
    there are none."""
    n, w = x.shape
    dev = x.device
    d_lo, d_hi = window(x, max_disp)                             # [n, 1]
    m = x - (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)
    nb = -(-w // BLOCK)
    pad = (0, nb * BLOCK - w)
    bmin = torch.nn.functional.pad(m, pad, value=math.inf).view(n, nb, BLOCK).amin(-1)
    bmax = torch.nn.functional.pad(m, pad, value=-math.inf).view(n, nb, BLOCK).amax(-1)
    cw = torch.arange(nb, device=dev) * BLOCK                    # each warp's first column
    src_lo = torch.clamp(cw + d_lo, min=0)
    src_hi = torch.clamp(cw + BLOCK + d_hi, max=w - 1)
    b0, b1 = src_lo // BLOCK, src_hi // BLOCK
    wlo = torch.full((n, nb), math.inf, device=dev)
    whi = torch.full((n, nb), -math.inf, device=dev)
    for k in range(int((b1 - b0).max()) + 1 if nb else 0):
        bk = torch.clamp(b0 + k, max=nb - 1)
        take = (b0 + k <= b1) & (src_lo <= src_hi)
        wlo = torch.where(take, torch.minimum(wlo, bmin.gather(-1, bk)), wlo)
        whi = torch.where(take, torch.maximum(whi, bmax.gather(-1, bk)), whi)
    some = src_lo <= src_hi
    dl = torch.where(some, torch.maximum(torch.floor(-whi).nan_to_num(0).long() - 2, d_lo), 1)
    dh = torch.where(some, torch.minimum(torch.ceil(-wlo).nan_to_num(0).long() + 2, d_hi), 0)
    return (dl.repeat_interleave(BLOCK, -1)[:, :w], dh.repeat_interleave(BLOCK, -1)[:, :w])


def candidate_lists(x: torch.Tensor, sharp: bool, max_disp: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lengths, flats, steps), each [N, W] int: per column, the number of
    entries of the kernel's candidate list (the flat and connecting
    segments of the sources in the column's window with x0 < col + 1 and
    x1 >= col), how many of them are flat tops, and the number of steps of
    its walk over the window."""
    n, w = x.shape
    hw = 0.45 if sharp else 0.0
    cols = torch.arange(w, device=x.device)
    colsf = cols.float()
    dl, dh = warp_windows(x, max_disp)
    r = max_disp + 5
    xp = torch.nn.functional.pad(x, (r, r + 1))
    flats = torch.zeros((n, w), dtype=torch.int32, device=x.device)
    conns = torch.zeros_like(flats)
    for d in range(int(dl.min()), int(dh.max()) + 1):
        cur, nxt = xp[:, r + d:r + d + w], xp[:, r + d + 1:r + d + 1 + w]
        ok = (d >= dl) & (d <= dh) & (cols + d >= 0) & (cols + d <= w - 1)
        if sharp:
            flats += ok & (cur - hw < colsf + 1.0) & (cur + hw >= colsf)
        conns += ok & (cols + d <= w - 2) & (cur + hw < colsf + 1.0) & (nxt - hw >= colsf)
    cp0 = torch.clamp(cols + dl, min=0)
    cp1 = torch.clamp(cols + dh, max=w - 1)
    steps = (torch.clamp(cp1 + 1, max=w - 1) - cp0 + 1).clamp(min=0)
    return flats + conns, flats, steps


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


def row_words(w: int) -> int:
    """4-byte words of one row's staged planes: x, closeness and the m
    ranges of its 32-column blocks."""
    return 2 * w + 2 * (-(-w // BLOCK))


def smem_bytes(w: int) -> int:
    """Dynamic shared memory of a CTA that stages its row: the planes and
    256 threads' candidate lists."""
    return 4 * row_words(w) + 4 * LIST_CAP * 256


def _shared_width() -> int:
    w = (_common.SMEM_LIMIT - _STATIC_SMEM) // 8
    while smem_bytes(w) + _STATIC_SMEM > _common.SMEM_LIMIT:
        w -= 1
    return w


SHARED_WIDTH = _shared_width()  # 26,181 columns


def _check_colors(name: str, colors: torch.Tensor, n: int, w: int, device) -> None:
    if colors.dim() != 3 or tuple(colors.shape[:2]) != (n, w):
        raise ValueError(f"{name}: colors must be [{n}, {w}, C], got {tuple(colors.shape)}")
    if colors.dtype != torch.float32:
        raise TypeError(f"{name}: colors must be float32, got {colors.dtype}")
    if colors.device != device:
        raise ValueError(f"{name}: colors and the rows on different devices")


def _launch(name: str, entry: str, rows, colors: torch.Tensor, sharp: bool,
            max_pieces: int, max_disp: int, list_cap: int, overflow) -> torch.Tensor:
    """Check the kernel's own limits and launch `entry` (rows: its leading
    arguments, pointers or the float32 separation)."""
    global LAUNCHES
    if max_pieces not in KERNEL_PIECES:
        raise ValueError(f"{name}: the CUDA kernel takes max_pieces of {KERNEL_PIECES.start} "
                         f"to {KERNEL_PIECES.stop - 1}, got {max_pieces}")
    n, w, c = colors.shape
    if w > MAX_WIDTH:
        raise ValueError(f"{name}: a row of {w} columns is over the {MAX_WIDTH} columns the "
                         "CUDA kernel takes")
    if not 0 <= list_cap <= LIST_CAP:
        raise ValueError(f"{name}: list_cap {list_cap} not in [0, {LIST_CAP}]")
    if not colors.is_contiguous():
        raise ValueError(f"{name}: colors must be contiguous")
    if overflow is not None and (overflow.dtype != torch.int32 or overflow.numel() != 1
                                 or overflow.device != colors.device):
        raise ValueError(f"{name}: overflow must be one int32 on {colors.device}")
    if colors.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {colors.device}")
    from . import _build

    out = torch.empty_like(colors)
    ctas, workspace = 0, None
    if w > SHARED_WIDTH:
        ctas = min(n, _common.resident_ctas(colors.device, _CTAS_PER_SM))
        workspace = torch.empty(ctas * row_words(w), dtype=torch.float32,
                                device=colors.device)
    err = _common.launch(
        getattr(_build.library("polylines_exact"), entry),
        *rows, colors.data_ptr(), out.data_ptr(),
        None if workspace is None else workspace.data_ptr(), ctas, n, w, c,
        int(bool(sharp)), int(max_pieces), int(max_disp), int(list_cap),
        None if overflow is None else overflow.data_ptr(), device=colors.device)
    _build.check(err, f"{name} kernel launch")
    LAUNCHES += 1
    return out


def _count_overflow(overflow, x: torch.Tensor, sharp: bool, max_disp: int,
                    list_cap: int) -> None:
    """On the CPU: add to `overflow` the columns whose list outgrows
    list_cap, as the kernel counts them."""
    if overflow is not None:
        overflow += int((candidate_lists(x, sharp, max_disp)[0] > list_cap).sum())


def polylines_exact_rows(x: torch.Tensor, cl: torch.Tensor, colors: torch.Tensor,
                         *, sharp: bool, max_pieces: int, max_disp: int,
                         list_cap: int = LIST_CAP, overflow: torch.Tensor = None
                         ) -> torch.Tensor:
    """Render [N, W] rows: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. x, cl: [N, W]
    float32, contiguous; colors: [N, W, C] float32, contiguous. list_cap
    (0 to LIST_CAP) caps the candidate lists; `overflow`, a one-element
    int32 tensor, receives the count of columns that outgrew it."""
    name = "polylines_exact_rows"
    _common.check_rows(name, (x, cl), torch.float32)
    _check_colors(name, colors, *x.shape, x.device)
    if x.device.type == "cpu":
        _count_overflow(overflow, x, sharp, max_disp, list_cap)
        return polylines_exact_rows_plain(x, cl, colors, sharp, max_pieces, max_disp)
    return _launch(name, "cs_polylines_exact_rows", (x.data_ptr(), cl.data_ptr()), colors,
                   sharp, max_pieces, max_disp, list_cap, overflow)


def polylines_exact_rows_fused_plain(coord: torch.Tensor, colors: torch.Tensor,
                                     sep_px: float, sharp: bool, max_pieces: int,
                                     max_disp: int) -> torch.Tensor:
    """The route's composition: x = col + 0.5 + coord + sep_px, cl = |coord|,
    then `polylines_exact_rows_plain`."""
    return polylines_exact_rows_plain(_common.point_x(coord, sep_px), torch.abs(coord),
                                      colors, sharp, max_pieces, max_disp)


def polylines_exact_rows_fused(coord: torch.Tensor, colors: torch.Tensor, sep_px: float,
                               *, sharp: bool, max_pieces: int, max_disp: int,
                               list_cap: int = LIST_CAP, overflow: torch.Tensor = None
                               ) -> torch.Tensor:
    """Render [N, W] rows of signed offsets `coord` (float32, contiguous)
    with separation `sep_px`: the kernel forms x and cl itself. Otherwise as
    `polylines_exact_rows`."""
    name = "polylines_exact_rows_fused"
    _common.check_rows(name, (coord,), torch.float32)
    _check_colors(name, colors, *coord.shape, coord.device)
    if coord.device.type == "cpu":
        _count_overflow(overflow, _common.point_x(coord, sep_px), sharp, max_disp, list_cap)
        return polylines_exact_rows_fused_plain(coord, colors, sep_px, sharp, max_pieces,
                                                max_disp)
    return _launch(name, "cs_polylines_exact_coord", (coord.data_ptr(), float(sep_px)),
                   colors, sharp, max_pieces, max_disp, list_cap, overflow)
