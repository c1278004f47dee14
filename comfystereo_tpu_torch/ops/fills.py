"""Scanline fill techniques with bit-faithful mask semantics: the port of the
JAX package's `ops/fills.py`, in its float32 expression forms.

They re-express the reference's Numba kernels (stereoimage_generation.py:
1622-1910) as batched tensor ops. Per-row winner selection is a sort plus a
windowed binary search for each column's group; nearest-valid searches are
prefix scans. Quantization points (uint8 truncation, `int()` truncation
toward zero, uint8 wraparound) are replicated exactly.

Every gather with a bounded displacement goes through
`kernels/gather.py:bounded_take_along_w`, which is the CUDA kernel on the
card; gathers the JAX code leaves to `take_along_axis` stay `torch.gather`.
JAX's multi-key `lax.sort` becomes one int64 key where every key is an
integer, or chained stable sorts, last key first.

Conventions: images are float32 tensors holding exact uint8 values (0..255);
`norm_depth` is the per-image min/max normalized depth MINUS the convergence
point (what the reference dispatcher passes to its kernels, :1587-1600).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from . import depth as depth_ops
from . import scan
from ..device import true_divide
from ..kernels.gather import bounded_take_along_w

_BIG = 2 ** 30


def _cols(w: int, like: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    return torch.arange(w, dtype=dtype, device=like.device)


def _take_w(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """jnp.take_along_axis(values [B,H,W,C], idx [B,H,W,1], axis=2)."""
    return values.gather(2, idx.long().expand(values.shape))


# --------------------------------------------------------------------------
# Deterministic scatter helpers over the last axis of [..., W] tensors.
# --------------------------------------------------------------------------

def _flat_scatter(reduce: str, dest: torch.Tensor, values: torch.Tensor,
                  valid: torch.Tensor, width: int, init) -> torch.Tensor:
    """Scatter `values` to `dest` along the last axis with an amin/amax
    combiner on one flat buffer; invalid lanes go to a dump slot past the
    end. Deterministic for amin and amax (associative, commutative
    combiners); see `scatter_add_w` for the sum."""
    shape = tuple(dest.shape)
    n_rows = math.prod(shape[:-1])
    total = n_rows * width
    row_id = torch.arange(n_rows, dtype=torch.int64, device=dest.device)
    gidx = row_id.reshape(shape[:-1] + (1,)) * width + torch.clamp(dest.long(), 0, width - 1)
    gidx = torch.where(valid, gidx, total)  # dump slot
    buf = torch.full((total + 1,), init, dtype=values.dtype, device=values.device)
    buf = buf.scatter_reduce(0, gidx.reshape(-1), values.reshape(-1), reduce,
                             include_self=True)
    return buf[:total].reshape(shape[:-1] + (width,))


def scatter_min_w(dest, values, valid, width: int, init) -> torch.Tensor:
    """Per-row minimum of `values` at columns `dest` (`init` where none)."""
    return _flat_scatter("amin", dest, values, valid, width, init)


def scatter_max_w(dest, values, valid, width: int, init) -> torch.Tensor:
    """Per-row maximum of `values` at columns `dest` (`init` where none)."""
    return _flat_scatter("amax", dest, values, valid, width, init)


def scatter_add_w(dest, values, valid, width: int) -> torch.Tensor:
    """Per-row sum of `values` at columns `dest` (0 where none). On the card
    the adds are atomics in no fixed order; the callers add 1.0s, whose
    counts are exact integers below 2**24, so the sum does not depend on
    the order."""
    return _flat_scatter("sum", dest, values, valid, width, 0)


# --------------------------------------------------------------------------
# Sort-based exact winner selection: a lexicographic sort of (dest,
# priority...) keys, then for each output column a windowed binary search for
# the first element of its dest group.
# --------------------------------------------------------------------------

def _first_at_least(sorted_keys: torch.Tensor, queries: torch.Tensor,
                    max_disp: int) -> torch.Tensor:
    """First index k with sorted_keys[k] >= query, searched in a window of
    +-max_disp around each query column. sorted_keys: [..., M] ascending
    int32; queries: [..., N] int32 (near-diagonal). A fixed number of rounds
    that does not freeze converged lanes, as the JAX code runs it."""
    m = sorted_keys.shape[-1]
    lo = torch.clamp(queries - max_disp, 0, m)
    hi = torch.clamp(queries + max_disp, 0, m)
    rounds = max(1, math.ceil(math.log2(2 * max_disp + 2))) + 1
    for _ in range(rounds):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = bounded_take_along_w(sorted_keys, torch.clamp(mid, 0, m - 1),
                                 max_disp + 2)
        go = v < queries
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, mid)
    return lo


def _gather_image(image: torch.Tensor, winner_c: torch.Tensor,
                  max_disp: int) -> torch.Tensor:
    """image [B,H,W,C] at columns winner_c [B,H,W]: one bounded gather of the
    [B,C,H,W] planes with a [B,1,H,W] index plane."""
    img_cw = image.movedim(-1, -3)
    return bounded_take_along_w(img_cw, winner_c[:, None], max_disp).movedim(-3, -1)


# --------------------------------------------------------------------------
# Naive integer scatter (reference :1850-1868, :1664-1685).
# --------------------------------------------------------------------------

def naive_scatter(image: torch.Tensor, norm_depth: torch.Tensor,
                  divergence_px: float, separation_px: float,
                  stereo_offset_exponent: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer-offset scatter with swipe-order z-ordering: "min source
    column wins" for divergence >= 0 and "max source column wins" otherwise.

    Returns (derived [B,H,W,C], filled [B,H,W] bool).
    """
    b, h, w = norm_depth.shape
    cols = _cols(w, norm_depth)
    off = depth_ops.signed_power(norm_depth, stereo_offset_exponent) \
        * divergence_px + separation_px
    # numba `int()` truncates toward zero.
    col_d = cols + torch.trunc(off).int()
    valid = (col_d >= 0) & (col_d < w)

    max_off = int(abs(divergence_px) + abs(separation_px)) + 2
    disp = 2 * max_off + 8
    src_cols = cols.expand(b, h, w)
    key1 = torch.where(valid, col_d, w + max_off + 8)
    key2 = src_cols if divergence_px >= 0 else (w - 1) - src_cols
    # Both keys are ints and key2 < w: one int64 key sorts them
    # lexicographically (key2 is unique per row, so order is total).
    ks = torch.sort(key1.long() * w + key2, dim=-1).values
    k1s = torch.div(ks, w, rounding_mode="floor").int()
    k2s = torch.remainder(ks, w).int()
    queries = cols.expand(b, h, w)
    idx = _first_at_least(k1s, queries, disp)
    idx_c = torch.clamp(idx, 0, w - 1)
    hit = (idx < w) & (bounded_take_along_w(k1s, idx_c, disp) == queries)
    x_s = bounded_take_along_w(k2s, idx_c, disp)
    winner = x_s if divergence_px >= 0 else (w - 1) - x_s
    winner_c = torch.clamp(torch.where(hit, winner, queries), 0, w - 1)

    gathered = _gather_image(image, winner_c, max_off + 4)
    derived = torch.where(hit[..., None], gathered, 0.0)
    return derived, hit


def fill_naive(derived: torch.Tensor, filled: torch.Tensor,
               divergence_px: float) -> torch.Tensor:
    """Nearest-filled-neighbor fill within |int(divergence_px)|+1 px, ties to
    the right (reference :1893-1908)."""
    w = filled.shape[-1]
    max_off = abs(int(divergence_px)) + 1
    cols = _cols(w, filled, torch.int64)
    ln = scan.nearest_true_left(filled)
    rn = scan.nearest_true_right(filled)
    big = w + max_off + 2
    dl = torch.where(ln >= 0, cols - ln, big)
    dr = torch.where(rn < w, rn - cols, big)
    use_right = dr <= dl
    dist = torch.minimum(dl, dr)
    src = torch.where(use_right, torch.clamp(rn, 0, w - 1), torch.clamp(ln, 0, w - 1))
    val = _take_w(derived, src[..., None])
    do_fill = (~filled) & (dist <= max_off)
    return torch.where(do_fill[..., None], val, derived)


def fill_naive_interpolating(derived: torch.Tensor,
                             filled: torch.Tensor) -> torch.Tensor:
    """Linear border interpolation fill (reference :1871-1892).

    - a "valid" border pixel is filled AND non-black;
    - each gap spans from its first not-filled column to the next valid
      column, overwriting any filled-but-black pixels inside that span;
    - the left border is the pixel just before the first not-filled column
      (black => replaced by the right border, and vice versa);
    - the increment is truncated to uint8 with wraparound (floor-mod), so
      decreasing ramps rely on modulo-256 arithmetic.
    """
    w = filled.shape[-1]
    cols = _cols(w, filled)
    nonblack = derived.sum(-1) != 0
    valid = filled & nonblack

    rv = scan.nearest_true_right(valid).int()                # W if none
    # First not-filled column since the last valid pixel (inclusive scan).
    nf_idx = torch.where(~filled, cols.expand(filled.shape), _BIG)
    first_nf = scan.segmented_running_min(nf_idx, valid)
    written = (~valid) & (first_nf <= cols) & (first_nf < _BIG)

    l_ptr = torch.clamp(first_nf, 0, w - 1)
    has_lb = first_nf > 0
    l_border = _take_w(derived, torch.clamp(l_ptr - 1, 0, w - 1)[..., None])
    l_border = torch.where(has_lb[..., None], l_border, 0.0)
    has_rb = rv < w
    r_border = _take_w(derived, torch.clamp(rv, 0, w - 1)[..., None])
    r_border = torch.where(has_rb[..., None], r_border, 0.0)

    l_sum = l_border.sum(-1)
    r_sum = r_border.sum(-1)
    l_border2 = torch.where((l_sum == 0)[..., None], r_border, l_border)
    r_border2 = torch.where(((l_sum != 0) & (r_sum == 0))[..., None], l_border,
                            r_border)

    total_steps = (1 + rv - first_nf).float()
    step = (r_border2 - l_border2) / torch.clamp(total_steps[..., None], min=1.0)
    k = (cols - first_nf + 1).float()
    incr = torch.trunc(step * k[..., None]).int()
    # uint8 wraparound: l_border + uint8(step*k), matching numpy cast rules.
    val = torch.remainder(l_border2.int() + torch.remainder(incr, 256), 256)
    return torch.where(written[..., None], val.to(derived.dtype), derived)


# --------------------------------------------------------------------------
# Z-buffered sub-pixel splat ("inverse"; reference :1688-1737).
# --------------------------------------------------------------------------

def inverse_splat(image: torch.Tensor, norm_depth: torch.Tensor,
                  divergence_px: float, separation_px: float,
                  stereo_offset_exponent: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each source pixel writes floor(dest) and floor(dest)+1 with a per-row
    depth buffer; strictly-greater closeness wins, ties keep the earliest
    source column. One lexicographic sort on (j0, -closeness, x) makes the
    first element of group g the winner of tap-a (g == c) and tap-b
    (g == c-1) queries; the two tap winners combine by the same order.

    Returns (derived [B,H,W,C], written mask [B,H,W] bool).
    """
    b, h, w = norm_depth.shape
    colsf = _cols(w, norm_depth, torch.float32)
    off = depth_ops.signed_power(norm_depth, stereo_offset_exponent) * divergence_px
    dest_x = colsf + 0.5 + off + separation_px
    j0 = torch.floor(dest_x).int()
    closeness = norm_depth
    writes = closeness > -1.0  # the buffer starts at -1.0 and the test is strict

    max_off = int(abs(divergence_px) + abs(separation_px)) + 3
    disp = 2 * max_off + 8
    valid_any = (j0 >= -1) & (j0 <= w - 1) & writes
    key1 = torch.where(valid_any, j0, w + max_off + 8)
    negz = -closeness
    # Lexicographic (key1, -closeness, src): stable sorts, last key first;
    # the source column is the identity order.
    by_z = torch.sort(negz, dim=-1, stable=True).indices
    by_k1 = torch.sort(key1.gather(-1, by_z), dim=-1, stable=True).indices
    perm = by_z.gather(-1, by_k1)
    k1s = key1.gather(-1, perm)
    negz_s = negz.gather(-1, perm)
    xs = perm.int()
    queries = _cols(w, norm_depth).expand(b, h, w)

    def tap(group_queries):
        idx = _first_at_least(k1s, group_queries, disp)
        idx_c = torch.clamp(idx, 0, w - 1)
        ok = (idx < w) & (bounded_take_along_w(k1s, idx_c, disp) == group_queries)
        z = -bounded_take_along_w(negz_s, idx_c, disp)
        x = bounded_take_along_w(xs, idx_c, disp)
        return ok, z, x

    ok_a, z_a, x_a = tap(queries)          # sources with floor(dest) == c
    ok_b, z_b, x_b = tap(queries - 1)      # sources with floor(dest)+1 == c
    use_b = ok_b & (~ok_a | (z_b > z_a) | ((z_b == z_a) & (x_b < x_a)))
    hit = ok_a | ok_b
    winner = torch.where(use_b, x_b, x_a)
    winner_c = torch.clamp(torch.where(hit, winner, queries), 0, w - 1)

    gathered = _gather_image(image, winner_c, max_off + 4)
    derived = torch.where(hit[..., None], gathered, 0.0)
    return derived, hit


# --------------------------------------------------------------------------
# Gaussian 3-column splat + edge-aware fill ("hybrid_edge";
# reference :1622-1661, :1740-1774, :1837-1848).
# --------------------------------------------------------------------------

def gaussian_splat(image: torch.Tensor, norm_depth: torch.Tensor,
                   divergence_px: float, separation_px: float,
                   stereo_offset_exponent: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distribute each source pixel over three destination columns with
    Gaussian weights (sigma=1); returns (normalized uint8-valued image, mask).

    Sources are sorted by destination column once (stable, carrying the
    sub-pixel fraction and colours); each tap dd in {-1, 0, 1} is a segmented
    sum over that order, taken as prefix-sum differences at group bounds.
    """
    b, h, w = norm_depth.shape
    c = image.shape[-1]
    colsf = _cols(w, norm_depth, torch.float32)
    off = depth_ops.signed_power(norm_depth, stereo_offset_exponent) * divergence_px
    dest_x = colsf + 0.5 + off + separation_px
    j_center = torch.floor(dest_x).int()

    max_off = int(abs(divergence_px) + abs(separation_px)) + 3
    disp = 2 * max_off + 10
    valid_src = (j_center >= -1) & (j_center <= w)
    key1 = torch.where(valid_src, j_center, w + max_off + 9)
    frac = dest_x - j_center.float()
    order = torch.sort(key1, dim=-1, stable=True).indices
    k1s = key1.gather(-1, order)
    frac_s = frac.gather(-1, order)
    chan_s = [image[..., ch].gather(-1, order) for ch in range(c)]

    queries = _cols(w, norm_depth).expand(b, h, w)
    starts = {dd: _first_at_least(k1s, queries - dd, disp) for dd in (-1, 0, 1)}
    ends = {dd: _first_at_least(k1s, queries - dd + 1, disp) for dd in (-1, 0, 1)}

    accum = [torch.zeros((b, h, w), dtype=torch.float32, device=image.device)
             for _ in range(c)]
    wsum = torch.zeros((b, h, w), dtype=torch.float32, device=image.device)
    hit = torch.zeros((b, h, w), dtype=torch.bool, device=image.device)
    for dd in (-1, 0, 1):
        diff = frac_s - dd
        wght = torch.exp(-(diff * diff) / 2.0)
        sums = [wght] + [cs_ * wght for cs_ in chan_s]
        seg_nonempty = ends[dd] > starts[dd]
        hi_idx = torch.clamp(ends[dd] - 1, 0, w - 1)
        lo_idx = torch.clamp(starts[dd] - 1, 0, w - 1)
        for slot, vals in enumerate(sums):
            # Prefix sums: the CPU and the card round them in other orders
            # than XLA does, so this stage is held to a bound, not bit-parity.
            ps = torch.cumsum(vals, dim=-1)
            ps_hi = torch.where(ends[dd] > 0,
                                bounded_take_along_w(ps, hi_idx, disp), 0.0)
            ps_lo = torch.where(starts[dd] > 0,
                                bounded_take_along_w(ps, lo_idx, disp), 0.0)
            seg = torch.where(seg_nonempty, ps_hi - ps_lo, 0.0)
            if slot == 0:
                wsum = wsum + seg
            else:
                accum[slot - 1] = accum[slot - 1] + seg
        hit = hit | seg_nonempty

    # +1e-3 nudge before truncation: the normalized value in flat regions is
    # mathematically an exact integer, but f32 summation order makes the raw
    # ratio straddle it; the nudge pins those pixels to the exact value.
    acc = torch.stack(accum, dim=-1)
    ratio = acc / torch.clamp(wsum[..., None], min=1e-20)
    out = torch.where(wsum[..., None] > 0,
                      torch.trunc(torch.clamp(ratio, 0.0, 255.0) + 1e-3), 0.0)
    return out, hit


def rgb2gray(image: torch.Tensor) -> torch.Tensor:
    """Reference rgb2gray weights (:1740-1742)."""
    return 0.299 * image[..., 0] + 0.587 * image[..., 1] + 0.114 * image[..., 2]


def edge_aware_gap_fill(image: torch.Tensor, mask: torch.Tensor,
                        guidance: torch.Tensor, sigma_s: float = 1.0,
                        sigma_r: float = 10.0) -> torch.Tensor:
    """Bilateral 3x3 interpolation of unfilled pixels (reference :1745-1774):
    for mask==False pixels, average the 3x3 filled neighbors weighted by
    spatial distance and guidance (grayscale) similarity."""
    b, h, w, c = image.shape
    pad = torch.nn.functional.pad
    m = pad(mask.float(), (1, 1, 1, 1))
    g = pad(guidance, (1, 1, 1, 1))
    img = pad(image, (0, 0, 1, 1, 1, 1))

    num = torch.zeros_like(image)
    den = torch.zeros((b, h, w), dtype=torch.float32, device=image.device)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            sl_h = slice(1 + di, 1 + di + h)
            sl_w = slice(1 + dj, 1 + dj + w)
            nm = m[:, sl_h, sl_w]
            ws = float(np.exp(-(di * di + dj * dj) / (2.0 * sigma_s * sigma_s)))
            diff = guidance - g[:, sl_h, sl_w]
            wr = torch.exp(true_divide(-(diff * diff), 2.0 * sigma_r * sigma_r))
            wgt = nm * ws * wr
            num = num + img[:, sl_h, sl_w, :] * wgt[..., None]
            den = den + wgt
    filled_val = torch.trunc(torch.clamp(num / torch.clamp(den[..., None], min=1e-20),
                                         0.0, 255.0) + 1e-3)
    take = (~mask) & (den > 0)
    return torch.where(take[..., None], filled_val, image)


# --------------------------------------------------------------------------
# Row-wise post fills (reference :1804-1833): np.interp over valid columns.
# --------------------------------------------------------------------------

def post_fill_interp(derived: torch.Tensor, filled: torch.Tensor) -> torch.Tensor:
    """np.interp semantics: clamp before first / after last valid column,
    linear interpolation between surrounding valid columns elsewhere."""
    w = filled.shape[-1]
    cols = _cols(w, filled, torch.int64)
    ln = scan.nearest_true_left(filled)
    rn = scan.nearest_true_right(filled)
    has_l = (ln >= 0)[..., None]
    has_r = (rn < w)[..., None]
    lv = _take_w(derived, torch.clamp(ln, 0, w - 1)[..., None])
    rv = _take_w(derived, torch.clamp(rn, 0, w - 1)[..., None])

    denom = torch.clamp((rn - ln).float(), min=1.0)
    t = ((cols - ln).float() / denom)[..., None]
    interp = lv + (rv - lv) * t
    out = torch.where(has_l, interp, rv)
    out = torch.where(has_r, out, torch.where(has_l, lv, derived))
    out = torch.where(filled[..., None], derived, out)
    # Rows with no valid pixels at all keep the base image.
    any_valid = filled.any(-1, keepdim=True)
    out = torch.where(any_valid[..., None], out, derived)
    return torch.trunc(out)


# --------------------------------------------------------------------------
# Anaglyph composer (reference overlap_red_cyan :1996-2010).
# --------------------------------------------------------------------------

def overlap_red_cyan(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """R from the left image, G+B from the right. [..., H, W, 3]."""
    return torch.stack([left[..., 0], right[..., 1], right[..., 2]], dim=-1)
