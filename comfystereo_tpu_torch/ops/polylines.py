"""Supersampled polylines renderer (`polylines_exact=False`): the legacy
polylines_soft / polylines_sharp fills and the hybrid_edge_plus backfill.

Reference spec: `apply_stereo_divergence_polylines`
(stereoimage_generation.py:1912-1992), approximated by S midpoint
sub-samples per pixel. Closeness is |offset|, so the segments split into a
positive-offset group and a negative-offset group (straddlers join both);
within a group the winner at a sample is the first segment, in the group's
scan order, whose reach crosses it. The two group winners are combined by
closeness, and the S samples are box-averaged with the reference's +0.5
bias and truncation (:1952, :1991).

Two functions compute this, as in the JAX package (`ops/polylines.py`):
  * the twin, `_polylines_impl`: the XLA path, which runs the positive group
    once on the image and once on the mirrored image for the negative group.
    It is bit-equal in uint8 to JAX's `impl="xla"`. JAX builds [.., W*S]
    sample planes; the port runs one sample at a time at pixel scale (every
    sample's arithmetic is the same elementwise function) and adds the
    samples in order;
  * the kernel route, `_polylines_kernel`: `kernels/polylines.py`'s
    `polylines_scanline` (the CUDA kernel on the card, its plain version on
    the CPU), the function of the JAX package's Pallas kernel, which solves
    the negative group natively and differs from the twin in a few details
    (see that module). JAX holds the two to a mean |err| < 0.05 and < 0.1%
    of values off by more than 1 LSB.

`apply_polylines(impl="auto")` takes the kernel route for CUDA tensors and
the twin for CPU tensors, as JAX takes its kernel on its accelerator and the
twin elsewhere.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import depth as depth_ops
from . import scan
from ..kernels.gather import bounded_take_along_w
from ..kernels.polylines import polylines_scanline, sample_offset, search_rounds

_NEG_INF = -1e30
IMPLS = ("auto", "kernel", "twin")


def _first_above(prefix: torch.Tensor, n_queries: int, max_disp: int) -> torch.Tensor:
    """min{j : prefix[j] > col} for integer queries col = 0..n_queries-1,
    searched in a +-max_disp window. prefix: [..., M] non-decreasing."""
    *lead, m = prefix.shape
    cols = torch.arange(n_queries, dtype=torch.int32, device=prefix.device)
    shape = tuple(lead) + (n_queries,)
    lo = torch.clamp(cols - max_disp, min=0).expand(shape)
    hi = torch.clamp(cols + max_disp, max=m).expand(shape)
    queries = cols.float()
    for _ in range(search_rounds(max_disp)):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = bounded_take_along_w(prefix, torch.clamp(mid, 0, m - 1), max_disp + 2)
        go = v <= queries
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, mid)
    return torch.clamp(lo, 0, m - 1)


def _oriented_group(image: torch.Tensor, coord: torch.Tensor, sep_px: float,
                    sharp: bool, k_candidates: int, max_disp: int):
    """One orientation (positive-offset group, scanned left to right):
    its candidate segments in consideration order, each (x0, x1, cl0, cl1,
    colour left, colour right, member), at pixel scale. image: [B,H,W,C];
    coord: [B,H,W] signed offsets."""
    b, h, w = coord.shape
    hw = 0.45 if sharp else 0.0
    cols = torch.arange(w, dtype=torch.float32, device=coord.device)
    x = cols + 0.5 + coord + sep_px                  # point positions
    cl = torch.abs(coord)
    member_pt = coord >= 0.0                         # positive group points

    # Slot reach (slot j: between[j] then within[j]); between[j] connects
    # point j-1 to point j (slots 0 and W are the sentinels).
    x_prev = F.pad(x, (1, 0), value=-1.0 * w)
    x_next = F.pad(x, (0, 1), value=2.0 * w)
    bx0 = x_prev + hw
    bx0[..., 0] = -1.0 * w
    bx1 = x_next - hw
    bx1[..., -1] = 2.0 * w
    b_member = F.pad(member_pt, (1, 0), value=True) | F.pad(member_pt, (0, 1), value=True)
    reach = torch.where(b_member & (bx1 > bx0), bx1, _NEG_INF)
    if sharp:
        e_w = F.pad(torch.where(member_pt, x + hw, _NEG_INF), (0, 1), value=_NEG_INF)
        reach = torch.maximum(reach, e_w)
    idx0 = _first_above(scan.running_max(reach), w, max_disp)   # [B,H,W]

    # The candidate window's point and colour data: slots idx0..idx0+K-1
    # need points idx0-1..idx0+K-1.
    gd = max_disp + k_candidates + 2
    img_cw = image.movedim(-1, -3)                   # [B,C,H,W]
    member_f = member_pt.float()
    pts = []
    for dk in range(-1, k_candidates):
        p = torch.clamp(idx0 + dk, 0, w - 1)
        pts.append((bounded_take_along_w(x, p, gd), bounded_take_along_w(cl, p, gd),
                    bounded_take_along_w(img_cw, p[:, None], gd).movedim(-3, -1),
                    bounded_take_along_w(member_f, p, gd) > 0.5))

    cands = []
    for k in range(k_candidates):
        slot = idx0 + k
        sl, sr = slot == 0, slot == w
        (x_l, cl_l, col_l, m_l), (x_r, cl_r, col_r, m_r) = pts[k], pts[k + 1]
        cands.append((torch.where(sl, -1.0 * w, x_l + hw), torch.where(sr, 2.0 * w, x_r - hw),
                      torch.where(sl, 0.0, cl_l), torch.where(sr, 0.0, cl_r),
                      torch.where(sl[..., None], col_r, col_l),
                      torch.where(sr[..., None], col_l, col_r),
                      sl | m_l | sr | m_r))
        if sharp:
            # within[slot]: the flat top of pixel `slot` (invalid at W).
            cands.append((x_r - hw, x_r + hw, cl_r, cl_r, col_r, col_r, m_r & (slot < w)))
    return cands


def _oriented_sample(cands, s_pos: torch.Tensor):
    """The group's (covered, closeness, colour) at one sample per pixel,
    s_pos [B,H,W]: the first candidate whose right end passes s_pos."""
    zeros = torch.zeros_like(s_pos)
    found = torch.zeros_like(s_pos, dtype=torch.bool)
    x0s, x1s, cl0s, cl1s = zeros, torch.ones_like(s_pos), zeros, zeros
    c_l = c_r = torch.zeros_like(cands[0][4])
    for x0, x1, cl0, cl1, col_l, col_r, member in cands:
        cross = member & (x1 > x0) & (x1 > s_pos)
        take = ~found & cross
        x0s = torch.where(take, x0, x0s)
        x1s = torch.where(take, x1, x1s)
        cl0s = torch.where(take, cl0, cl0s)
        cl1s = torch.where(take, cl1, cl1s)
        c_l = torch.where(take[..., None], col_l, c_l)
        c_r = torch.where(take[..., None], col_r, c_r)
        found = found | cross
    denom = torch.where(torch.abs(x1s - x0s) < 1e-9, 1.0, x1s - x0s)
    ip = torch.clamp((s_pos - x0s) / denom, 0.0, 1.0)
    covered = found & (x0s < s_pos)
    closeness = cl0s * (1.0 - ip) + cl1s * ip
    ipc = ip[..., None]
    color = c_l * (1.0 - ipc) + c_r * ipc
    # Fallback for K-window misses: the nearest candidate's left colour.
    return covered, closeness, torch.where(found[..., None], color, c_l)


def _polylines_impl(image: torch.Tensor, coord: torch.Tensor, sep_px: float, sharp: bool,
                    samples: int, k_candidates: int, max_disp: int) -> torch.Tensor:
    """The twin: image [B,H,W,C] float32, coord [B,H,W] -> [B,H,W,C]
    uint8-valued float32."""
    w = coord.shape[-1]
    pos = _oriented_group(image, coord, sep_px, sharp, k_candidates, max_disp)
    # Negative group = positive group of the mirrored image; the mirrored
    # sample grid maps sample (col, t) onto (W-1-col, S-1-t).
    neg = _oriented_group(image.flip(-2), -coord.flip(-1), -sep_px, sharp, k_candidates,
                          max_disp)
    colsf = torch.arange(w, dtype=torch.float32, device=coord.device)
    acc = None
    for t in range(samples):
        cov_p, cl_p, col_p = _oriented_sample(
            pos, (colsf + sample_offset(t, samples)).expand(coord.shape))
        cov_n, cl_n, col_n = _oriented_sample(
            neg, (colsf + sample_offset(samples - 1 - t, samples)).expand(coord.shape))
        cov_n, cl_n, col_n = cov_n.flip(-1), cl_n.flip(-1), col_n.flip(-2)
        use_n = cov_n & (~cov_p | (cl_n > cl_p))
        color = torch.where(use_n[..., None], col_n, col_p)
        acc = color if acc is None else acc + color   # the mean's sum, in sample order
    return torch.trunc(torch.clamp(acc / samples + 0.5, 0.0, 255.0))


def _polylines_kernel(image: torch.Tensor, coord: torch.Tensor, sep_px: float, sharp: bool,
                      samples: int, k_candidates: int, max_disp: int) -> torch.Tensor:
    """The kernel route: both groups, the closeness combine and the sample
    sums in `polylines_scanline`; the mean and the finish here."""
    b, h, w = coord.shape
    c = image.shape[-1]
    cols = torch.arange(w, dtype=torch.float32, device=coord.device)
    x = cols + 0.5 + coord + sep_px
    sums = polylines_scanline(
        x.reshape(b * h, w).contiguous(), coord.reshape(b * h, w).contiguous(),
        image.reshape(b * h, w, c).contiguous(), sharp=sharp, samples=samples,
        k_candidates=k_candidates, max_disp=max_disp)
    return torch.trunc(torch.clamp(sums.reshape(b, h, w, c) / samples + 0.5, 0.0, 255.0))


def apply_polylines(image: torch.Tensor, norm_depth: torch.Tensor, divergence_px: float,
                    separation_px: float, stereo_offset_exponent: float, sharp: bool = True,
                    samples: int = 8, k_candidates: int = 4,
                    impl: str = "auto") -> torch.Tensor:
    """Supersampled polylines projection for one eye.

    image: [B,H,W,C] float32 holding uint8 values; norm_depth: [B,H,W]
    normalized depth minus convergence point (dispatcher convention).
    impl: 'auto' (the kernel route for CUDA tensors, the twin for CPU
    tensors) | 'kernel' (the kernel route; its plain version on the CPU) |
    'twin'. Returns [B,H,W,C] float32 holding uint8 values.
    """
    if impl not in IMPLS:
        raise ValueError(f"apply_polylines: impl {impl!r} not in {IMPLS}")
    coord = depth_ops.signed_power(norm_depth, stereo_offset_exponent) * divergence_px
    max_off = abs(divergence_px) + abs(separation_px)
    max_disp = int(math.ceil(max_off)) + 4
    use_kernel = impl == "kernel" or (impl == "auto" and coord.device.type == "cuda")
    route = _polylines_kernel if use_kernel else _polylines_impl
    return route(image.float(), coord.float(), float(separation_px), bool(sharp),
                 int(samples), int(k_candidates), max_disp)
