"""Plain PyTorch reference of the two benchmarked paths: the depth->stereo
pass with the `gpu_warp` fill or the exact `polylines_sharp` fill, the
directional depth blur, the side-by-side pack, and the output of the video
chunk (BGR uint8).

This is a frozen copy, made for the benchmark, of the compositions that the
program's kernels are held to (its plain versions: the Sobel-x edge masks,
row distances and weights, the box means, the z-buffer warp by candidate
offsets, the exact polylines' piece geometry and winner scan), written out
as plain tensor operations in the same float32 expression forms. It imports
nothing of the program, so a change to the program cannot move it. It runs
on any device; on the card it gives the CPU's bits because every division
by a scalar divides truly (`true_divide`) and float32 square roots are
correctly rounded (`sqrt`).

`depth_dtype` computes the grey depth and the blur in another dtype (the
control of a cell whose program has no lower-precision path of its own).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

UI_FILLS = {"GPU Warp (Fast)": "gpu_warp", "Fill - Polylines Sharp": "polylines_sharp"}
EPS = 1e-7
LARGE = 1e9
GRAY = (0.2989, 0.5870, 0.1140)  # Rec.601 weights of R, G, B
MAX_PIECES = 12
GRADIENT_THRESHOLD, MAX_STRETCH = 1.5, 8


# --- arithmetic that rounds alike on every device -------------------------

def true_divide(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """x / divisor as IEEE division: on CUDA a Python scalar divisor is
    turned into a product with its rounded reciprocal, a 0-dim tensor is
    not."""
    if x.device.type == "cpu":
        return x / divisor
    return x / torch.full((), divisor, dtype=torch.float32, device=x.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (some CPU builds are an ulp off)."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


# --- the directional depth blur --------------------------------------------

def _edge_pad(x, dim, left, right):
    n = x.shape[dim]
    lshape, rshape = list(x.shape), list(x.shape)
    lshape[dim], rshape[dim] = left, right
    return torch.cat([x.narrow(dim, 0, 1).expand(lshape), x,
                      x.narrow(dim, n - 1, 1).expand(rshape)], dim=dim)


def _window_sum(xp, dim, n, out_len):
    acc = xp.narrow(dim, 0, out_len)
    for k in range(1, n):
        acc = acc + xp.narrow(dim, k, out_len)
    return acc


def box_blur_w(x, n):
    """Box mean of width n along W, edge-replicated (scipy 'nearest')."""
    if n <= 1:
        return x
    xp = _edge_pad(x, -1, n - 1 - n // 2, n // 2)
    return true_divide(_window_sum(xp, -1, n, x.shape[-1]), n)


def box_blur_h(x, radius):
    """Box mean of width 2 * radius + 1 along H, edge-replicated."""
    if radius <= 0:
        return x
    n = 2 * radius + 1
    return true_divide(_window_sum(_edge_pad(x, -2, radius, radius), -2, n, x.shape[-2]), n)


def _symmetric_pad1(x, dim):
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 0, 1), x, x.narrow(dim, n - 1, 1)], dim=dim)


def sobel_x(x):
    """Sobel-x with symmetric padding: [1, 2, 1] along H, then the central
    difference along W."""
    xs = _symmetric_pad1(x, -2)
    smooth = xs[..., :-2, :] + 2.0 * xs[..., 1:-1, :] + xs[..., 2:, :]
    sw = _symmetric_pad1(smooth, -1)
    return sw[..., :, 2:] - sw[..., :, :-2]


def edge_masks(depth, edge_threshold):
    """Rising (left eye) and falling (right eye) edges whose strength
    clip(|g| / (10 * threshold), 0, 1) is over 0.5."""
    grad = sobel_x(depth)
    t10 = float(np.float32(10.0) * np.float32(edge_threshold))
    strength = torch.clamp(true_divide(grad.abs(), t10), 0.0, 1.0)
    return (grad > 0) & (strength > 0.5), (grad < 0) & (strength > 0.5)


def edge_distance(mask):
    """Distance from each column to the nearest True of its row (1e9 stands
    for none on a side)."""
    cols = torch.arange(mask.shape[-1], dtype=torch.float32, device=mask.device)
    l_col = torch.cummax(torch.where(mask, cols, -LARGE), dim=-1).values
    r_col = torch.cummin(torch.where(mask, cols, LARGE).flip(-1), dim=-1).values.flip(-1)
    return torch.minimum(cols - l_col, r_col - cols)


def distance_weight(dist, mask_radius, falloff):
    return torch.pow(torch.clamp(1.0 - true_divide(dist, mask_radius), 0.0, 1.0), falloff)


def directional_blur(depth, s: Dict):
    """The two eyes' blurred depths of [B, H, W] 0-255 depth."""
    strength = s["depth_blur_strength"]
    if not s["depth_map_blur"] or strength <= 0:
        return depth, depth
    radius = int(strength)  # the node passes the strength as the mask width
    falloff = float(np.float32(s["depth_blur_falloff"]))
    ml, mr = edge_masks(depth, s["depth_blur_edge_threshold"])
    wl = distance_weight(edge_distance(ml), radius, falloff)
    wr = distance_weight(edge_distance(mr), radius, falloff)
    vert = int(s["depth_blur_vert_smooth"])
    if vert > 0:
        wl = torch.clamp(box_blur_h(wl, vert), 0.0, 1.0)
        wr = torch.clamp(box_blur_h(wr, vert), 0.0, 1.0)
    blurred = box_blur_w(depth, int(round(strength)))
    return wl * blurred + (1.0 - wl) * depth, wr * blurred + (1.0 - wr) * depth


# --- depth to offsets -------------------------------------------------------

def normalize_between(d, dmin, dmax):
    rng = dmax - dmin
    return torch.where(rng > 1e-6, (d - dmin) / torch.clamp(rng, min=1e-6), 0.0)


def signed_power(x, exponent):
    return torch.sign(x) * torch.pow(torch.abs(x), exponent)


# --- the gpu_warp eye: z-buffered forward warp -----------------------------

def _nearest_true_left(valid):
    cols = torch.arange(valid.shape[-1], device=valid.device)
    return torch.cummax(torch.where(valid, cols, -1), dim=-1).values


def _warp_window(offset, max_disp):
    r_static = max_disp + 2
    d_lo = torch.floor(-offset.amax(-1, keepdim=True) - 1.0).long()
    d_hi = torch.ceil(-offset.amin(-1, keepdim=True)).long()
    return d_lo.clamp(min=-r_static), d_hi.clamp(max=r_static)


def _zbuffer(offset, nd, max_disp):
    """Per column the nearest covering segment's source position and depth
    (strict z > best + 1e-6, lowest source first); -1 where none."""
    n, w = offset.shape
    dev = offset.device
    r = max_disp + 2
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    dest = cols + offset
    conn = (offset[:, 1:] - offset[:, :-1]).abs() < GRADIENT_THRESHOLD
    dl, dr = dest[:, :-1], dest[:, 1:]
    width = dr - dl
    segs = torch.stack([dl, torch.where(width.abs() < 1e-4, 1.0, width), nd[:, :-1], nd[:, 1:],
                        torch.floor(torch.minimum(dl, dr))])
    segs = torch.nn.functional.pad(segs, (r, r + 1))
    conn = torch.nn.functional.pad(conn, (r, r + 1))
    d_lo, d_hi = _warp_window(offset, max_disp)
    zbest = torch.full((n, w), -1.0, dtype=torch.float32, device=dev)
    src = torch.full((n, w), -1.0, dtype=torch.float32, device=dev)
    idx = torch.arange(w, device=dev)
    for d in range(int(d_lo.min()), int(d_hi.max()) + 1):
        dl_t, sw_t, zl_t, zr_t, ms_t = segs[:, :, r + d:r + d + w]
        i = idx + d
        frac = (cols - dl_t) / sw_t
        zz = zl_t * (1.0 - frac) + zr_t * frac
        ok = (conn[:, r + d:r + d + w] & (i >= 0) & (i <= w - 2) & (frac >= 0.0)
              & (frac < 1.0) & (cols - ms_t < MAX_STRETCH) & (d >= d_lo) & (d <= d_hi))
        better = ok & (zz > zbest + 1e-6)
        zbest = torch.where(better, zz, zbest)
        src = torch.where(better, i.float() + frac, src)
    return src, zbest


def _warp_finish(src, zbest, image, max_disp):
    """Gaps filled between their borders with a sqrt bias to the background,
    then bilinear taps: warped [N, W, C]."""
    n, w = src.shape
    dev = src.device
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    colsi = torch.arange(w, device=dev)
    filled = src >= 0.0
    gap = ~filled
    ln = _nearest_true_left(filled)
    has_l = ln >= 0
    left_src = src.gather(-1, ln.clamp(min=0))
    left_z = zbest.gather(-1, ln.clamp(min=0))
    rn = torch.where(filled, colsi, -1).amax(-1, keepdim=True)  # the row's last filled column
    rn_c = rn.clamp(0, w - 1)
    right_src, right_z = src.gather(-1, rn_c), zbest.gather(-1, rn_c)
    has_r = colsi <= rn
    left_dist = cols - ln.float()
    right_dist = (rn - colsi).float()
    t = left_dist / torch.clamp(left_dist + right_dist, min=1.0)
    t = torch.where(~has_l, 1.0, t)
    t = torch.where(~has_r, 0.0, t)
    t_b = torch.where(left_z < right_z, sqrt(t), 1.0 - sqrt(1.0 - t))
    src = torch.where(gap & (has_l | has_r), left_src * (1.0 - t_b) + right_src * t_b, src)
    bil = max_disp + 126
    src = torch.minimum(torch.maximum(src, cols - bil), cols + bil).clamp(0.0, w - 1.0)
    x0 = torch.floor(src)
    fr = (src - x0)[..., None]
    i0 = x0.long()
    i1 = (i0 + 1).clamp(max=w - 1)
    c = image.shape[-1]
    g0 = image.gather(1, i0[..., None].expand(n, w, c)).float()
    g1 = image.gather(1, i1[..., None].expand(n, w, c)).float()
    return (g0 * (1.0 - fr) + g1 * fr).to(image.dtype)


def warp_eye(image, depth, div_px, sep_px, s: Dict):
    """One eye of gpu_warp: image [B, H, W, C] 0-1, depth [B, H, W]."""
    exp, conv = s["stereo_offset_exponent"], s["convergence_point"]
    cmax = max(abs(conv), abs(1.0 - conv))
    max_disp = int(math.ceil((cmax ** exp) * abs(div_px) + abs(sep_px))) + 4
    b, h, w, c = image.shape
    rows = depth.float().reshape(b * h, w)
    dmin, dmax = torch.aminmax(rows.reshape(b, h * w), dim=-1)
    nd = normalize_between(rows.reshape(b, h, w), dmin[:, None, None], dmax[:, None, None])
    off = signed_power(nd - conv, exp) * div_px + sep_px
    src, zbest = _zbuffer(off.reshape(b * h, w), nd.reshape(b * h, w), max_disp)
    out = _warp_finish(src, zbest, image.reshape(b * h, w, c), max_disp)
    return out.reshape(b, h, w, c)


# --- the polylines_sharp eye: exact sub-interval integration ---------------

def _poly_window(x, max_disp):
    w = x.shape[-1]
    m = x - (torch.arange(w, dtype=torch.float32, device=x.device) + 0.5)
    r_static = max_disp + 4
    d_lo = torch.floor(-m.amax(-1, keepdim=True)).long() - 2
    d_hi = torch.ceil(-m.amin(-1, keepdim=True)).long() + 2
    return d_lo.clamp(min=-r_static), d_hi.clamp(max=r_static)


def _searchsorted_left_aligned(xs, ppc, win):
    p = xs.shape[-1]
    lanes = torch.arange(p, dtype=torch.int32, device=xs.device)
    queries = torch.div(lanes, ppc, rounding_mode="floor").float()
    lo = torch.clamp(lanes - win, min=0).expand(xs.shape)
    hi = torch.clamp(lanes + win, max=p).expand(xs.shape)
    for _ in range(max(1, math.ceil(math.log2(2 * win + 2))) + 1):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = xs.gather(-1, torch.clamp(mid, 0, p - 1).long())
        cont = lo < hi
        go = cont & (v < queries)
        lo, hi = torch.where(go, mid + 1, lo), torch.where(cont & ~go, mid, hi)
    return lo


def _pieces(x, sharp, max_disp):
    """Per pixel, the K sub-intervals between the sorted points inside
    [col, col + 1), eps-shrunk: (centers, widths, valids)."""
    n, w = x.shape
    ppc, hw = (2, 0.45) if sharp else (1, 0.0)
    colsf = torch.arange(w, dtype=torch.float32, device=x.device)
    pts = torch.stack([x - hw, x + hw], dim=-1).reshape(n, 2 * w) if sharp else x
    xs = torch.sort(pts, dim=-1).values
    p_total = ppc * w
    q0 = _searchsorted_left_aligned(xs, ppc, ppc * (max_disp + 3))[..., ::ppc]

    def at(q):
        v = xs.gather(-1, torch.clamp(q - 1, 0, p_total - 1).long())
        v = torch.where(q <= 0, -1.0 * w, v)
        return torch.where(q >= p_total + 1, 2.0 * w, v)

    centers, sigs, valids = [], [], []
    xq = at(q0)
    for k in range(MAX_PIECES):
        xq1 = at(q0 + k + 1)
        valid = (xq < colsf + 1.0) if k > 0 else torch.ones_like(xq, dtype=torch.bool)
        f_k = torch.maximum(colsf, xq) + EPS
        sig = (torch.minimum(colsf + 1.0, xq1) - EPS) - f_k
        centers.append(f_k + 0.5 * sig)
        sigs.append(sig)
        valids.append(valid.float())
        xq = xq1
    return centers, sigs, valids


def _winner_scan(colors, x, cl, centers, sigs, valids, sharp, max_disp):
    """Per piece, the active segment of greatest closeness (strict, 0 < ip <
    1; else the active one of least x0) gives its colour times the piece's
    width to a 0.5-biased sum, truncated."""
    n, w = x.shape
    dev = x.device
    hw = 0.45 if sharp else 0.0
    colsi = torch.arange(w, device=dev)
    d_lo_row, d_hi_row = _poly_window(x, max_disp)
    d_lo, d_hi = int(d_lo_row.min()), int(d_hi_row.max())
    img_p = colors.float().movedim(-1, 0)
    c = img_p.shape[0]
    r = max_disp + 5
    planes = torch.nn.functional.pad(torch.cat([x[None], cl[None], img_p]), (r, r + 1))

    def scan_piece(center):
        def consider(state, x0, x1, cl0, cl1, col_l, col_r, cand_ok, flat=False):
            best_cl, best_col, fb_x0, fb_col = state
            active = cand_ok & (x0 < center) & (x1 >= center)
            denom = x1 - x0
            ip = (center - x0) / torch.where(denom == 0.0, 1.0, denom)
            clp = (1.0 - ip) * cl0 + ip * cl1
            qual = active & (ip > 0.0) & (ip < 1.0)
            cval = col_l if flat else col_l * (1.0 - ip[None]) + col_r * ip[None]
            better = qual & (clp > best_cl)
            best_cl = torch.where(better, clp, best_cl)
            best_col = torch.where(better[None], cval, best_col)
            fb_take = active & (x0 < fb_x0)
            return (best_cl, best_col, torch.where(fb_take, x0, fb_x0),
                    torch.where(fb_take[None], cval, fb_col))

        zeros = torch.zeros((c, n, w), dtype=torch.float32, device=dev)
        state = (torch.full((n, w), -EPS, dtype=torch.float32, device=dev), zeros,
                 torch.full((n, w), 1e30, dtype=torch.float32, device=dev), zeros)
        ok = torch.ones((n, w), dtype=torch.bool, device=dev)
        state = consider(state, -1.0 * w, x[:, :1] - hw, 0.0, cl[:, :1], img_p[..., :1],
                         img_p[..., :1], ok, flat=True)
        state = consider(state, x[:, -1:] + hw, 2.0 * w, cl[:, -1:], 0.0, img_p[..., -1:],
                         img_p[..., -1:], ok, flat=True)
        for d in range(d_lo, d_hi + 1):
            cur = planes[..., r + d:r + d + w]
            nxt = planes[..., r + d + 1:r + d + 1 + w]
            cp = colsi + d
            in_win = (d >= d_lo_row) & (d <= d_hi_row)
            if sharp:
                state = consider(state, cur[0] - hw, cur[0] + hw, cur[1], cur[1], cur[2:],
                                 cur[2:], (cp >= 0) & (cp <= w - 1) & in_win, flat=True)
            state = consider(state, cur[0] + hw, nxt[0] - hw, cur[1], nxt[1], cur[2:],
                             nxt[2:], (cp >= 0) & (cp <= w - 2) & in_win)
        best_cl, best_col, _, fb_col = state
        return torch.where((best_cl > -EPS)[None], best_col, fb_col)

    acc = torch.full((c, n, w), 0.5, dtype=torch.float32, device=dev)
    for k in range(len(centers)):
        if not bool((valids[k] > 0.5).any()):
            continue
        acc = acc + torch.where(valids[k][None] > 0.5, scan_piece(centers[k]) * sigs[k][None],
                                0.0)
    return torch.trunc(torch.clamp(acc.movedim(0, -1), 0.0, 255.0))


def polylines_eye(image_u8, depth, div_pct, sep_pct, s: Dict, sharp=True):
    """One eye of the exact polylines fill: image [B, H, W, C] float32
    holding uint8 values, depth [B, H, W]."""
    w = image_u8.shape[-2]
    d = depth.float()
    nd = normalize_between(d, d.amin(dim=(-2, -1), keepdim=True),
                           d.amax(dim=(-2, -1), keepdim=True)) - s["convergence_point"]
    div_px, sep_px = (div_pct / 100.0) * w, (sep_pct / 100.0) * w
    coord = signed_power(nd, s["stereo_offset_exponent"]) * div_px
    max_disp = int(math.ceil(abs(div_px) + abs(sep_px))) + 4
    b, h, _ = coord.shape
    c = image_u8.shape[-1]
    coord = coord.reshape(b * h, w)
    cols = torch.arange(w, dtype=torch.float32, device=coord.device)
    x = cols + 0.5 + coord + float(sep_px)
    centers, sigs, valids = _pieces(x, sharp, max_disp)
    out = _winner_scan(image_u8.float().reshape(b * h, w, c), x, torch.abs(coord), centers,
                       sigs, valids, sharp, max_disp)
    return out.reshape(b, h, w, c)


# --- the pass and its output -------------------------------------------------

def stereo_pass(image: torch.Tensor, gray: torch.Tensor, s: Dict,
                depth_dtype: torch.dtype = torch.float32, chunk_max=None) -> torch.Tensor:
    """image [B, H, W, 3] 0-1 float32, gray [B, H, W] depth (0-1 or 0-255).
    Returns the packed left-right pair [B, H, 2W, 3] in 0-1, as the
    pipeline gives it. The depth is taken as 0-1, and scaled to 0-255,
    where the largest depth of the whole chunk is at most 1: `chunk_max`
    gives it where these frames are a sample of their chunk. Every other
    step works frame by frame."""
    fill = UI_FILLS[s["fill_technique"]]
    if s["modes"] != "left-right" or s["stereo_balance"] != 0.0:
        raise ValueError("the reference packs left-right with balance 0 only")
    depth = gray.float().to(depth_dtype)
    depth255 = torch.where((depth.max() if chunk_max is None else chunk_max) <= 1.0,
                           depth * 255.0, depth)
    left_d, right_d = (t.float() for t in directional_blur(depth255, s))
    div, sep = float(s["divergence"]), float(s["separation"])
    w = image.shape[-2]
    if fill == "gpu_warp":
        left = warp_eye(image, left_d, (div / 100.0) * w, -((sep / 100.0) * w), s)
        right = warp_eye(image, right_d, -((div / 100.0) * w), (sep / 100.0) * w, s)
        return torch.clamp(torch.cat([left, right], dim=-2), 0.0, 1.0)
    src = torch.trunc(torch.clamp(image * 255.0, 0.0, 255.0))
    left = polylines_eye(src, left_d, div, -sep, s)
    right = polylines_eye(src, right_d, -div, sep, s)
    return true_divide(torch.cat([left, right], dim=-2), 255.0)


def video_chunk(bgr_u8: np.ndarray, dep_bgr_u8: np.ndarray, s: Dict, device,
                depth_dtype: torch.dtype = torch.float32, frames=None) -> np.ndarray:
    """[B, H, W, 3] BGR uint8 frames and grey depth frames as BGR uint8 ->
    the packed pair as BGR uint8 [B, H, 2W, 3] (host), of the chunk's
    `frames` (a list of indices; all by default)."""
    frames = list(range(len(bgr_u8))) if frames is None else list(frames)
    d = torch.from_numpy(dep_bgr_u8).to(device).float()
    gray = true_divide(GRAY[0] * d[..., 2] + GRAY[1] * d[..., 1] + GRAY[2] * d[..., 0], 255.0)
    chunk_max = gray.to(depth_dtype).max()
    bgr = torch.from_numpy(bgr_u8[frames]).to(device)
    img = true_divide(bgr.flip(-1).float(), 255.0)
    stereo = stereo_pass(img, gray[frames], s, depth_dtype, chunk_max)
    out = torch.trunc(torch.clamp(stereo * 255.0, 0.0, 255.0)).to(torch.uint8).flip(-1)
    return out.cpu().numpy()

