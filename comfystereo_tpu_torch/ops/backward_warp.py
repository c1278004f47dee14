"""Backward (inverse-mapping) warp family and disocclusion tooling.

Port of `comfystereo_tpu/ops/backward_warp.py`, the equivalents of the
reference's grid_sample-based warps and their helper ops
(stereoimage_generation.py):

  * backward_warp            <- apply_stereo_divergence_gpu (:52-119)
  * backward_warp_padded     <- apply_stereo_divergence_gpu_with_fill (:923-1002)
  * warp_and_fill            <- warp_and_fill_gpu (:122-274), edge-stretch fill
  * forward_gap_mask         <- compute_forward_mask_gpu (:692-757)
  * detect_disocclusions     <- detect_disocclusions_gpu (:807-857)
  * interpolate_fill         <- interpolate_fill_gpu (:860-920)

The warp grid is 1-D (horizontal only), so the sampling is the JAX
package's explicit bilinear gather along W, `(1 - fr) * img[i0] + fr *
img[i1]` after clipping or reflecting the source column, copied form for
form (`grid_sample` would compute its own coordinates and round
differently); nearest-valid searches are prefix scans. The JAX package
computes these outside any Pallas kernel, so they are plain PyTorch ops on
the device of their inputs. All ops are batched [B, ...].
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import depth as depth_ops
from . import fills, scan
from ..device import true_divide


def _take_w(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis over the last axis."""
    return torch.gather(values, -1, idx.long())


def _sample_w(image_nhwc: torch.Tensor, src_x: torch.Tensor,
              padding: str = "border") -> torch.Tensor:
    """Bilinear sample along W. padding: border | zeros | reflection."""
    b, h, w, c = image_nhwc.shape
    if padding == "reflection":
        # reflect around [0, w-1] (align_corners=True convention); the
        # floored modulo in XLA's form: fmod, then + period where the
        # remainder's sign differs from the period's
        period = 2.0 * (w - 1)
        x = torch.fmod(src_x, period)
        x = torch.where((x != 0) & (x < 0), x + period, x)
        x = torch.where(x > (w - 1), period - x, x)
    else:
        x = torch.clamp(src_x, 0.0, w - 1.0)
    x0 = torch.floor(x)
    fr = (x - x0)[..., None]
    i0 = torch.clamp(x0.to(torch.int32), 0, w - 1)
    i1 = torch.clamp(i0 + 1, max=w - 1)
    idx0 = i0.long()[..., None].expand(b, h, w, c)
    idx1 = i1.long()[..., None].expand(b, h, w, c)
    out = (torch.gather(image_nhwc, 2, idx0) * (1 - fr)
           + torch.gather(image_nhwc, 2, idx1) * fr)
    if padding == "zeros":
        inb = ((src_x >= 0) & (src_x <= w - 1))[..., None]
        out = torch.where(inb, out, 0.0)
    return out


def _offsets(depth, divergence_px, separation_px, exponent, convergence):
    nd = depth_ops.normalize_depth(depth)
    return nd, depth_ops.pixel_offsets(nd, divergence_px, separation_px, exponent,
                                       convergence, prenormalized=True)


def _cols(w: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(w, dtype=torch.float32, device=like.device)


def backward_warp(image_nhwc: torch.Tensor, depth: torch.Tensor,
                  divergence_px: float, separation_px: float = 0.0,
                  stereo_offset_exponent: float = 1.0,
                  convergence_point: float = 0.5) -> torch.Tensor:
    """Inverse-map stereo shift: out[x] = img[x - offset(x)] (spec :52-119)."""
    _, off = _offsets(depth, divergence_px, separation_px, stereo_offset_exponent,
                      convergence_point)
    src = _cols(image_nhwc.shape[2], off) - off
    return _sample_w(image_nhwc, src, "border")


def backward_warp_padded(image_nhwc: torch.Tensor, depth: torch.Tensor,
                         divergence_px: float, separation_px: float = 0.0,
                         stereo_offset_exponent: float = 1.0,
                         convergence_point: float = 0.5, fill_mode: str = "border"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward warp with configurable padding plus in-bounds validity mask
    (spec :923-1002)."""
    _, off = _offsets(depth, divergence_px, separation_px, stereo_offset_exponent,
                      convergence_point)
    w = image_nhwc.shape[2]
    src = _cols(w, off) - off
    warped = _sample_w(image_nhwc, src, fill_mode)
    valid = (src >= 0) & (src <= w - 1)
    return warped, valid


def _shift_or(base: torch.Tensor, other: torch.Tensor, right: bool) -> torch.Tensor:
    """base with base[..., 1:] |= other (right=True) or base[..., :-1] |=
    other (right=False); other is one column narrower."""
    if right:
        return torch.cat([base[..., :1], base[..., 1:] | other], dim=-1)
    return torch.cat([base[..., :-1] | other, base[..., -1:]], dim=-1)


def forward_gap_mask(depth: torch.Tensor, divergence_px: float,
                     separation_px: float = 0.0, stereo_offset_exponent: float = 1.0,
                     convergence_point: float = 0.5,
                     dilate_threshold: float = 1.5) -> torch.Tensor:
    """Pixel-precise forward-mapping gap mask: destinations that receive no
    source pixel, dilated one pixel at depth edges (spec :692-757)."""
    _, off = _offsets(depth, divergence_px, separation_px, stereo_offset_exponent,
                      convergence_point)
    w = off.shape[-1]
    dest = (_cols(w, off) + off).to(torch.int32)
    valid = (dest >= 0) & (dest < w)
    hits = fills.scatter_add_w(dest, valid.float(), valid, w)
    gap = hits < 0.5

    grad = torch.abs(off[..., 1:] - off[..., :-1]) > dilate_threshold
    edge = torch.cat([grad, torch.zeros_like(gap[..., :1])], dim=-1)
    edge = _shift_or(edge, grad, right=True)
    dil = _shift_or(gap, gap[..., :-1] & edge[..., 1:], right=True)
    dil = _shift_or(dil, gap[..., 1:] & edge[..., :-1], right=False)
    return dil


def detect_disocclusions(depth01: torch.Tensor, src_x: torch.Tensor,
                         threshold: float = 0.02) -> torch.Tensor:
    """Two-signal disocclusion detector (spec :807-857):
    1) nearest-warped depth exceeds output depth by `threshold`;
    2) warp-field stretch > 3x the pixel step."""
    w = depth01.shape[-1]
    i_near = torch.clamp(torch.round(src_x).to(torch.int32), 0, w - 1)
    warped_depth = _take_w(depth01, i_near)
    depth_sig = (warped_depth - depth01) > threshold

    grad = torch.abs(src_x[..., 1:] - src_x[..., :-1])
    grad = torch.cat([grad, grad[..., -1:]], dim=-1)
    stretch_sig = grad > 3.0
    return depth_sig | stretch_sig


def interpolate_fill(image_nhwc: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Fill masked pixels by linear interpolation between the nearest valid
    border pixels in the row (spec :860-920)."""
    w = image_nhwc.shape[2]
    valid = ~mask
    chans = torch.movedim(image_nhwc, -1, 0)
    valid_c = valid[None].expand(chans.shape)
    (lv,), has_l = scan.forward_fill((chans,), valid_c)
    (rv,), has_r = scan.backward_fill((chans,), valid_c)
    has_l, has_r = has_l[0], has_r[0]
    cols = _cols(w, image_nhwc)
    ln = scan.nearest_true_left(valid)
    rn = scan.nearest_true_right(valid)
    ld = cols - ln.float()
    rd = rn.float() - cols
    t = ld / torch.clamp(ld + rd, min=1.0)
    t = torch.where(~has_l, 1.0, t)
    t = torch.where(~has_r, 0.0, t)
    fill = lv * (1 - t) + rv * t
    return torch.movedim(torch.where(mask[None], fill, chans), 0, -1)


def warp_and_fill(image_nhwc: torch.Tensor, depth: torch.Tensor,
                  divergence_px: float, separation_px: float = 0.0,
                  stereo_offset_exponent: float = 1.0,
                  convergence_point: float = 0.5,
                  stretch_pixels: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp with built-in edge-stretch fill (spec :122-274): gap pixels sample
    from smoothly interpolated source positions that stretch a few valid
    border pixels across each half-gap, blended with a smoothstep."""
    _, off = _offsets(depth, divergence_px, separation_px, stereo_offset_exponent,
                      convergence_point)
    w = image_nhwc.shape[2]
    cols = _cols(w, off)
    gap = forward_gap_mask(depth, divergence_px, separation_px, stereo_offset_exponent,
                           convergence_point)
    src = cols - off

    valid = ~gap
    ln = scan.nearest_true_left(valid)
    rn = scan.nearest_true_right(valid)
    has_l = ln >= 0
    has_r = rn < w
    ld = cols - ln.float()
    rd = rn.float() - cols
    total = torch.clamp(ld + rd, min=1.0)
    half_gap = total * 0.5

    ln_c = torch.clamp(ln, 0, w - 1)
    rn_c = torch.clamp(rn, 0, w - 1)
    l_base = _take_w(src, ln_c)
    l_deep = _take_w(src, torch.clamp(ln_c - stretch_pixels, 0, w - 1))
    lt = torch.clamp(ld / half_gap, 0.0, 1.0)
    l_stretch = l_base * (1 - lt) + l_deep * lt
    r_base = _take_w(src, rn_c)
    r_deep = _take_w(src, torch.clamp(rn_c + stretch_pixels, 0, w - 1))
    rt = torch.clamp(rd / half_gap, 0.0, 1.0)
    r_stretch = r_base * (1 - rt) + r_deep * rt

    t = ld / total
    t = torch.where(~has_l, 1.0, t)
    t = torch.where(~has_r, 0.0, t)
    blend = torch.clamp(true_divide(t - 0.35, 0.3), 0.0, 1.0)
    blend = blend * blend * (3.0 - 2.0 * blend)          # smoothstep
    gap_src = l_stretch * (1 - blend) + r_stretch * blend
    src = torch.where(gap, gap_src, src)
    return _sample_w(image_nhwc, src, "border"), gap
