"""Exact z-buffer forward warp of image rows (the gpu_warp fill technique).

Kernel: `csrc/warp_kernel.cu`, CUDA C++ for sm_90a, replacing the Pallas
kernel `comfystereo_tpu/pallas/warp_kernel.py:warp_scanline`. One CTA per
image row. Each segment (columns i and i + 1) keeps in shared memory the
interval of columns it can cover; each warp narrows the row's candidate
window to the segments whose intervals meet its 32 columns; each column
walks that window in ascending source order and forms the exact test and the strict `zz > zbest + 1e-6` rule only
inside a segment's interval; ballot words and warp-wide searches find the
gap borders; the bilinear taps read the HWC image directly. It is bound by
bytes: 29 B per pixel in float32 through the fused entry. See the source's
header for the design and for why the interval drops nothing.

Two entries, each launching the kernel for CUDA tensors and running its
plain version for CPU tensors:
- `warp_rows(offset, nd, image, ...)`, the Pallas kernel's contract; plain
  version `warp_rows_plain`, the PyTorch translation of the JAX package's
  `ops/warp.py:_forward_warp_monotone` in its float32 expression forms (no
  lerp or addcmul, which may fuse into FMAs), with one addition: each row's
  candidates are limited to that row's own window, as the kernel limits
  them, which the tests show changes no winner;
- `warp_rows_fused(depth, dmin, dmax, image, ...)`, which `ops/warp.py`
  launches: it forms the normalised depth and the offsets in the kernel;
  plain version `warp_rows_fused_plain`, the composition normalize ->
  offsets -> `warp_rows_plain`.

The kernel takes any C (the taps loop over the channels) and rows of up to
`MAX_WIDTH` columns: rows whose planes fit in one CTA's shared memory
(`SHARED_WIDTH`, `smem_bytes`) keep them there, one row per CTA; wider rows
keep them in a device-memory workspace of one row per CTA, and each CTA
walks rows at a stride of the grid. A row over MAX_WIDTH raises on the card
before any launch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..device import sqrt
from . import _common
from ..ops import depth as depth_ops
from ..ops import scan

LAUNCHES = 0  # kernel launches since the last reset (plain-version calls don't count)

_COLOR_DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = _common.SMEM_LIMIT
_STATIC_SMEM = 64  # the kernel's own
MAX_WIDTH = 65536  # the kernel's intervals pack a column into 16 bits
_CTAS_PER_SM = 5   # the kernel's launch bounds


def plane_words(w: int) -> int:
    """4-byte words of one row's planes: five planes (dl, nd, interval, src,
    z) and one bit per column."""
    return 5 * w + (w + 31) // 32


def smem_bytes(w: int) -> int:
    """Shared memory of one CTA for a row of w columns held in shared
    memory: its planes and 64 static bytes (the row's offset range, per
    warp)."""
    return 4 * plane_words(w) + _STATIC_SMEM


def _shared_width() -> int:
    w = SMEM_LIMIT // 20
    while smem_bytes(w) > SMEM_LIMIT:
        w -= 1
    return w


SHARED_WIDTH = _shared_width()  # 11,547 columns


def check_launch(name: str, image: torch.Tensor, w: int) -> None:
    """Raise unless the CUDA kernel takes the colour rows `image` of w
    columns: a CUDA tensor, contiguous, rows of at most MAX_WIDTH columns."""
    if w > MAX_WIDTH:
        raise ValueError(f"{name}: a row of {w} columns is over the {MAX_WIDTH} columns the "
                         "CUDA kernel takes")
    if image.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {image.device}")
    if not image.is_contiguous():
        raise ValueError(f"{name}: image must be contiguous")


def _window(offset: torch.Tensor, max_disp: int):
    """Per-row candidate window [d_lo, d_hi] of d = i - col, as [N, 1] ints:
    a segment i covering col has col - i within the row's offset range."""
    r_static = max_disp + 2
    d_lo = torch.floor(-offset.amax(-1, keepdim=True) - 1.0).long()
    d_hi = torch.ceil(-offset.amin(-1, keepdim=True)).long()
    return d_lo.clamp(min=-r_static), d_hi.clamp(max=r_static)


def _segments(offset: torch.Tensor, nd: torch.Tensor, gradient_threshold: float, r: int):
    """Segment planes [5, N, W + 2r] (dl, safe width, zl, zr, mstart) and
    the connection mask [N, W + 2r], padded with r columns of no segment
    on each side and column W - 1, which holds none."""
    w = offset.shape[-1]
    cols = torch.arange(w, dtype=torch.float32, device=offset.device)
    dest = cols + offset
    conn = (offset[:, 1:] - offset[:, :-1]).abs() < gradient_threshold
    dl = dest[:, :-1]
    dr = dest[:, 1:]
    width = dr - dl
    safe_w = torch.where(width.abs() < 1e-4, 1.0, width)
    mstart = torch.floor(torch.minimum(dl, dr))
    segs = torch.stack([dl, safe_w, nd[:, :-1], nd[:, 1:], mstart])
    return (torch.nn.functional.pad(segs, (r, r + 1)),
            torch.nn.functional.pad(conn, (r, r + 1)))


def _candidate(segs, conn, d: int, r: int, max_stretch: int):
    """Segment i = col + d for every column: (accepted by the exact tests,
    zz, source position), in the plain version's float32 forms."""
    w = segs.shape[-1] - 2 * r
    cols = torch.arange(w, dtype=torch.float32, device=segs.device)
    i = torch.arange(w, device=segs.device) + d
    dl_t, sw_t, zl_t, zr_t, ms_t = segs[:, :, r + d:r + d + w]
    frac = (cols - dl_t) / sw_t
    zz = zl_t * (1.0 - frac) + zr_t * frac
    ok = (conn[:, r + d:r + d + w] & (i >= 0) & (i <= w - 2)
          & (frac >= 0.0) & (frac < 1.0) & (cols - ms_t < max_stretch))
    return ok, zz, i.float() + frac


def _zbuffer(offset, nd, gradient_threshold, max_stretch, max_disp, allowed=None):
    """The windowed z-max over candidate segments in ascending source index:
    (src, zbest) [N, W], -1 where no segment covers the column. `allowed(d)`
    may narrow the candidates further (the kernel's model)."""
    n, w = offset.shape
    r = max_disp + 2
    segs, conn = _segments(offset, nd, gradient_threshold, r)
    d_lo, d_hi = _window(offset, max_disp)
    zbest = torch.full((n, w), -1.0, dtype=torch.float32, device=offset.device)
    src = torch.full((n, w), -1.0, dtype=torch.float32, device=offset.device)
    for d in range(int(d_lo.min()), int(d_hi.max()) + 1):
        ok, zz, srcv = _candidate(segs, conn, d, r, max_stretch)
        ok = ok & (d >= d_lo) & (d <= d_hi)
        if allowed is not None:
            ok = ok & allowed(d)
        better = ok & (zz > zbest + 1e-6)
        zbest = torch.where(better, zz, zbest)
        src = torch.where(better, srcv, src)
    return src, zbest


def _finish(src, zbest, image, max_disp):
    """Disocclusion fill, clips and bilinear taps: (warped [N, W, C] in
    image's dtype, gap [N, W] bool)."""
    n, w = src.shape
    dev = src.device
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    colsi = torch.arange(w, device=dev)
    filled = src >= 0.0
    gap = ~filled

    # Interpolate source positions between the gap's borders with a sqrt
    # bias toward the background (lower z) side. The right border is the
    # row's rightmost filled column (reference :399-404).
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
    t_biased = torch.where(left_is_bg, sqrt(t), 1.0 - sqrt(1.0 - t))
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


def warp_rows_plain(offset: torch.Tensor, nd: torch.Tensor, image: torch.Tensor,
                    gradient_threshold: float, max_stretch: int, max_disp: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """offset, nd: [N, W] float32; image: [N, W, C]. Returns (warped
    [N, W, C] in image's dtype, gap [N, W] bool)."""
    src, zbest = _zbuffer(offset, nd, gradient_threshold, max_stretch, max_disp)
    return _finish(src, zbest, image, max_disp)


def _check_image(name: str, image: torch.Tensor, n: int, w: int, device) -> None:
    if image.dim() != 3 or tuple(image.shape[:2]) != (n, w):
        raise ValueError(f"{name}: image must be [{n}, {w}, C], got {tuple(image.shape)}")
    if image.dtype not in _COLOR_DTYPES:
        raise TypeError(f"{name}: colour dtype {image.dtype} not in {_COLOR_DTYPES}")
    if image.device != device:
        raise ValueError(f"{name}: image and rows on different devices")


def _launch(entry: str, before, image: torch.Tensor, after):
    """Launch a C entry, `entry(*before, image, out, gap, workspace, ctas, n,
    w, c, *after, stream)`, on the outputs it fills: (warped, gap). Rows
    over SHARED_WIDTH get a grid of resident CTAs and their workspace."""
    global LAUNCHES
    from . import _build

    n, w, c = image.shape
    out = torch.empty_like(image)
    gap = torch.empty((n, w), dtype=torch.bool, device=image.device)
    ctas, workspace = 0, None
    if w > SHARED_WIDTH:
        ctas = min(n, _common.resident_ctas(image.device, _CTAS_PER_SM))
        workspace = torch.empty(ctas * plane_words(w), dtype=torch.int32, device=image.device)
    suffix = "f32" if image.dtype == torch.float32 else "bf16"
    fn = getattr(_build.library("warp_kernel"), f"{entry}_{suffix}")
    err = _common.launch(fn, *before, image.data_ptr(), out.data_ptr(), gap.data_ptr(),
                         None if workspace is None else workspace.data_ptr(), ctas,
                         n, w, c, *after, device=image.device)
    _build.check(err, f"{entry} kernel launch")
    LAUNCHES += 1
    return out, gap


def warp_rows(offset: torch.Tensor, nd: torch.Tensor, image: torch.Tensor, *,
              gradient_threshold: float, max_stretch: int, max_disp: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp [N, W] rows: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. offset, nd: [N, W] float32, contiguous; image:
    [N, W, C] float32 or bfloat16, contiguous."""
    _common.check_rows("warp_rows", (offset, nd), torch.float32)
    n, w = offset.shape
    _check_image("warp_rows", image, n, w, offset.device)
    if offset.device.type == "cpu":
        return warp_rows_plain(offset, nd, image, gradient_threshold,
                               max_stretch, max_disp)
    check_launch("warp_rows", image, w)
    return _launch("cs_warp_rows", (offset.data_ptr(), nd.data_ptr()), image,
                   (float(gradient_threshold), int(max_stretch), int(max_disp)))


def warp_rows_fused_plain(depth: torch.Tensor, dmin: torch.Tensor, dmax: torch.Tensor,
                          image: torch.Tensor, *, divergence_px: float,
                          separation_px: float, exponent: float, convergence_point: float,
                          gradient_threshold: float, max_stretch: int, max_disp: int,
                          height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The composition the fused entry replaces: normalize_between ->
    pixel_offsets -> `warp_rows_plain`, on [N, W] rows of N / height images."""
    n, w = depth.shape
    nd = depth_ops.normalize_between(depth.reshape(-1, height, w), dmin[:, None, None],
                                     dmax[:, None, None])
    off = depth_ops.pixel_offsets(nd, divergence_px, separation_px, exponent,
                                  convergence_point, prenormalized=True)
    return warp_rows_plain(off.reshape(n, w), nd.reshape(n, w), image, gradient_threshold,
                           max_stretch, max_disp)


def warp_rows_fused(depth: torch.Tensor, dmin: torch.Tensor, dmax: torch.Tensor,
                    image: torch.Tensor, *, divergence_px: float, separation_px: float,
                    exponent: float, convergence_point: float, gradient_threshold: float,
                    max_stretch: int, max_disp: int, height: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Warp the rows of an eye from its depth: depth [N, W] float32 rows of
    N / height images, dmin and dmax [N / height] float32 (each image's min
    and max), image [N, W, C]. On the card the CUDA kernel forms the
    normalised depth and the offsets itself; CPU tensors run
    `warp_rows_fused_plain`."""
    _common.check_rows("warp_rows_fused", (depth,), torch.float32)
    n, w = depth.shape
    if height <= 0 or n % height:
        raise ValueError(f"warp_rows_fused: {n} rows are not images of {height} rows")
    for t in (dmin, dmax):
        if (t.dtype != torch.float32 or tuple(t.shape) != (n // height,)
                or t.device != depth.device or not t.is_contiguous()):
            raise ValueError(f"warp_rows_fused: dmin and dmax must be contiguous float32 "
                             f"[{n // height}] on {depth.device}")
    _check_image("warp_rows_fused", image, n, w, depth.device)
    kw = dict(divergence_px=divergence_px, separation_px=separation_px, exponent=exponent,
              convergence_point=convergence_point, gradient_threshold=gradient_threshold,
              max_stretch=max_stretch, max_disp=max_disp, height=height)
    if depth.device.type == "cpu":
        return warp_rows_fused_plain(depth, dmin, dmax, image, **kw)
    check_launch("warp_rows_fused", image, w)
    return _launch("cs_warp_rows_depth", (depth.data_ptr(), dmin.data_ptr(), dmax.data_ptr()),
                   image, (int(height), float(divergence_px), float(separation_px),
                           float(exponent), _common.pow_mode(exponent),
                           float(convergence_point), float(gradient_threshold),
                           int(max_stretch), int(max_disp)))
