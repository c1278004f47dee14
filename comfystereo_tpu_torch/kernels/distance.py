"""Row-wise distance to the nearest edge, and the depth blur's edge weights.

Kernel: `csrc/distance.cu`, CUDA C++ for sm_90a, replacing the Pallas kernel
`comfystereo_tpu/pallas/distance.py:edge_distances`. One CTA per row; each
warp turns its 32 columns' mask bits into one `__ballot_sync` word per mask,
one warp per mask scans the row's words for the nearest set column up to and
from each word, and each column then finds its nearest edge on either side
in its own word or by one lookup. It is bound by bytes. Two entries, each launching the kernel for CUDA tensors and running
its plain version for CPU tensors:
- `edge_distances(mask_left, mask_right)`, the Pallas kernel's contract (2
  mask bytes in, 8 output bytes out per pixel); plain version
  `edge_distances_plain`. Both keep the TPU kernel's convention: 1e9 stands
  for "no edge on this side", so a row with no edge gets min(col + 1e9, 1e9 -
  col), which weights to 0 as the XLA path's `mask_radius + 1` does;
- `edge_weights_fused(depth255, ...)`, which the blur launches: it forms the
  Sobel gradient, both edge masks, the distances and the weights in the
  kernel (4 bytes in, 8 out per pixel); plain version `edge_weights_plain`,
  the blur's composition: `edge_masks` (Sobel-x, `sobel_x`, and the edge
  strength) -> `edge_distances_plain` -> `distance_weight`, which
  ops/blur.py uses too. Their divisions by a scalar are true divisions on
  every device (`device.true_divide`), as the kernel's are.

Both are bit-equal to their plain versions. The words and scans take 24
bytes per 32 columns (`smem_bytes`): rows up to `SHARED_WIDTH` columns keep
them in shared memory, one row per CTA; wider rows, up to `MAX_WIDTH`
columns (float32 counts every column below 2^24), keep them in a
device-memory workspace of one row per CTA, and each CTA walks rows at a
stride of the grid. A wider row raises on the card before any launch.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ._common import SMEM_LIMIT, check_rows, launch, pow_mode, resident_ctas
from ..device import true_divide

_LARGE = 1e9

LAUNCHES = 0  # kernel launches since the last reset (plain-version calls don't count)


def row_words(w: int) -> int:
    """4-byte words of one row's words and scans: per 32 columns and for
    each of the two masks, a word of mask bits, the last set column up to
    it and the first from it on."""
    return 6 * ((w + 31) // 32)


def smem_bytes(w: int) -> int:
    """Shared memory of one CTA for a row of w columns held there."""
    return 4 * row_words(w)


SHARED_WIDTH = SMEM_LIMIT // 24 * 32  # 309,920 columns
MAX_WIDTH = 1 << 24
_CTAS_PER_SM = 8  # 256 threads each


def check_launch(name: str, t: torch.Tensor) -> None:
    """Raise unless the CUDA kernel takes the [N, W] rows t: a CUDA tensor
    of at most MAX_WIDTH columns."""
    if t.shape[1] > MAX_WIDTH:
        raise ValueError(f"{name}: a row of {t.shape[1]} columns is over the {MAX_WIDTH} "
                         "columns the CUDA kernel takes")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


def edge_distances_plain(mask_left: torch.Tensor, mask_right: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, W] bool masks -> per-pixel float32 distance to the nearest True in
    the row, for each mask. Same values as the kernel, bit for bit."""
    return _min_dist(mask_left), _min_dist(mask_right)


def _min_dist(mask: torch.Tensor) -> torch.Tensor:
    cols = torch.arange(mask.shape[-1], dtype=torch.float32, device=mask.device)
    l_col = torch.cummax(torch.where(mask, cols, -_LARGE), dim=-1).values
    r_col = torch.cummin(torch.where(mask, cols, _LARGE).flip(-1),
                         dim=-1).values.flip(-1)
    return torch.minimum(cols - l_col, r_col - cols)


def _symmetric_pad1(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Pad one element on each side of `dim`, repeating the edge (numpy's
    'symmetric' for a pad of 1)."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 0, 1), x, x.narrow(dim, n - 1, 1)], dim=dim)


def sobel_x(x: torch.Tensor) -> torch.Tensor:
    """Horizontal Sobel gradient with symmetric (scipy 'reflect') padding:
    smooth [1,2,1] along H, then central difference along W. [..., H, W]."""
    xs = _symmetric_pad1(x, -2)
    smooth = xs[..., :-2, :] + 2.0 * xs[..., 1:-1, :] + xs[..., 2:, :]
    sw = _symmetric_pad1(smooth, -1)
    return sw[..., :, 2:] - sw[..., :, :-2]


def _edge_threshold10(edge_threshold: float) -> float:
    """10 * edge_threshold in float32, the edge strength's divisor."""
    return float(np.float32(10.0) * np.float32(edge_threshold))


def edge_masks(depth: torch.Tensor, edge_threshold: float):
    """The left eye's (rising) and the right eye's (falling) edge masks of
    [..., H, W] depth: Sobel-x of the right sign with strength
    clip(|g| / (10 * edge_threshold), 0, 1) > 0.5."""
    grad = sobel_x(depth)
    edge_str = torch.clamp(true_divide(grad.abs(), _edge_threshold10(edge_threshold)),
                           0.0, 1.0)
    return (grad > 0) & (edge_str > 0.5), (grad < 0) & (edge_str > 0.5)


def distance_weight(dist: torch.Tensor, mask_radius: int, falloff_exponent: float):
    """clip(1 - dist / mask_radius, 0, 1) ** falloff_exponent."""
    return torch.pow(torch.clamp(1.0 - true_divide(dist, mask_radius), 0.0, 1.0),
                     falloff_exponent)


def _launch(entry: str, before, n: int, w: int, device, after=()):
    """Launch a C entry, `entry(*before, out_a, out_b, workspace, ctas, n, w,
    *after, stream)`, on the two [n, w] float32 outputs it fills. Rows over
    SHARED_WIDTH get a grid of resident CTAs and their workspace."""
    global LAUNCHES
    from . import _build

    out_a = torch.empty((n, w), dtype=torch.float32, device=device)
    out_b = torch.empty_like(out_a)
    ctas, workspace = 0, None
    if w > SHARED_WIDTH:
        ctas = min(n, resident_ctas(device, _CTAS_PER_SM))
        workspace = torch.empty(ctas * row_words(w), dtype=torch.int32, device=device)
    fn = getattr(_build.library("distance"), entry)
    err = launch(fn, *before, out_a.data_ptr(), out_b.data_ptr(),
                 None if workspace is None else workspace.data_ptr(), ctas, n, w, *after,
                 device=device)
    _build.check(err, f"{entry} kernel launch")
    LAUNCHES += 1
    return out_a, out_b


def edge_distances(mask_left: torch.Tensor, mask_right: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distances for both masks: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Masks are [N, W] bool, contiguous."""
    check_rows("edge_distances", (mask_left, mask_right), torch.bool)
    if mask_left.device.type == "cpu":
        return edge_distances_plain(mask_left, mask_right)
    check_launch("edge_distances", mask_left)
    n, w = mask_left.shape
    return _launch("cs_edge_distances", (mask_left.data_ptr(), mask_right.data_ptr()), n, w,
                   mask_left.device)


def edge_weights_plain(depth255: torch.Tensor, *, edge_threshold: float, mask_radius: int,
                       falloff: float, height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blur's composition that the fused entry replaces, on [N, W] rows
    of N / height images: Sobel-x, the two edge masks, their distances
    (`edge_distances_plain`) and the weights."""
    n, w = depth255.shape
    left, right = edge_masks(depth255.reshape(-1, height, w), edge_threshold)
    dl, dr = edge_distances_plain(left.reshape(n, w), right.reshape(n, w))
    return distance_weight(dl, mask_radius, falloff), distance_weight(dr, mask_radius, falloff)


def edge_weights_fused(depth255: torch.Tensor, *, edge_threshold: float, mask_radius: int,
                       falloff: float, height: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both eyes' edge weights from the depth: depth255 [N, W] float32 rows
    of N / height images (0-255). Returns (left, right) float32 [N, W]: the
    CUDA kernel for CUDA tensors, `edge_weights_plain` for CPU tensors."""
    check_rows("edge_weights_fused", (depth255,), torch.float32)
    n, w = depth255.shape
    if height <= 0 or n % height:
        raise ValueError(f"edge_weights_fused: {n} rows are not images of {height} rows")
    kw = dict(edge_threshold=edge_threshold, mask_radius=mask_radius, falloff=falloff,
              height=height)
    if depth255.device.type == "cpu":
        return edge_weights_plain(depth255, **kw)
    check_launch("edge_weights_fused", depth255)
    return _launch("cs_edge_weights", (depth255.data_ptr(),), n, w, depth255.device,
                   (int(height), _edge_threshold10(edge_threshold), float(mask_radius),
                    float(falloff), pow_mode(falloff)))
