"""Row-wise distance to the nearest edge, for the depth blur's weights.

Kernel: `csrc/distance.cu`, CUDA C++ for sm_90a, replacing the Pallas kernel
`comfystereo_tpu/pallas/distance.py:edge_distances`. One CTA per row; each
thread scans a contiguous chunk, and one block scan joins the chunks. It is
bound by bytes (2 mask bytes in, 8 output bytes out per pixel), so the design
reads each mask byte once into shared memory and writes the outputs with
coalesced stores.

`edge_distances` launches the kernel for CUDA tensors and runs the plain
version, `edge_distances_plain`, for CPU tensors. Both keep the TPU kernel's
convention: 1e9 stands for "no edge on this side", so a row with no edge
gets min(col + 1e9, 1e9 - col), which weights to 0 as the XLA path's
`mask_radius + 1` does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ._common import check_rows, stream_ptr

_LARGE = 1e9

LAUNCHES = 0  # kernel launches since the last reset (plain-version calls don't count)


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


def edge_distances(mask_left: torch.Tensor, mask_right: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distances for both masks: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Masks are [N, W] bool, contiguous."""
    global LAUNCHES
    check_rows("edge_distances", (mask_left, mask_right), torch.bool)
    if mask_left.device.type == "cpu":
        return edge_distances_plain(mask_left, mask_right)
    if mask_left.device.type != "cuda":
        raise ValueError(f"edge_distances: unsupported device {mask_left.device}")
    from . import _build

    n, w = mask_left.shape
    dist_l = torch.empty((n, w), dtype=torch.float32, device=mask_left.device)
    dist_r = torch.empty_like(dist_l)
    err = _build.library("distance").cs_edge_distances(
        mask_left.data_ptr(), mask_right.data_ptr(), dist_l.data_ptr(),
        dist_r.data_ptr(), n, w, stream_ptr(mask_left.device))
    _build.check(err, "edge_distances kernel launch")
    LAUNCHES += 1
    return dist_l, dist_r
