"""Row-scan primitives along the last axis, batched over leading axes.

The JAX package writes these as associative scans; in PyTorch they are
`cummax`/`cummin`, over the values or over marked column indices; the
batched binary search and the row gather are the JAX package's as they are.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _cols(valid: torch.Tensor) -> torch.Tensor:
    return torch.arange(valid.shape[-1], device=valid.device)


def running_max(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix maximum along the last axis (max is exact, so any
    scan order gives the same bits)."""
    return torch.cummax(x, dim=-1).values


def running_min(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix minimum along the last axis."""
    return torch.cummin(x, dim=-1).values


def nearest_true_left(valid: torch.Tensor) -> torch.Tensor:
    """Index of the nearest True at-or-left of each position; -1 if none."""
    marked = torch.where(valid, _cols(valid), -1)
    return torch.cummax(marked, dim=-1).values


def nearest_true_right(valid: torch.Tensor) -> torch.Tensor:
    """Index of the nearest True at-or-right of each position; W if none."""
    w = valid.shape[-1]
    marked = torch.where(valid, _cols(valid), w)
    return torch.cummin(marked.flip(-1), dim=-1).values.flip(-1)


def segmented_running_min(values: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
    """Prefix min along the last axis that restarts at positions where
    `reset`: at a reset position the running min restarts from that
    position's value. Integer values of at most 32 bits.

    One cummin over int64 keys `value - segment * 2**32`, with the segment
    count taken by a cumsum of the resets: 2**32 exceeds the values' range,
    so every earlier segment's keys lie above the current segment's.
    """
    if values.dtype not in (torch.int32, torch.int16, torch.int8, torch.uint8):
        raise TypeError(f"segmented_running_min takes integers of at most 32 "
                        f"bits, got {values.dtype}")
    span = 1 << 32
    seg = torch.cumsum(reset.long(), dim=-1)
    keyed = values.long() - seg * span
    return (torch.cummin(keyed, dim=-1).values + seg * span).to(values.dtype)


def forward_fill(values: Tuple[torch.Tensor, ...], valid: torch.Tensor):
    """Propagate the last valid value rightward along the last axis.

    values: tuple of tensors [..., W]; valid: bool [..., W].
    Returns (filled_values, has_value). Positions before the first valid
    entry hold the row's first value with has_value False: that is what the
    JAX package's associative scan carries there (its docstring says they
    keep their own value; the code gives the first).
    """
    idx = nearest_true_left(valid)
    has = idx >= 0
    idx = idx.clamp(min=0)  # -1 -> 0: the row's first value
    return tuple(v.gather(-1, idx) for v in values), has


def backward_fill(values: Tuple[torch.Tensor, ...], valid: torch.Tensor):
    """Propagate the next valid value leftward along the last axis.

    values: tuple of tensors [..., W]; valid: bool [..., W].
    Returns (filled_values, has_value). Positions after the last valid entry
    hold the row's last value with has_value False, as the JAX package's
    reversed associative scan carries there (the mirror of `forward_fill`).
    """
    w = valid.shape[-1]
    idx = nearest_true_right(valid)
    has = idx < w
    idx = idx.clamp(max=w - 1)  # W -> W-1: the row's last value
    return tuple(v.gather(-1, idx) for v in values), has


def searchsorted_rows(sorted_rows: torch.Tensor, queries: torch.Tensor,
                      side: str = "right") -> torch.Tensor:
    """Batched searchsorted: each row of `sorted_rows` is non-decreasing.

    sorted_rows: [..., N] (ascending along the last axis); queries: [..., Q]
    with the same leading shape. Returns int32 insertion indices [..., Q],
    by the JAX package's vectorised binary search (a fixed bit_length(N - 1)
    + 1 rounds of gathers that do not freeze converged lanes): in [0, N]
    up to a row's last value, N + 1 above it, as the JAX code gives (its
    docstring says N).
    """
    n = sorted_rows.shape[-1]
    nbits = max(1, (n - 1).bit_length() if n > 1 else 1)
    lo = torch.zeros(queries.shape, dtype=torch.int32, device=queries.device)
    hi = torch.full(queries.shape, n, dtype=torch.int32, device=queries.device)
    for _ in range(nbits + 1):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = torch.gather(sorted_rows, -1, torch.clamp(mid, 0, n - 1).long())
        go_right = (v <= queries) if side == "right" else (v < queries)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis over the last axis (thin alias for readability)."""
    return torch.gather(values, -1, idx.long())
