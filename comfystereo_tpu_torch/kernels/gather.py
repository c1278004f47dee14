"""Bounded-displacement gather along the last axis (`values[..., idx]`).

Kernel: `csrc/gather.cu`, CUDA C++ for sm_90a, replacing the Pallas kernel
`comfystereo_tpu/pallas/gather.py:bounded_take_along_w`. One CTA per index
row: it stages the index row and the value rows that share it in shared
memory with 16-byte copies, gathers there, and writes 16-byte stores; it
copies 4-byte values bit for bit, so float32 and int32 both come out equal
to `torch.gather`. It is bound by bytes (each value, index and output
element once, 4 B each). See the source's header.

`bounded_take_along_w` launches the kernel for CUDA tensors and runs the
plain version, `torch.gather` (what the JAX package computes off the TPU),
for CPU tensors. It keeps the JAX wrapper's contract: leading axes are rows,
`values` is [..., M] and `idx` [..., N] with M and N free to differ, every
index lies in [0, M-1] within `max_disp` of its output column, and an index
axis of size 1 broadcasts over the values' axis (the fills gather every
channel of a [B, C, H, W] image with one [B, 1, H, W] plane).

`max_disp` is kept so that the signature and the callers match the JAX
package, where the TPU kernel sizes its source window by it; the CUDA kernel
reads any column of the row and does not use it. Rows whose staged rows
fit in one CTA's shared memory (`smem_bytes`: M = N up to 29,053 columns
row for row, 14,525 for a three-channel plane) are staged; wider ones are
gathered by the kernel's direct instance from device memory, with the same
bits. An
index outside [0, M-1] fails on both devices: `torch.gather` raises on the
CPU, and the kernel stops with a device-side assert on the card (reported at
the next synchronisation, as `torch.gather`'s own CUDA kernel reports it).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _common

LAUNCHES = 0  # kernel launches since the last reset (plain-version calls don't count)

_VALUE_DTYPES = (torch.float32, torch.int32)
SMEM_LIMIT = _common.SMEM_LIMIT


def smem_bytes(m: int, n: int, rep: int) -> int:
    """Shared memory the kernel stages for one index row of n indices and
    its `rep` value rows of m values: each row 4-byte words with up to 3
    words of alignment phase in front, rounded up to 16 bytes
    (`csrc/gather.cu:slot`)."""
    def slot(k: int) -> int:
        return (k + 6) // 4 * 4
    return 4 * (rep * slot(m) + slot(n))


def staged(m: int, n: int, rep: int) -> bool:
    """True when the kernel stages the rows in shared memory; otherwise its
    direct instance gathers them from device memory."""
    return smem_bytes(m, n, rep) <= SMEM_LIMIT


def _broadcast_rows(lead_v: Tuple[int, ...], lead_i: Tuple[int, ...]):
    """(rep, inner) of the kernel's index-row map for index leading shape
    `lead_i` against value leading shape `lead_v`, or None unless the two
    are equal or differ in one axis where the index has size 1."""
    if lead_i == lead_v:
        return 1, 1
    if len(lead_i) != len(lead_v):
        return None
    spread = [d for d, (a, b) in enumerate(zip(lead_v, lead_i)) if a != b]
    if len(spread) != 1 or lead_i[spread[0]] != 1:
        return None
    d = spread[0]
    return lead_v[d], math.prod(lead_v[d + 1:])


def bounded_take_along_w_plain(values: torch.Tensor, idx: torch.Tensor
                               ) -> torch.Tensor:
    """torch.gather along the last axis, with size-1 index axes broadcast."""
    shape = tuple(values.shape[:-1]) + (idx.shape[-1],)
    return torch.gather(values, -1, idx.long().expand(shape))


def bounded_take_along_w(values: torch.Tensor, idx: torch.Tensor,
                         max_disp: int) -> torch.Tensor:
    """values[..., M] gathered at idx[..., N] (int32 in [0, M-1], within
    `max_disp` of the output column) along the last axis: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    global LAUNCHES
    del max_disp  # the callers' contract; the kernel needs no bound (see above)
    if values.dtype not in _VALUE_DTYPES:
        raise TypeError(f"bounded_take_along_w: values dtype {values.dtype} not "
                        f"in {_VALUE_DTYPES}")
    if idx.dtype != torch.int32:
        raise TypeError(f"bounded_take_along_w: idx must be int32, got {idx.dtype}")
    if values.device != idx.device:
        raise ValueError("bounded_take_along_w: values and idx on different devices")
    lead_v = tuple(values.shape[:-1])
    rows_map = _broadcast_rows(lead_v, tuple(idx.shape[:-1]))
    if rows_map is None:
        raise ValueError(f"bounded_take_along_w: idx {tuple(idx.shape)} must match "
                         f"values {tuple(values.shape)} in its leading axes or "
                         "broadcast along one of them")
    if values.device.type == "cpu":
        return bounded_take_along_w_plain(values, idx)
    if values.device.type != "cuda":
        raise ValueError(f"bounded_take_along_w: unsupported device {values.device}")
    from . import _build

    m, n = values.shape[-1], idx.shape[-1]
    values = values.contiguous()
    idx = idx.contiguous()
    rows = math.prod(lead_v)
    out = torch.empty(lead_v + (n,), dtype=values.dtype, device=values.device)
    err = _common.launch(
        _build.library("gather").cs_gather_rows_b32,
        values.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, m, n,
        rows_map[0], rows_map[1], device=values.device)
    _build.check(err, "bounded_take_along_w kernel launch")
    LAUNCHES += 1
    return out
