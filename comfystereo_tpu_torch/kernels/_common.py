"""Argument checks and launch helpers shared by the kernel wrappers."""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# Shared memory one CTA may opt in to on sm_90 (227 KB), static and dynamic
# together.
SMEM_LIMIT = 232448


def resident_ctas(device: torch.device, per_sm: int) -> int:
    """per_sm CTAs on each of the card's multiprocessors: the grid of a
    kernel whose CTAs walk rows at a stride of the grid."""
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def check_rows(name: str, tensors: Sequence[torch.Tensor], dtype: torch.dtype,
               dims: Sequence[str] = ("rows", "width")) -> None:
    """Raise unless every tensor has the axes `dims` (2-D [rows, width] by
    default), is contiguous, of `dtype`, and of the first one's shape and
    device."""
    first = tensors[0]
    want = tuple(first.shape)
    if len(want) != len(dims):
        raise ValueError(f"{name}: expected [{', '.join(dims)}], got {want}")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: expected shape {want}, got {tuple(t.shape)}")
        if t.device != first.device:
            raise ValueError(f"{name}: tensors on {first.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def stream_ptr(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream


def launch(fn, *args, device: torch.device) -> int:
    """fn(*args, stream): a C entry called with `device` the current CUDA
    device and `stream` PyTorch's current stream there; returns its error
    code. The entries launch on the current device, and PyTorch's default
    stream is the null stream, which names the current device's: without
    the guard a tensor on another card than the current one would be
    worked on from the wrong card, unordered with its own stream."""
    with torch.cuda.device(device):
        return fn(*args, stream_ptr(device))


def point_x(coord: torch.Tensor, sep_px: float) -> torch.Tensor:
    """Point positions x = col + 0.5 + coord + sep_px of [..., W] signed
    offsets, added in that order in float32 (sep_px rounded to float32), as
    the polylines routes form them and their fused kernels repeat."""
    cols = torch.arange(coord.shape[-1], dtype=torch.float32, device=coord.device)
    return cols + 0.5 + coord + sep_px


# Modes of csrc/torch_math.cuh:torch_pow, in its order.
_POW_EXACT = {0.0: 0, 1.0: 1, 0.5: 2, -0.5: 3, -1.0: 4}
_POW_FLOAT = {2.0: 5, 3.0: 6, -2.0: 7}
POW_GENERAL = 8


def pow_mode(exponent: float) -> int:
    """The branch that torch.pow(float32 tensor, exponent) takes on CUDA, for
    the fused kernels to repeat: ATen fills 1 for 0 and copies for 1 (tested
    in double), takes sqrt, rsqrt and the reciprocal for 0.5, -0.5 and -1,
    then x*x, x*x*x and 1/(x*x) for 2, 3 and -2 once the exponent is
    rounded to float32, and powf otherwise."""
    e = float(exponent)
    if e in _POW_EXACT:
        return _POW_EXACT[e]
    return _POW_FLOAT.get(float(np.float32(e)), POW_GENERAL)
