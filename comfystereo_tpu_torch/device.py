"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: `device=None`
means CUDA, and with no GPU present that is an error, never a silent move to
the CPU. Functions below the entry points run on the device of the tensors
they are given.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> `cuda`; raises RuntimeError when a CUDA device is asked for
    (explicitly or by default) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def as_float_tensor(x, device: torch.device) -> torch.Tensor:
    """numpy array or tensor -> float32 tensor on `device` (no copy when it
    is already one)."""
    t = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return t.to(device=device, dtype=torch.float32)


def true_divide(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """x / divisor in IEEE division on every device. On CUDA, PyTorch divides
    a float tensor by a Python scalar as a product with the scalar's rounded
    reciprocal (ATen's `div_true_kernel_cuda`), which differs from the CPU's
    (and XLA's) true division in the last bit of some values; a divisor held
    in a 0-dim float32 tensor on x's device is divided truly."""
    if x.device.type == "cpu":
        return x / divisor
    return x / torch.full((), divisor, dtype=torch.float32, device=x.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device. PyTorch's CPU
    builds may vectorise float32 `sqrt` as a reciprocal-square-root estimate
    and a Newton step, which is off by one ulp in about a fifth of values
    (XLA and numpy round correctly). A float32 square root taken in float64
    and rounded once is the correctly rounded one, since float64 holds more
    than 2 x 24 + 2 bits; on CUDA `torch.sqrt` is IEEE already."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)
