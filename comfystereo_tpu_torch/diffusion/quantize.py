"""Weight-only int8 (w8) storage for the SD UNet.

Port of `comfystereo_tpu/diffusion/quantize.py`. Large UNet weights are
stored as int8 with a float32 scale per output channel, symmetric absmax:
scale = max(absmax, 1e-12) / 127, q = clip(round(w / scale), -127, 127).
The output channel is the last axis of a flax kernel and axis 0 of a torch
`Linear` or `Conv2d` weight, so `q` and `scale` here are the JAX package's
transposed, bit for bit.

What is quantised follows the JAX rules: only matrix and convolution
weights (`nn.Linear`, `nn.Conv2d`; the flax tree's ``kernel`` leaves) with
at least `min_elems` elements; biases and norm weights stay in the compute
dtype. A layer already quantised passes through unchanged.

The weight is formed at each use as ``q.to(dtype) * scale.to(dtype)`` (the
JAX package's order), so only one layer's dequantised weight exists at a
time. Storage halves against bf16 (`quantized_bytes`); the dequantisation
adds a convert and a multiply per layer call.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import true_divide


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weight [out, ...] -> (int8 q, float32 scale [out, 1, ...]): absmax
    per output channel (axis 0). The division by 127 divides truly on every
    device (`device.true_divide`)."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=tuple(range(1, w.dim())), keepdim=True)
    scale = true_divide(torch.clamp(absmax, min=1e-12), 127.0)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The weight in `dtype`: q and scale each cast to `dtype`, then
    multiplied (the JAX package's `dequantize_tree` per leaf)."""
    return q.to(dtype) * scale.to(dtype)


class W8Linear(nn.Module):
    """`nn.Linear` with its weight stored as int8 `q` and float32 `scale`
    buffers; `weight` is the dequantised weight in `dtype`."""

    def __init__(self, layer: nn.Module, dtype: torch.dtype):
        super().__init__()
        q, scale = quantize_weight(layer.weight.detach())
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.bias = layer.bias
        self.dtype = dtype

    @property
    def weight(self) -> torch.Tensor:
        return dequantize(self.q, self.scale, self.dtype)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class W8Conv2d(W8Linear):
    """`nn.Conv2d` (zero padding) with a w8 weight."""

    def __init__(self, layer: nn.Conv2d, dtype: torch.dtype):
        super().__init__(layer, dtype)
        self.stride, self.padding = layer.stride, layer.padding
        self.dilation, self.groups = layer.dilation, layer.groups

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups)


_W8 = {nn.Linear: W8Linear, nn.Conv2d: W8Conv2d}


def quantize_module_(module: nn.Module, dtype: torch.dtype,
                     min_elems: int = 65536) -> nn.Module:
    """Replace, in place, every `nn.Linear` and `nn.Conv2d` below `module`
    whose weight has at least `min_elems` elements by its w8 form computing
    in `dtype` (the JAX package's `quantize_tree`). Layers already in w8
    form are left as they are. Returns `module`."""
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            kind = _W8.get(type(child))
            if kind is not None and child.weight.numel() >= min_elems:
                setattr(parent, name, kind(child, dtype))
    return module


def quantized_bytes(module: nn.Module) -> int:
    """Bytes of the parameters and buffers as stored (diagnostic)."""
    return sum(t.numel() * t.element_size() for t in module.state_dict().values())
