"""Fill techniques. Only the anaglyph composer, which packing needs, is ported
so far; the CPU-parity fills wait for their own slice of the port."""
from __future__ import annotations

import torch


def overlap_red_cyan(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """R from the left image, G+B from the right. [..., H, W, 3]
    (reference overlap_red_cyan :1996-2010)."""
    return torch.stack([left[..., 0], right[..., 1], right[..., 2]], dim=-1)
