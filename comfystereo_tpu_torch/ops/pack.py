"""Output packing: SBS / top-bottom / anaglyph composition.

Reference: mode packing in create_stereoimages (stereoimage_generation.py:
1544-1560) and create_stereoimages_gpu (:1092-1122).
"""
from __future__ import annotations

import torch

from .fills import overlap_red_cyan


def pack_mode(left: torch.Tensor, right: torch.Tensor, mode: str) -> torch.Tensor:
    """Compose one output mode from per-eye images [..., H, W, C]."""
    if mode == "left-right":
        return torch.cat([left, right], dim=-2)
    if mode == "right-left":
        return torch.cat([right, left], dim=-2)
    if mode == "top-bottom":
        return torch.cat([left, right], dim=-3)
    if mode == "bottom-top":
        return torch.cat([right, left], dim=-3)
    if mode == "red-cyan-anaglyph":
        return overlap_red_cyan(left, right)
    if mode == "cyan-red-reverseanaglyph":
        return overlap_red_cyan(right, left)
    if mode == "left-only":
        return left
    if mode == "only-right":
        return right
    raise ValueError(f"Unknown mode: {mode}")
