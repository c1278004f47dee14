"""Published peaks of the card (NVIDIA data sheet, H100 SXM, dense, at the
full 700 W power limit): device-memory bytes/s and float32 FLOP/s outside
the tensor cores. Every run is measured against these; its device line
names the card it ran on."""
from __future__ import annotations

BYTES_PER_S = 3.35e12
FLOP_PER_S = 67e12


def floor_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    return max(nbytes / BYTES_PER_S, ops / FLOP_PER_S)
