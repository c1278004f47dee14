"""Published peaks of the card (NVIDIA data sheet, H100 SXM, dense, at the
full 700 W power limit): device-memory bytes/s, float32 FLOP/s outside
the tensor cores, dense bf16 tensor-core FLOP/s, and exponentials/s of the
special function units (16 per SM per clock, 132 SMs at 1.83 GHz: about
3.9e12). Every run is measured against these; its device line names the
card it ran on."""
from __future__ import annotations

BYTES_PER_S = 3.35e12
FLOP_PER_S = 67e12
TENSOR_FLOP_PER_S = 989e12
EXP_PER_S = 3.9e12


def floor_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    return max(nbytes / BYTES_PER_S, ops / FLOP_PER_S)


def tensor_floor_s(nbytes: float, tensor_ops: float, exps: float = 0.0) -> float:
    """The least time the card could take for work on the tensor cores: the
    largest of the bytes over the memory rate, the bf16 tensor-core
    operations over their rate and the exponentials over theirs."""
    return max(nbytes / BYTES_PER_S, tensor_ops / TENSOR_FLOP_PER_S, exps / EXP_PER_S)
