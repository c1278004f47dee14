"""Stereo compute ops on torch tensors (plain PyTorch; kernels under kernels/)."""
from . import blur, depth, fills, pack, scan, warp  # noqa: F401
