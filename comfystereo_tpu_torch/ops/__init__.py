"""Stereo compute ops on torch tensors (plain PyTorch; kernels under kernels/)."""
from . import blur, depth, fills, pack, polylines, scan, warp  # noqa: F401
