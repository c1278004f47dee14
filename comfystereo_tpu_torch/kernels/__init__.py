"""Hand-written CUDA kernels (sources in ../csrc) with their PyTorch wrappers
and plain versions. Kernels are built with nvcc at first use; see _build."""
from .gather import bounded_take_along_w  # noqa: F401
