"""Hand-written CUDA kernels (sources in ../csrc) with their PyTorch wrappers
and plain versions. Kernels are built with nvcc at first use; see _build."""
