"""Hand-written CUDA kernels (sources in ../csrc) with their PyTorch wrappers
and plain versions. Kernels are built with nvcc at first use; see _build."""
import importlib
from typing import Dict

from .gather import bounded_take_along_w  # noqa: F401

# The kernels, by the name of the function each ports (the blur's
# `box_blend` ports none and goes by its own), and the module that holds its
# wrapper and its `LAUNCHES` counter.
KERNELS = {"warp_rows": "warp_kernel", "edge_distances": "distance",
           "bounded_take_along_w": "gather", "polylines_exact_rows": "polylines_exact",
           "polylines_scanline": "polylines", "flash_attention": "flash_attention",
           "box_blend": "box_blend"}


def _module(name: str):
    return importlib.import_module(f"{__name__}.{KERNELS[name]}")


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches since its counter was last reset, by name."""
    return {name: _module(name).LAUNCHES for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        _module(name).LAUNCHES = 0
