"""comfystereo_tpu_torch: the PyTorch/CUDA port of comfystereo_tpu.

The JAX package `comfystereo_tpu` stays the reference; this package imports
`torch` and never `jax`, and nothing of `comfystereo_tpu`. It mirrors the
JAX package's layout so each module's counterpart is easy to find.

It does what the JAX package does: the depth->stereo path through
`stereo_pipeline`, the Stereo Image node and the video loop, with the
directional depth blur and every fill technique (the default `gpu_warp` and
the CPU-parity fills with the exact and supersampled polylines renderers);
frame and row sharding over a mesh of devices (`parallel/`, with
`graft_entry.py`'s self-checked dry run); the backward-warp family and the
side blurs (`ops/`); the StereoDiffusion node's Fast (Warp + Inpaint) and
Standard (DDIM) modes on the SD UNet, VAE and CLIP text encoder
(`diffusion/`), with the model resolved from a connected torch model, a
diffusers checkpoint directory or hub id, or the toy model, and optional w8
UNet weights; and the host side: profiling, tensor converters, the native
pixel conversions (`native/`) and the VR viewer with its nodes (`viewer/`,
`nodes/native_nodes.py`). Its six accelerator kernels are hand-written
CUDA for Hopper (sm_90a) in `csrc/`: the forward warp
(`kernels/warp_kernel.py`), the row edge-distance transform
(`kernels/distance.py`), the bounded gather (`kernels/gather.py`), the exact
and the supersampled polylines scans (`kernels/polylines_exact.py`,
`kernels/polylines.py`) and the flash attention of the UNet's bf16
self-attentions (`kernels/flash_attention.py`). Each wrapper runs its plain
PyTorch version for CPU tensors.

Entry points (`StereoImageNode.generate`, `convert_video`, `device_chunk`,
`StereoDiffusionNode.generate_stereo`, `diffusion.build_sd_model`,
`diffusion.load_sd_from_diffusers_dir`, the `model_loader` functions,
`parallel.make_mesh`, `graft_entry.dryrun_multichip`) take `device=None`,
which means CUDA; without a GPU they raise unless
`device="cpu"` is passed.
"""
from __future__ import annotations

from .config import (FILL_TECHNIQUES, MODES, UI_FILL_MAPPING,  # noqa: F401
                     StereoConfig, config_from_fields)
from .device import resolve_device  # noqa: F401
from .pipeline import apply_stereo_divergence, stereo_pipeline  # noqa: F401
from . import ops  # noqa: F401

__version__ = "0.1.0"

NODE_CLASS_MAPPINGS = {}
NODE_DISPLAY_NAME_MAPPINGS = {}

# The three node groups, each behind its import guard as in the JAX package
# (comfystereo_tpu/__init__.py:24-62). The VR nodes probe the viewer's
# optional dependencies when they run, not here.
try:
    from .nodes.stereo_image import (  # noqa: F401
        StereoImageNode,
        NODE_CLASS_MAPPINGS as _stereo_mappings,
        NODE_DISPLAY_NAME_MAPPINGS as _stereo_names,
    )
    NODE_CLASS_MAPPINGS.update(_stereo_mappings)
    NODE_DISPLAY_NAME_MAPPINGS.update(_stereo_names)
    STEREO_NODES_AVAILABLE = True
except ImportError as e:  # pragma: no cover
    STEREO_NODES_AVAILABLE = False
    _stereo_import_error = str(e)

try:
    from .nodes.stereodiffusion import (  # noqa: F401
        NODE_CLASS_MAPPINGS as _sd_mappings,
        NODE_DISPLAY_NAME_MAPPINGS as _sd_names,
    )
    NODE_CLASS_MAPPINGS.update(_sd_mappings)
    NODE_DISPLAY_NAME_MAPPINGS.update(_sd_names)
    DIFFUSION_NODES_AVAILABLE = True
except ImportError:  # pragma: no cover
    DIFFUSION_NODES_AVAILABLE = False

try:
    from .nodes.native_nodes import (  # noqa: F401
        NODE_CLASS_MAPPINGS as _vr_mappings,
        NODE_DISPLAY_NAME_MAPPINGS as _vr_names,
    )
    NODE_CLASS_MAPPINGS.update(_vr_mappings)
    NODE_DISPLAY_NAME_MAPPINGS.update(_vr_names)
    VR_NODES_AVAILABLE = True
except ImportError:  # pragma: no cover
    VR_NODES_AVAILABLE = False
