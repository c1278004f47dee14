"""Hub checkpoint resolution: an id or path -> a model bundle on a device.

Port of `comfystereo_tpu/diffusion/model_loader.py`:

    id-or-path -> local diffusers-layout directory -> the port's SDUNet /
    SDVAE / CLIP (`porting.load_sd_from_diffusers_dir`) on the device

Resolution order for an id that is not a directory:
1. the local HuggingFace cache (``snapshot_download(local_files_only=True)``),
   which never touches the network;
2. a download with one retry, skipped in offline mode
   (``HF_HUB_OFFLINE``/``COMFYSTEREO_OFFLINE``).
Without `huggingface_hub` an id that is not a directory is unavailable, and
the error says so.

On total failure a `ModelUnavailableError` carries the whole attempt trail;
callers decide whether to fall back (the StereoDiffusion node falls back to
the toy model loudly, printing the trail).

Bundles are cached in the port's one model cache (`utils.caching`, cleared
by its `clear_model_cache`, which this module re-exports as the JAX
package's loader has its own) per id and scheduler (``"{id}:{scheduler}"``,
or ``"{id}:inpaint"``) as the JAX package keys them, with the device
appended, so one process may hold a CPU and a CUDA bundle of one
checkpoint.
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..utils.caching import clear_model_cache, get_or_load_model  # noqa: F401

# Only the files the port reads: the safetensors of unet/vae/text_encoder,
# their configs, and the tokenizer vocab.
_SD_ALLOW_PATTERNS = [
    "model_index.json",
    "unet/config.json",
    "unet/diffusion_pytorch_model.safetensors",
    "vae/config.json",
    "vae/diffusion_pytorch_model.safetensors",
    "text_encoder/config.json",
    "text_encoder/model.safetensors",
    "tokenizer/*",
]


class ModelUnavailableError(RuntimeError):
    """Raised when a model id cannot be resolved locally or downloaded."""

    def __init__(self, model_id: str, attempts: List[str]):
        self.model_id = model_id
        self.attempts = attempts
        super().__init__(
            f"model '{model_id}' unavailable; attempts:\n  - " + "\n  - ".join(attempts))


def _offline() -> bool:
    return os.environ.get("HF_HUB_OFFLINE", "") not in ("", "0") or \
        os.environ.get("COMFYSTEREO_OFFLINE", "") not in ("", "0")


def resolve_model_dir(model_id_or_path: str,
                      allow_patterns: Optional[List[str]] = None) -> str:
    """Resolve an id-or-path to a local diffusers-layout directory, or raise
    ModelUnavailableError with the attempt trail."""
    attempts: List[str] = []
    if os.path.isdir(model_id_or_path):
        return model_id_or_path
    if os.sep in model_id_or_path and not model_id_or_path.count("/") == 1:
        # Looks like a filesystem path (ids are exactly "org/name"), but it
        # does not exist: never hand it to the hub API.
        raise ModelUnavailableError(model_id_or_path, ["not a directory on disk"])
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise ModelUnavailableError(model_id_or_path, [f"huggingface_hub missing: {e}"])

    patterns = allow_patterns or _SD_ALLOW_PATTERNS
    # 1. The local cache, never touching the network.
    try:
        return snapshot_download(model_id_or_path, local_files_only=True,
                                 allow_patterns=patterns)
    except Exception as e:
        attempts.append(f"local cache: {type(e).__name__}: {e}")
    if _offline():
        attempts.append("download skipped: offline mode (HF_HUB_OFFLINE/COMFYSTEREO_OFFLINE)")
        raise ModelUnavailableError(model_id_or_path, attempts)
    # 2. A download, retried once.
    for attempt in range(2):
        try:
            return snapshot_download(model_id_or_path, allow_patterns=patterns)
        except Exception as e:
            attempts.append(f"download try {attempt + 1}: {type(e).__name__}: {e}")
            if attempt == 0:
                print(f"Failed to load model: {e}")
                print("Attempting to download from HuggingFace...")
    raise ModelUnavailableError(model_id_or_path, attempts)


def _load(cache_key: str, model_id_or_path: str, dtype: torch.dtype, dev: torch.device):
    def load():
        from . import porting

        return porting.load_sd_from_diffusers_dir(resolve_model_dir(model_id_or_path),
                                                  dtype=dtype, device=dev)
    return get_or_load_model(f"{cache_key}:{dev}", load)


def load_sd_model(model_id_or_path: str = "runwayml/stable-diffusion-v1-5",
                  scheduler_type: str = "ddim", dtype: Optional[torch.dtype] = None,
                  device: DeviceLike = None):
    """Load (or take from the cache) an SD bundle by hub id or local path,
    on `device` (None means CUDA). Unset `dtype` follows the precision
    policy: float32 for ddim (the gradient path), bfloat16 for euler."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if scheduler_type == "euler" else torch.float32
    return _load(f"{model_id_or_path}:{scheduler_type}", model_id_or_path, dtype, dev)


def load_inpainting_model(model_id_or_path: str = "runwayml/stable-diffusion-inpainting",
                          dtype: Optional[torch.dtype] = None, device: DeviceLike = None):
    """Load (or take from the cache) an SD inpainting bundle (9-channel UNet),
    bfloat16 unless `dtype` is given (the Fast path's precision)."""
    return _load(f"{model_id_or_path}:inpaint", model_id_or_path, dtype or torch.bfloat16,
                 resolve_device(device))
