"""Model-type detection.

Port of part of `comfystereo_tpu/diffusion/adapters.py`: the supported model
types and the config sniffing that picks a scheduler for Standard mode
(SD2-family, 1024-d context: Euler; otherwise DDIM). The adapters that wrap
externally loaded models come with the model-loading slice.
"""
from __future__ import annotations

from typing import Any

SUPPORTED_MODEL_TYPES = ["SD1", "SD2"]


def detect_model_type(model_config: Any) -> str:
    """Classify a model by its config class and attribute names."""
    name = type(model_config).__name__ if model_config is not None else ""
    text = name + str(getattr(model_config, "__dict__", ""))
    if "XL" in name or "xl" in text[:200]:
        return "SDXL"
    if "Flux" in name or "flux" in text[:200]:
        return "FLUX"
    ctx = getattr(model_config, "context_dim", None) or \
        getattr(model_config, "cross_attention_dim", None)
    if ctx == 1024:
        return "SD2"
    return "SD1"
