"""Model bundle and the stand-in text encoder.

Port of part of `comfystereo_tpu/diffusion/models.py`: `LATENT_SCALE`, the
`DiffusionModel` bundle the pipelines consume, and `HashTextEncoder`. The
bundle's apply functions close over `nn.Module`s, so they take no parameter
argument (the JAX bundle's take a parameter tree).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, Optional

import torch

# SD latent scaling
LATENT_SCALE = 0.18215


class HashTextEncoder:
    """Deterministic prompt -> [1, 77, dim] embedding with no model: a
    stand-in with the text encoder's interface until the CLIP port lands.
    The seed is a stable hash of the text (crc32), so a prompt gives the
    same embedding in every process; its values are not the JAX encoder's,
    which come from `jax.random`."""

    def __init__(self, dim: int = 64, max_length: int = 77,
                 device: Optional[torch.device] = None):
        self.dim = dim
        self.max_length = max_length
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self._cache: Dict[str, torch.Tensor] = {}

    def __call__(self, text: str) -> torch.Tensor:
        if text not in self._cache:
            seed = zlib.crc32(("comfystereo\x00" + text).encode("utf-8"))
            gen = torch.Generator().manual_seed(seed)
            emb = torch.randn((1, self.max_length, self.dim), generator=gen) * 0.02
            self._cache[text] = emb.to(self.device)
        return self._cache[text]


@dataclasses.dataclass
class DiffusionModel:
    """Functional bundle consumed by the pipelines.

    unet_apply(latents_nchw, t, context, mode=None, stereo_active=False) -> eps
    vae_encode(x) / vae_decode(z), with the SD 0.18215 scaling OUTSIDE.
    All three take and return float32 tensors on `device`.
    """

    unet_apply: Callable
    vae_encode: Callable
    vae_decode: Callable
    text_encode: Callable
    device: torch.device
    latent_channels: int = 4
    context_dim: int = 64
    # UNet input channels; 9 selects the SD-inpainting concat path
    # (latents + mask + masked-image latents).
    unet_in_channels: int = 4
    # Native pixel resolution the model was trained at; the node resizes
    # inputs to this square before diffusion and results back afterwards.
    sample_size: int = 512
    unet: Optional[torch.nn.Module] = None
    vae: Optional[torch.nn.Module] = None
