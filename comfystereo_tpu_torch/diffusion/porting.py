"""Model assembly and weight carry-over.

Port of part of `comfystereo_tpu/diffusion/porting.py`:

* `build_sd_model` builds the SD UNet and VAE at a config's full width, with
  seeded random weights or a given state dict, casts the parameters to
  `dtype`, and wraps them in a `DiffusionModel` whose apply functions cast
  inputs to `dtype` at the UNet and VAE boundary and return float32, as the
  JAX package's jitted boundary does.
* `state_dict_from_jax` turns the JAX package's flax parameter tree (as
  numpy arrays) into the port's state dict: conv kernels HWIO -> OIHW,
  dense kernels transposed, norm `scale` -> `weight`, and ``name_index``
  module names split back into diffusers' dotted keys (the key walk of
  `flax_to_torch_state_dict`), with ``linear_1``/``linear_2`` kept literal.

* `toy_state_dicts_from_jax` does the same for the JAX toy model's UNet
  and VAE trees, renaming flax's auto-named modules to the toy's module
  lists (`models.py`).

No checkpoint is in the repository yet: safetensors I/O, the LDM key maps
and w8 weight storage come with the model-loading slice.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .attention import AttentionMode
from .models import DiffusionModel, HashTextEncoder
from .sd_unet import SD15_UNET_CONFIG, SDUNet
from .sd_vae import SD_VAE_CONFIG, SDVAE

# Module names whose trailing _<digit> is diffusers' own spelling, not a list
# index (TimestepEmbedding's linear_1 / linear_2).
_LITERAL = {"linear_1", "linear_2"}


def _torch_key(path, leaf: str) -> str:
    parts = []
    for p in path:
        head, _, idx = p.rpartition("_")
        if head and idx.isdigit() and p not in _LITERAL:
            parts.extend([head, idx])
        else:
            parts.append(p)
    return ".".join(parts + [leaf])


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax parameter tree ({'params': ...} or its inside) of numpy arrays ->
    the port's state dict (float32 tensors; bf16 leaves are widened, which is
    exact). Transposes are views of the numpy arrays: nothing is copied, and
    the tensors share the arrays' memory, often read-only (JAX's are), so
    load them with `load_state_dict`, which copies, and write none."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, path + [name])
                continue
            arr = np.asarray(child)
            if arr.dtype.name == "bfloat16":
                arr = arr.astype(np.float32)
            if name == "kernel":
                leaf = "weight"
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            elif name == "scale":
                leaf = "weight"
            elif name == "bias":
                leaf = "bias"
            else:
                raise KeyError(f"state_dict_from_jax: unknown leaf {'/'.join(path + [name])}")
            out[_torch_key(path, leaf)] = torch.from_numpy(arr)

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        walk(tree, [])
    return out


# flax auto-name prefixes of the toy modules -> the port's module lists
# (`models.py`); the VAE's Sequential layers_<i> are the torch Sequential's i.
_TOY_NAMES = {"Conv": "convs", "Dense": "dense", "GroupNorm": "norms", "LayerNorm": "norms",
              "_ResBlock": "res_blocks", "_TransformerBlock": "blocks"}


def toy_state_dicts_from_jax(unet_params: Mapping[str, Any], vae_params: Mapping[str, Any]):
    """The JAX toy model's flax trees (`make_toy_model`'s `unet_params` and
    `vae_params`, as numpy arrays) -> (UNet, VAE) state dicts of the port's
    `LatentUNet` and `SimpleVAE` (`state_dict_from_jax`, then the toy's
    module names)."""
    def rename(sd):
        return {".".join(_TOY_NAMES.get(p, p) for p in k.split(".") if p != "layers"): v
                for k, v in sd.items()}
    return rename(state_dict_from_jax(unet_params)), rename(state_dict_from_jax(vae_params))


def random_init_(module: torch.nn.Module, seed: int) -> None:
    """Seeded random weights, drawn on the CPU in parameter order so a seed
    gives the same weights on every device: matrix and conv weights
    N(0, 1/fan_in) (flax's lecun-normal scale, which keeps activations of
    order one through the residual stack), biases 0, norm scales 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2:
                std = 1.0 / math.sqrt(math.prod(p.shape[1:]))
                p.copy_(torch.randn(p.shape, generator=gen) * std)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)


def build_sd_model(unet_cfg=None, vae_cfg=None, dtype: torch.dtype = torch.float32,
                   seed: int = 0, device: DeviceLike = None,
                   unet_state: Optional[Mapping[str, torch.Tensor]] = None,
                   vae_state: Optional[Mapping[str, torch.Tensor]] = None,
                   text_encode: Optional[Callable] = None) -> DiffusionModel:
    """Assemble a `DiffusionModel` from `SDUNet` and `SDVAE`.

    Weights: the given state dicts (e.g. from `state_dict_from_jax`), else
    seeded random weights (`random_init_`, UNet from `seed`, VAE from
    `seed + 1`). Parameters are cast to `dtype`; the apply functions cast
    their inputs to `dtype` and return float32, so `dtype=torch.bfloat16` is
    the JAX package's mixed-precision mode (scheduler math, masks and the
    latent scale stay float32). `device=None` means CUDA.
    """
    dev = resolve_device(device)
    unet_cfg = unet_cfg or SD15_UNET_CONFIG
    vae_cfg = vae_cfg or SD_VAE_CONFIG
    unet, vae = SDUNet(unet_cfg), SDVAE(vae_cfg)
    for module, state, s in ((unet, unet_state, seed), (vae, vae_state, seed + 1)):
        if state is None:
            random_init_(module, s)
        else:
            module.load_state_dict(state)
        module.requires_grad_(False).eval().to(device=dev, dtype=dtype)

    def unet_apply(latents, t, context, mode: Optional[AttentionMode] = None,
                   stereo_active: bool = False):
        out = unet(latents.to(dtype), t, context.to(dtype),
                   mode=mode or AttentionMode(), stereo_active=stereo_active)
        return out.float()

    return DiffusionModel(
        unet_apply=unet_apply,
        vae_encode=lambda x: vae.encode(x.to(dtype)).float(),
        vae_decode=lambda z: vae.decode(z.to(dtype)).float(),
        text_encode=text_encode or HashTextEncoder(
            dim=unet_cfg.cross_attention_dim, device=dev),
        device=dev,
        latent_channels=vae_cfg.latent_channels,
        context_dim=unet_cfg.cross_attention_dim,
        unet_in_channels=unet_cfg.in_channels,
        unet=unet, vae=vae)
