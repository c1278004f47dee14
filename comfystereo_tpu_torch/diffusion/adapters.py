"""Model-type detection and adapters for externally loaded models.

Port of `comfystereo_tpu/diffusion/adapters.py`: the supported model types
and the config sniffing that picks a scheduler for Standard mode
(SD2-family, 1024-d context: Euler; otherwise DDIM), and the adapters that
turn externally loaded diffusion stacks into the `DiffusionModel` bundle the
pipelines consume:

* `from_torch_modules` (connected ComfyUI or diffusers torch modules) carries
  their weights into the port's `SDUNet`/`SDVAE`/`CLIPTextModel`, so the
  bundle runs the port's kernels and null-text optimisation differentiates
  through them; when the weights hold no SD layout (a non-SD architecture)
  it runs the given modules themselves under `no_grad`, for inference only,
  on the bundle's device.
* `from_diffusers` (the JAX package's `from_flax_diffusers`) loads a
  checkpoint through the `diffusers` package and runs its modules; it is
  gated on that import, as the JAX adapter is.
"""
from __future__ import annotations

from typing import Any

import torch

from ..device import DeviceLike, resolve_device
from ..utils.caching import EmbeddingCache, get_or_load_model
from .models import DiffusionModel, HashTextEncoder

# SDXL: Fast mode only (Standard mode's inversion does not carry its
# text-time conditioning).
SUPPORTED_MODEL_TYPES = ["SD1", "SD2", "SDXL"]


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


def _field(out, name: str):
    return out[name] if isinstance(out, dict) else getattr(out, name)


def _require_on(dev: torch.device, **modules) -> None:
    """Raise unless every parameter of the given modules lies on `dev`: a
    bundle on one device never runs its model on another."""
    for name, module in modules.items():
        params = module.parameters() if hasattr(module, "parameters") else ()
        where = sorted({str(p.device) for p in params} - {str(dev)})
        if where:
            raise ValueError(f"the given {name} has parameters on {', '.join(where)}, not on "
                             f"{dev}: move it there, or ask for a bundle on its device")


def _torch_text_encode(tokenizer, text_encoder, dev: torch.device):
    """Prompt -> float32 [1, 77, hidden] on `dev` through the given tokenizer
    and text encoder (which lives on `dev`), under no_grad."""
    @torch.no_grad()
    def encode(text: str):
        tok = tokenizer([text], padding="max_length",
                        max_length=getattr(tokenizer, "model_max_length", 77),
                        truncation=True, return_tensors="pt")
        return text_encoder(tok.input_ids.to(dev))[0].float()
    return encode


def from_diffusers(model_id: str = "runwayml/stable-diffusion-v1-5", dtype=None,
                   device: DeviceLike = None) -> DiffusionModel:
    """A bundle running the `diffusers` package's UNet and VAE and
    transformers' CLIP, loaded by `from_pretrained` on `device` (None means
    CUDA), cached per model id, dtype and device. Gated: needs `diffusers`."""
    dev = resolve_device(device)

    def load():
        from diffusers import AutoencoderKL, UNet2DConditionModel
        from transformers import CLIPTextModel, CLIPTokenizer

        dt = dtype or torch.float32
        unet = UNet2DConditionModel.from_pretrained(
            model_id, subfolder="unet", torch_dtype=dt).to(dev).eval()
        vae = AutoencoderKL.from_pretrained(
            model_id, subfolder="vae", torch_dtype=dt).to(dev).eval()
        tokenizer = CLIPTokenizer.from_pretrained(model_id, subfolder="tokenizer")
        text_model = CLIPTextModel.from_pretrained(
            model_id, subfolder="text_encoder", torch_dtype=dt).to(dev).eval()

        @torch.no_grad()
        def unet_apply(latents, t, context, **_):
            return unet(latents.to(dt), t, encoder_hidden_states=context.to(dt)).sample.float()

        return DiffusionModel(
            unet_apply=unet_apply,
            vae_encode=torch.no_grad()(
                lambda x: vae.encode(x.to(dt)).latent_dist.mean.float()),
            vae_decode=torch.no_grad()(lambda z: vae.decode(z.to(dt)).sample.float()),
            text_encode=EmbeddingCache(_torch_text_encode(tokenizer, text_model, dev)),
            device=dev,
            latent_channels=4,
            context_dim=getattr(unet.config, "cross_attention_dim", 768),
            unet_in_channels=getattr(unet.config, "in_channels", 4),
            sample_size=8 * getattr(unet.config, "sample_size", 64))

    return get_or_load_model(("diffusers", model_id, str(dtype), str(dev)), load)


def from_torch_modules(unet, vae, tokenizer, text_encoder, unet_cfg=None, vae_cfg=None,
                       device: DeviceLike = None) -> DiffusionModel:
    """A bundle from torch (e.g. ComfyUI-loaded) modules, on `device` (None
    means CUDA).

    The weights are carried into the port's SD modules
    (`porting.port_torch_unet`/`port_torch_vae`, diffusers or LDM/ComfyUI
    key layouts) and the CLIP tower into `CLIPTextModel` (tokenisation stays
    with the given tokenizer), wherever the given modules live. The bundle
    then runs the port's kernels and is differentiable, so null-text
    optimisation works.

    Fallback, when the port finds no SD or CLIP layout in the weights (its
    ValueError or KeyError; any other error propagates): the given UNet and
    VAE, or the given text encoder alone, run themselves under no_grad,
    for inference only. They must then live on `device`: a ValueError says
    so otherwise.
    """
    from . import porting
    from .clip_text import NativeCLIPTextEncoder

    dev = resolve_device(device)
    text_enc = None
    if tokenizer is not None and text_encoder is not None:
        try:
            if not hasattr(text_encoder, "state_dict"):
                raise ValueError(f"{type(text_encoder).__name__} has no state dict")
            te_state, te_cfg = porting.port_torch_text_encoder(text_encoder)
            text_enc = NativeCLIPTextEncoder(
                tokenizer, porting.clip_text_model(te_state, te_cfg), te_cfg, device=dev)
        except (ValueError, KeyError) as te_err:
            print(f"[comfystereo-tpu] text-encoder port unavailable ({te_err}); "
                  "encoding text with the given module")
            _require_on(dev, text_encoder=text_encoder)
            text_enc = EmbeddingCache(_torch_text_encode(tokenizer, text_encoder, dev))
    try:
        unet_state, unet_cfg = porting.port_torch_unet(unet, cfg=unet_cfg)
        vae_state = None
        if vae is not None and hasattr(vae, "state_dict"):
            vae_state, vae_cfg = porting.port_torch_vae(vae, cfg=vae_cfg)
    except (ValueError, KeyError) as e:
        print(f"[comfystereo-tpu] weight port unavailable ({e}); falling back to "
              "running the given torch modules (no_grad)")
    else:
        return porting.build_sd_model(unet_cfg, vae_cfg, device=dev, unet_state=unet_state,
                                      vae_state=vae_state, text_encode=text_enc)

    _require_on(dev, unet=unet, vae=vae)

    @torch.no_grad()
    def unet_apply(latents, t, context, **_):
        tt = torch.as_tensor(t).reshape(()).long().to(dev)
        return _field(unet(latents, tt, encoder_hidden_states=context), "sample").float()

    return DiffusionModel(
        unet_apply=unet_apply,
        vae_encode=torch.no_grad()(lambda x: _field(vae.encode(x), "latent_dist").mean.float()),
        vae_decode=torch.no_grad()(lambda z: _field(vae.decode(z), "sample").float()),
        text_encode=text_enc if text_enc is not None else HashTextEncoder(dim=768, device=dev),
        device=dev,
        latent_channels=getattr(getattr(unet, "config", None), "in_channels", 4) or 4,
        context_dim=768)
