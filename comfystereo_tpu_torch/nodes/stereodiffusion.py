"""StereoDiffusion node: AI stereo generation through the port's diffusion stack.

The public contract (`INPUT_TYPES`, `RETURN_TYPES`, `RETURN_NAMES`,
`FUNCTION`, `CATEGORY`) is that of `comfystereo_tpu/nodes/stereodiffusion.py`.
The model resolves as the JAX node resolves it (`_resolve_model`): a
ready-made bundle, connected ComfyUI/torch modules (their weights carried
into the port's SD modules), a `model_id` (a local diffusers directory or a
hub id through `diffusion.model_loader`, then the diffusers adapter), or,
loudly, the offline toy model. Fast mode loads `inpaint_model_id` in bf16,
Standard mode `model_id` in float32. Both modes run at the model's square
sample size, with both eyes resized back to the input's size afterwards.
Fast (Warp + Inpaint), the default, runs all frames batched with per-frame
seeds seed + frame_idx; Standard (DDIM) runs the first frame through
`text2stereo` (DDIM inversion, null-text optimisation with 10 inner steps,
the stereo denoising loop).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, as_float_tensor, resolve_device
from ..diffusion import make_toy_model
from ..diffusion.sd_pipeline import resize_bilinear, text2stereo, warp_inpaint
from ..utils.caching import get_or_load_model
from ..utils.profiling import span

PIPELINE_MODES = ("Standard (DDIM)", "Fast (Warp + Inpaint)")
# What a model that is absent or unusable raises on the way through the
# loader and the diffusers adapter: the node then falls back to the toy.
# Device errors (a card out of memory, a launch failure) are not among them
# and propagate.
_UNLOADABLE = (ImportError, OSError, ValueError, KeyError)


def _resize_to(arr: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear-resize [B,H,W,...] to [B,h,w,...] (`resize_bilinear` over
    the trailing axes as channels)."""
    if arr.shape[1] == h and arr.shape[2] == w:
        return arr
    b, hh, ww = arr.shape[:3]
    x = arr.reshape(b, hh, ww, -1).permute(0, 3, 1, 2)
    x = resize_bilinear(x, h, w)
    return x.permute(0, 2, 3, 1).reshape((b, h, w) + tuple(arr.shape[3:]))


def _default_model(dev: torch.device):
    """The offline toy model at 64x64, built once per device (the port's
    model cache)."""
    return get_or_load_model(("toy", str(dev)),
                             lambda: make_toy_model(image_size=64, device=dev))


def _resolve_model(model=None, clip=None, vae=None, model_id="",
                   pipeline_mode="Fast (Warp + Inpaint)", device: DeviceLike = None):
    """The model bundle on `device` (None means CUDA), in the JAX node's order:

    1. an already-built bundle (duck-typed: has unet_apply);
    2. connected ComfyUI/torch MODEL + CLIP + VAE (`from_torch_modules`);
    3. a model_id: the port's loader (Fast mode: `load_inpainting_model`,
       bf16; Standard: `load_sd_model` with ddim, float32), then the
       diffusers adapter;
    4. the offline toy model, with a loud banner and the attempt trail when
       a model_id could not be loaded (a missing or unusable checkpoint,
       `_UNLOADABLE`; any other error, a device's included, propagates).
    """
    if model is not None and hasattr(model, "unet_apply"):
        return model
    dev = resolve_device(device)
    if model is not None:
        from ..diffusion.adapters import from_torch_modules

        unet = getattr(getattr(model, "model", model), "diffusion_model", model)
        tokenizer = getattr(clip, "tokenizer", clip)
        text_enc = getattr(clip, "cond_stage_model", clip)
        return from_torch_modules(unet, vae, tokenizer, text_enc, device=dev)
    if model_id:
        from ..diffusion import model_loader
        from ..diffusion.adapters import from_diffusers

        errors = []
        try:
            if pipeline_mode == "Standard (DDIM)":
                return model_loader.load_sd_model(model_id, "ddim", device=dev)
            return model_loader.load_inpainting_model(model_id, device=dev)
        except model_loader.ModelUnavailableError as e:
            errors.extend(e.attempts)
        except _UNLOADABLE as e:
            errors.append(f"native port: {type(e).__name__}: {e}")
        try:
            return from_diffusers(model_id, device=dev)
        except _UNLOADABLE as e:
            errors.append(f"diffusers adapter: {type(e).__name__}: {e}")
        # Loud fallback: the attempt trail is printed, so a toy-model render
        # cannot pass for Stable Diffusion output.
        print("=" * 70)
        print(f"[comfystereo-tpu] WARNING: model '{model_id}' could not be "
              "loaded — FALLING BACK TO THE OFFLINE TOY MODEL.")
        print("[comfystereo-tpu] Outputs will NOT be Stable Diffusion "
              "quality. Attempt trail:")
        for err in errors:
            print(f"[comfystereo-tpu]   - {err}")
        print("=" * 70)
    return _default_model(dev)


class StereoDiffusionNode:
    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image": ("IMAGE",),
                "depth_map": ("IMAGE",),
                "scale_factor": ("FLOAT", {
                    "default": 5.0, "min": 1.0, "max": 20.0, "step": 0.5,
                    "tooltip": "Disparity strength of the generated stereo "
                               "effect."}),
                "direction": (["uni", "bi"], {
                    "default": "uni",
                    "tooltip": "Cross-view attention direction: uni = "
                               "one-way (left guides right), bi = "
                               "two-way."}),
                "deblur": ("BOOLEAN", {
                    "default": False,
                    "tooltip": "Inject noise into unfilled regions so the "
                               "model does not blur them."}),
                "pipeline_mode": (list(PIPELINE_MODES), {
                    "default": "Fast (Warp + Inpaint)",
                    "tooltip": "Standard: DDIM inversion — higher quality, "
                               "slow. Fast: depth-warp the image, then "
                               "AI-inpaint only the revealed gaps — quick, "
                               "compatible with turbo/LCM models."}),
                "guidance_scale": ("FLOAT", {
                    "default": 3.0, "min": 0.0, "max": 20.0, "step": 0.5,
                    "tooltip": "Classifier-free guidance scale. Standard "
                               "mode: 3-10. Turbo checkpoints: 0.0. LCM: "
                               "1.0-2.0."}),
                "num_inference_steps": ("INT", {
                    "default": 20, "min": 1, "max": 100, "step": 1,
                    "tooltip": "Denoising steps. Standard DDIM: 30-100 "
                               "(50 typical). Fast inpainting: 20-30. "
                               "Turbo/LCM: 1-8."}),
                "seed": ("INT", {
                    "default": 1337, "min": 0,
                    "max": 0xffffffffffffffff,
                    "control_after_generate": True,
                    "tooltip": "PRNG seed for reproducible outputs."}),
            },
            "optional": {
                "null_text_optimization": ("BOOLEAN", {
                    "default": True,
                    "tooltip": "Optimize the null-text embedding for a more "
                               "faithful reconstruction (Standard mode "
                               "only)."}),
                "denoise_strength": ("FLOAT", {
                    "default": 0.6, "min": 0.1, "max": 1.0, "step": 0.05,
                    "tooltip": "Noise added before denoising in Fast mode. "
                               "Lower preserves the original; higher gives "
                               "the model more freedom to fill gaps."}),
                "model": ("MODEL", {
                    "tooltip": "ComfyUI MODEL input. Fast mode: connect an "
                               "inpainting model (9-channel UNet). Standard "
                               "mode: any SD1/SD2 model."}),
                "clip": ("CLIP", {
                    "tooltip": "CLIP from Load Checkpoint."}),
                "vae": ("VAE", {
                    "tooltip": "VAE from Load Checkpoint."}),
                "model_id": ("STRING", {
                    "default": "runwayml/stable-diffusion-v1-5",
                    "tooltip": "Fallback HuggingFace model id used by "
                               "Standard mode when no ComfyUI model is "
                               "connected."}),
                "inpaint_model_id": ("STRING", {
                    "default": "runwayml/stable-diffusion-inpainting",
                    "tooltip": "Fallback inpainting model id used by Fast "
                               "mode when no ComfyUI model is connected."}),
                "prompt": ("STRING", {
                    "default": "", "multiline": True,
                    "tooltip": "Optional text prompt guiding the inpainting "
                               "(Fast mode); describing the image content "
                               "improves gap filling."}),
            },
        }

    RETURN_TYPES = ("IMAGE", "IMAGE", "IMAGE")
    RETURN_NAMES = ("stereo_pair", "left_image", "right_image")
    FUNCTION = "generate_stereo"
    CATEGORY = "image/stereo"

    def generate_stereo(self, image, depth_map, scale_factor=5.0,
                        direction="uni", deblur=False,
                        pipeline_mode="Fast (Warp + Inpaint)",
                        guidance_scale=3.0, num_inference_steps=20,
                        seed=1337, null_text_optimization=True,
                        denoise_strength=0.6, model=None, clip=None,
                        vae=None, model_id="", inpaint_model_id="",
                        prompt="", device: DeviceLike = None):
        """Returns (stereo_pair [B,H,2W,3], left [B,H,W,3], right [B,H,W,3])
        as CPU float32 tensors. `device=None` means CUDA; a given bundle must
        live on the same device, and a resolved model is loaded there. The
        call is the span `node.stereo_diffusion`."""
        with span("node.stereo_diffusion"):
            dev = resolve_device(device)
            # Fast mode prefers the inpainting checkpoint.
            wanted_id = inpaint_model_id if pipeline_mode != "Standard (DDIM)" else model_id
            model = _resolve_model(model, clip, vae, wanted_id, pipeline_mode, device=dev)
            if torch.device(model.device) != dev:
                raise ValueError(f"model bundle on {model.device}, node asked for {dev}")
            img = as_float_tensor(image, dev)
            dm = as_float_tensor(depth_map, dev)
            if img.dim() == 3:
                img = img[None]
            if dm.dim() == 4:
                dm = (0.2989 * dm[..., 0] + 0.5870 * dm[..., 1]
                      + 0.1140 * dm[..., 2]) if dm.shape[-1] == 3 else dm[..., 0]
            if dm.dim() == 2:
                dm = dm[None]

            # Diffusion runs at the model's native square sample size; results
            # are resized back to the input size afterwards (both eyes).
            orig_h, orig_w = img.shape[1], img.shape[2]
            s = int(getattr(model, "sample_size", 512) or 512)
            img = _resize_to(img, s, s)
            dm = _resize_to(dm, s, s)
            with torch.no_grad():
                if pipeline_mode == "Standard (DDIM)":
                    # First frame only; null-text optimisation enables autograd
                    # for itself.
                    out = text2stereo(
                        model, img[:1].permute(0, 3, 1, 2) * 2.0 - 1.0, dm[:1], prompt,
                        scale_factor=scale_factor, direction=direction, deblur=deblur,
                        guidance_scale=guidance_scale,
                        num_inference_steps=num_inference_steps,
                        null_text_optimization=null_text_optimization, seed=seed)
                else:
                    out = warp_inpaint(
                        model, img, dm, prompt, divergence=scale_factor,
                        num_inference_steps=num_inference_steps,
                        strength=denoise_strength, guidance_scale=guidance_scale,
                        seed=seed + np.arange(img.shape[0], dtype=np.uint64),
                        original_size=(orig_h, orig_w))
            left = _resize_to(out.left, orig_h, orig_w).cpu()
            right = _resize_to(out.right, orig_h, orig_w).cpu()
            return torch.cat([left, right], dim=2), left, right


NODE_CLASS_MAPPINGS = {"StereoDiffusionNode": StereoDiffusionNode}
NODE_DISPLAY_NAME_MAPPINGS = {"StereoDiffusionNode": "Stereo Diffusion"}
