"""Stereo Image node: the public node contract of the JAX package's node.

`INPUT_TYPES`, `RETURN_TYPES`, `RETURN_NAMES`, `FUNCTION` and `CATEGORY` are
those of `comfystereo_tpu/nodes/stereo_image.py` (reference
GenerateStereo.py:47-77). `generate` accepts numpy arrays or torch tensors,
runs on the card unless `device="cpu"` is passed, streams frames through the
pipeline in `batch_size` chunks, and returns CPU float32 tensors with the JAX
node's shapes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import MODES, UI_FILL_MAPPING, StereoConfig
from ..device import DeviceLike, as_float_tensor, resolve_device
from ..pipeline import stereo_pipeline

try:  # ComfyUI progress bar, optional
    from comfy.utils import ProgressBar  # type: ignore
except ImportError:  # pragma: no cover
    class ProgressBar:
        def __init__(self, total):
            self.total = total

        def update(self, n):
            pass


def _gray_depth(dm: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] or [B,H,W] -> [B,H,W] grayscale (GenerateStereo.py:134-139)."""
    if dm.dim() == 4:
        if dm.shape[-1] == 3:
            return (0.2989 * dm[..., 0] + 0.5870 * dm[..., 1]
                    + 0.1140 * dm[..., 2])
        return dm[..., 0]
    return dm


def _resize_bilinear(dm: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H', W'] -> [B, h, w]. Antialiased when it downsamples, as
    `jax.image.resize(..., "bilinear")` is."""
    if tuple(dm.shape[1:]) == (h, w):
        return dm
    return F.interpolate(dm[:, None], size=(h, w), mode="bilinear",
                         align_corners=False, antialias=True)[:, 0]


class StereoImageNode:
    """Depth map + image -> stereoscopic image (SBS/TB/anaglyph)."""

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "image": ("IMAGE",),
                "depth_map": ("IMAGE",),
                "modes": (list(MODES[:5]),),
                "fill_technique": (list(UI_FILL_MAPPING.keys())[:8], {
                    "default": "GPU Warp (Fast)",
                    "tooltip": "How disoccluded (newly revealed) areas are "
                               "filled. 'GPU Warp (Fast)' is the fast "
                               "accelerator warp; 'No fill' leaves gaps "
                               "black; 'No fill - Reverse projection' fills "
                               "by reverse projection (artifacts possible); "
                               "'Imperfect fill - Hybrid Edge' mixes "
                               "edge-based fill; the remaining 'Fill' "
                               "variants trade quality for speed with "
                               "different gap-filling algorithms."}),
            },
            "optional": {
                "divergence": ("FLOAT", {
                    "default": 4.5, "min": 0.05, "max": 15, "step": 0.01,
                    "tooltip": "Strength of the stereo effect. Larger values "
                               "deepen the 3D impression but can become "
                               "uncomfortable to view."}),
                "separation": ("FLOAT", {
                    "default": 0, "min": -5, "max": 5, "step": 0.01,
                    "tooltip": "Extra horizontal offset between the stereo "
                               "pair. Positive widens, negative narrows; "
                               "useful for tuning the effect and reducing "
                               "ghosting."}),
                "stereo_balance": ("FLOAT", {
                    "default": 0, "min": -0.95, "max": 0.95, "step": 0.05,
                    "tooltip": "How the total shift is split between the two "
                               "eyes. Positive biases the left image, "
                               "negative the right; compensates an "
                               "unbalanced stereo effect."}),
                "convergence_point": ("FLOAT", {
                    "default": 0.5, "min": 0.0, "max": 1.0, "step": 0.05,
                    "tooltip": "Depth plane where the eyes converge (zero "
                               "parallax): 0.0 converges at the far plane, "
                               "1.0 at the near plane."}),
                "stereo_offset_exponent": ("FLOAT", {
                    "default": 2, "min": 0.1, "max": 2, "step": 0.1,
                    "tooltip": "Exponent of the depth-to-shift curve. Higher "
                               "values emphasize near depths; lower values "
                               "spread the effect evenly across all "
                               "depths."}),
                "depth_map_blur": ("BOOLEAN", {
                    "default": True,
                    "tooltip": "Blur the depth map before warping. Smooths "
                               "noise and depth transitions, improving "
                               "results around high-frequency detail."}),
                "depth_blur_edge_threshold": ("FLOAT", {
                    "default": 20, "min": 0.1, "max": 60, "step": 0.1,
                    "tooltip": "Edge-preservation threshold for the depth "
                               "blur. Lower keeps more edges crisp; higher "
                               "lets the blur cross more edges."}),
                "depth_blur_strength": ("FLOAT", {
                    "default": 20, "min": 0.1, "max": 200, "step": 0.1,
                    "tooltip": "Intensity of the depth-map blur. Higher "
                               "smooths noisy or harsh depth maps more, at "
                               "the cost of fine depth detail."}),
                "depth_blur_falloff": ("FLOAT", {
                    "default": 2.0, "min": 0.1, "max": 4.0, "step": 0.1,
                    "tooltip": "Falloff curve of blur influence away from "
                               "edges (1.0 = linear). Higher keeps the blur "
                               "tight to edges — better for thin objects; "
                               "lower spreads a softer influence."}),
                "depth_blur_vert_smooth": ("INT", {
                    "default": 6, "min": 0, "max": 15, "step": 1,
                    "tooltip": "Vertical smoothing radius (px) on the blur "
                               "weight map; blends activation across rows to "
                               "remove horizontal stripe artifacts. 0 "
                               "disables; 3-7 is typical."}),
                "batch_size": ("INT", {
                    "default": 12, "min": 1, "max": 64, "step": 1,
                    "tooltip": "Frames processed per device batch. Smaller "
                               "uses less accelerator memory; larger is "
                               "usually faster."}),
            },
        }

    RETURN_TYPES = ("IMAGE", "IMAGE", "IMAGE", "MASK")
    RETURN_NAMES = ("stereoscope", "blurred_depthmap_left",
                    "blurred_depthmap_right", "no_fill_imperfect_mask")
    FUNCTION = "generate"
    CATEGORY = "stereo"

    def generate(self, image, depth_map, divergence=4.5, separation=0.0,
                 modes="left-right", stereo_balance=0.0, convergence_point=0.5,
                 stereo_offset_exponent=2.0, fill_technique="GPU Warp (Fast)",
                 depth_blur_edge_threshold=20.0, depth_blur_strength=20.0,
                 depth_map_blur=True, depth_blur_falloff=2.0,
                 depth_blur_vert_smooth=6, batch_size=12,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        img = as_float_tensor(image, dev)
        dm = _gray_depth(as_float_tensor(depth_map, dev))
        if img.dim() == 3:
            img = img[None]
        if dm.dim() == 2:
            dm = dm[None]
        b, h, w, _ = img.shape
        dm = _resize_bilinear(dm, h, w)

        cfg = StereoConfig(
            divergence=float(divergence), separation=float(separation),
            stereo_balance=float(stereo_balance),
            convergence_point=float(convergence_point),
            stereo_offset_exponent=float(stereo_offset_exponent),
            fill_technique=UI_FILL_MAPPING.get(fill_technique, "gpu_warp"),
            modes=(modes,) if isinstance(modes, str) else tuple(modes),
            depth_map_blur=bool(depth_map_blur),
            depth_blur_edge_threshold=float(depth_blur_edge_threshold),
            depth_blur_strength=float(depth_blur_strength),
            depth_blur_falloff=float(depth_blur_falloff),
            depth_blur_vert_smooth=int(depth_blur_vert_smooth),
            batch_size=int(batch_size))

        results, lds, rds, masks = [], [], [], []
        pbar = ProgressBar(b)
        for s in range(0, b, cfg.batch_size):
            e = min(s + cfg.batch_size, b)
            out = stereo_pipeline(img[s:e], dm[s:e], cfg)
            results.append(out["stereo"][0].float().cpu())
            lds.append(out["left_depth"].cpu())
            rds.append(out["right_depth"].cpu())
            masks.append(out["mask"].cpu())
            pbar.update(e - s)

        stereo = torch.cat(results, dim=0)
        left_d = torch.cat(lds, dim=0)[..., None].repeat(1, 1, 1, 3)
        right_d = torch.cat(rds, dim=0)[..., None].repeat(1, 1, 1, 3)
        mask = torch.cat(masks, dim=0)
        return stereo, left_d, right_d, mask


NODE_CLASS_MAPPINGS = {"StereoImageNode": StereoImageNode}
NODE_DISPLAY_NAME_MAPPINGS = {"StereoImageNode": "Stereo Image Node"}
