"""End-to-end stereo conversion: blur -> warp -> pack, for a batch of frames.

The port's `stereo_pipeline` runs on the device of the tensors it is given
and keeps the whole chunk there between stages. Only the `gpu_warp` fill
technique is ported; the others raise NotImplementedError naming the ROADMAP
item that ports them.

Output contract (the Stereo Image node's, GenerateStereo.py:75-76): stereo
images (one per mode), blurred left/right depth maps, and the warp's
disocclusion gap mask. Depth outputs are the blurred depth / 255, clamped to
0-1 (the reference's uint8 wrap of an already-0-255 map is not reproduced).
"""
from __future__ import annotations

from typing import Dict

import torch

from .config import StereoConfig
from .ops import blur as blur_ops
from .ops import pack, warp

# Fill techniques still to port -> the ROADMAP item (queue 1) that ports them.
UNPORTED_FILLS = {
    "none": "queue 1 item 6 (CPU-parity fills)",
    "naive": "queue 1 item 6 (CPU-parity fills)",
    "naive_interpolating": "queue 1 item 6 (CPU-parity fills)",
    "none_post": "queue 1 item 6 (CPU-parity fills)",
    "inverse": "queue 1 item 6 (CPU-parity fills)",
    "inverse_post": "queue 1 item 6 (CPU-parity fills)",
    "hybrid_edge": "queue 1 item 6 (CPU-parity fills)",
    "hybrid_edge_plus": "queue 1 items 6-7 (fills and exact polylines)",
    "polylines_soft": "queue 1 item 7 (exact polylines)",
    "polylines_sharp": "queue 1 item 7 (exact polylines)",
}


def _blurred_eye_depths(depth255: torch.Tensor, cfg: StereoConfig):
    if cfg.depth_map_blur and cfg.depth_blur_strength > 0:
        return blur_ops.directional_motion_blur(
            depth255, cfg.depth_blur_strength, cfg.depth_blur_edge_threshold,
            cfg.depth_blur_strength, cfg.depth_blur_falloff,
            cfg.depth_blur_vert_smooth)
    return depth255, depth255


def stereo_pipeline(image: torch.Tensor, depth: torch.Tensor,
                    cfg: StereoConfig) -> Dict[str, object]:
    """Full depth->stereo conversion for a batch of frames.

    image: [B, H, W, C] float in [0, 1]; depth: [B, H, W] (0-1 or 0-255),
    both on one device.

    Returns dict:
      stereo:      tuple of packed outputs, one per cfg.modes, 0-1, in the
                   colour dtype (cfg.color_dtype)
      left_depth:  [B, H, W] blurred left-eye depth, 0-1
      right_depth: [B, H, W]
      mask:        [B, H, W] float 0/1 disocclusion mask (union of both eyes)
    """
    if cfg.fill_technique != "gpu_warp":
        raise NotImplementedError(
            f"fill_technique {cfg.fill_technique!r} is not ported yet: "
            f"ROADMAP {UNPORTED_FILLS[cfg.fill_technique]}")
    image = image.float()
    depth = depth.float()
    # 0-1 depth is scaled to 0-255 for the blur (reference :1045-1046,
    # :1474-1476); the test takes the max over the whole chunk, on the device.
    depth255 = torch.where(depth.max() <= 1.0, depth * 255.0, depth)

    left_d, right_d = _blurred_eye_depths(depth255, cfg)
    left_div, right_div = cfg.eye_divergences()
    w = image.shape[-2]
    sep_px = (cfg.separation / 100.0) * w

    if cfg.color_dtype == "bfloat16":
        image = image.to(torch.bfloat16)
    zero_mask = torch.zeros(depth.shape, dtype=torch.bool, device=depth.device)
    if left_div < 0.001:
        left_eye, left_mask = image, zero_mask
    else:
        left_eye, left_mask = warp.forward_warp(
            image, left_d, +(left_div / 100.0) * w, -sep_px,
            cfg.stereo_offset_exponent, cfg.convergence_point,
            cfg.gradient_threshold, cfg.max_stretch)
    if right_div < 0.001:
        right_eye, right_mask = image, zero_mask
    else:
        right_eye, right_mask = warp.forward_warp(
            image, right_d, -(right_div / 100.0) * w, +sep_px,
            cfg.stereo_offset_exponent, cfg.convergence_point,
            cfg.gradient_threshold, cfg.max_stretch)
    mask = (left_mask | right_mask).float()
    outs = tuple(torch.clamp(pack.pack_mode(left_eye, right_eye, m), 0.0, 1.0)
                 for m in cfg.modes)

    return {
        "stereo": outs,
        "left_depth": torch.clamp(left_d / 255.0, 0.0, 1.0),
        "right_depth": torch.clamp(right_d / 255.0, 0.0, 1.0),
        "mask": mask,
    }
