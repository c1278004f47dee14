"""End-to-end stereo conversion: blur -> warp or fill -> pack, for a batch of
frames.

The port's `stereo_pipeline` runs on the device of the tensors it is given
and keeps the whole chunk there between stages. Two branches, as in the JAX
package: `gpu_warp` (the forward warp, float32 or bfloat16 colour), and the
CPU-parity fills, which work on uint8-valued float32 images through
`apply_stereo_divergence`. The polylines fills and the hybrid_edge_plus
backfill take the exact renderer by default and the supersampled one with
`polylines_exact=False` (`polylines_samples` sub-samples per pixel).

Output contract (the Stereo Image node's, GenerateStereo.py:75-76): stereo
images (one per mode), blurred left/right depth maps, and the no-fill
imperfection mask: the warp's disocclusion gap mask for gpu_warp, black-pixel
detection on the first packed output for the fills (GenerateStereo.py:
355-361). Depth outputs are the blurred depth / 255, clamped to 0-1 (the
reference's uint8 wrap of an already-0-255 map is not reproduced).
"""
from __future__ import annotations

from typing import Dict

import torch

from .config import StereoConfig
from .device import true_divide
from .ops import blur as blur_ops
from .ops import depth as depth_ops
from .ops import fills, pack, polylines, polylines_exact, warp
from .utils.profiling import span


def apply_stereo_divergence(image_u8: torch.Tensor, depth: torch.Tensor,
                            divergence: float, separation: float,
                            stereo_offset_exponent: float,
                            fill_technique: str,
                            convergence_point: float = 0.5,
                            polylines_samples: int = 8,
                            polylines_exact_mode: bool = True,
                            depth_range=None) -> torch.Tensor:
    """CPU-parity single-eye dispatcher (reference :1576-1620).

    image_u8: [B,H,W,C] float32 holding uint8 values; depth: [B,H,W] raw.
    divergence/separation are percentages of image width. depth_range:
    each frame's (min [B], max [B]) to normalise by, where `depth` holds
    only some of a frame's rows (the sharded pipeline); by default each
    frame's own.
    """
    w = image_u8.shape[-2]
    if depth_range is None:
        nd = depth_ops.normalize_depth(depth)
    else:
        nd = depth_ops.normalize_between(depth.float(), depth_range[0][:, None, None],
                                         depth_range[1][:, None, None])
    nd = nd - convergence_point
    divergence_px = (divergence / 100.0) * w
    separation_px = (separation / 100.0) * w
    exp = stereo_offset_exponent

    if fill_technique in ("none", "naive", "naive_interpolating", "none_post"):
        derived, filled = fills.naive_scatter(image_u8, nd, divergence_px,
                                              separation_px, exp)
        if fill_technique == "naive":
            return fills.fill_naive(derived, filled, divergence_px)
        if fill_technique == "naive_interpolating":
            return fills.fill_naive_interpolating(derived, filled)
        if fill_technique == "none_post":
            return fills.post_fill_interp(derived, filled)
        return derived
    if fill_technique in ("inverse", "inverse_post"):
        derived, filled = fills.inverse_splat(image_u8, nd, divergence_px,
                                              separation_px, exp)
        if fill_technique == "inverse_post":
            return fills.post_fill_interp(derived, filled)
        return derived
    if fill_technique in ("hybrid_edge", "hybrid_edge_plus"):
        base, mask = fills.gaussian_splat(image_u8, nd, divergence_px,
                                          separation_px, exp)
        guidance = fills.rgb2gray(image_u8)
        filled_img = fills.edge_aware_gap_fill(base, mask, guidance)
        if fill_technique == "hybrid_edge_plus":
            if polylines_exact_mode:
                poly = polylines_exact.apply_polylines_exact(
                    image_u8, nd, divergence_px, separation_px, exp, sharp=False)
            else:
                poly = polylines.apply_polylines(
                    image_u8, nd, divergence_px, separation_px, exp, sharp=False,
                    samples=polylines_samples)
            black = filled_img.sum(-1) == 0
            return torch.where(black[..., None], poly, filled_img)
        return filled_img
    if fill_technique in ("polylines_soft", "polylines_sharp"):
        sharp = fill_technique == "polylines_sharp"
        if polylines_exact_mode:
            # Exact sub-interval integration: bit-parity with the reference
            # scanline renderer (:1947-1991).
            return polylines_exact.apply_polylines_exact(
                image_u8, nd, divergence_px, separation_px, exp, sharp=sharp)
        return polylines.apply_polylines(
            image_u8, nd, divergence_px, separation_px, exp, sharp=sharp,
            samples=polylines_samples)
    return image_u8  # reference fallback (:1620)


# The stages of stereo_pipeline, in order. They are separate so that a stage
# can be timed alone on the inputs the pipeline gives it (chip_smoke.py), and
# each records its span (`utils.profiling.span`), on the sharded path too.

def _depth255(depth: torch.Tensor) -> torch.Tensor:
    # 0-1 depth is scaled to 0-255 for the blur (reference :1045-1046,
    # :1474-1476); the test takes the max over the whole chunk, on the device.
    with span("pipeline.depth255"):
        return torch.where(depth.max() <= 1.0, depth * 255.0, depth)


def _blurred_eye_depths(depth255: torch.Tensor, cfg: StereoConfig):
    if cfg.depth_map_blur and cfg.depth_blur_strength > 0:
        return blur_ops.directional_motion_blur(
            depth255, cfg.depth_blur_strength, cfg.depth_blur_edge_threshold,
            cfg.depth_blur_strength, cfg.depth_blur_falloff,
            cfg.depth_blur_vert_smooth)
    return depth255, depth255


def _eye_source(image: torch.Tensor, cfg: StereoConfig) -> torch.Tensor:
    """The colour both eyes are made from: the image in the colour dtype for
    gpu_warp, uint8 values in float32 for the fills."""
    with span("pipeline.eye_source"):
        if cfg.fill_technique == "gpu_warp":
            return image.to(torch.bfloat16) if cfg.color_dtype == "bfloat16" else image
        return torch.trunc(torch.clamp(image * 255.0, 0.0, 255.0))


def _eye(src: torch.Tensor, eye_d: torch.Tensor, div: float, sign: float,
         cfg: StereoConfig, depth_range=None):
    """One eye (sign +1 left, -1 right): (colour, gap mask) for gpu_warp,
    (colour, None) for the fills. An eye under 0.001% divergence is the
    source itself. depth_range: each frame's depth (min, max) where eye_d
    holds only some of its rows (`parallel/pipeline.py`)."""
    with span("pipeline.eye"):
        warp_path = cfg.fill_technique == "gpu_warp"
        if div < 0.001:
            gap = (torch.zeros(eye_d.shape, dtype=torch.bool, device=eye_d.device)
                   if warp_path else None)
            return src, gap
        if warp_path:
            w = src.shape[-2]
            return warp.forward_warp(
                src, eye_d, sign * ((div / 100.0) * w), -sign * ((cfg.separation / 100.0) * w),
                cfg.stereo_offset_exponent, cfg.convergence_point,
                cfg.gradient_threshold, cfg.max_stretch, depth_range=depth_range)
        return apply_stereo_divergence(
            src, eye_d, sign * div, -sign * cfg.separation,
            cfg.stereo_offset_exponent, cfg.fill_technique,
            cfg.convergence_point, cfg.polylines_samples, cfg.polylines_exact,
            depth_range=depth_range), None


def _outputs(left, right, left_d: torch.Tensor, right_d: torch.Tensor,
             cfg: StereoConfig) -> Dict[str, object]:
    """Pack the two eyes of `_eye` into every mode, with the mask and the
    depth outputs."""
    (left_eye, left_mask), (right_eye, right_mask) = left, right
    warp_path = cfg.fill_technique == "gpu_warp"
    with span("pipeline.pack"):
        outs = tuple(torch.clamp(o, 0.0, 1.0) if warp_path else true_divide(o, 255.0)
                     for o in (pack.pack_mode(left_eye, right_eye, m) for m in cfg.modes))
    with span("pipeline.mask"):
        # gpu_warp: the eyes' gap masks; the fills: black pixels of the first
        # packed output (GenerateStereo.py:355-361), which are 0 after the
        # division by 255 exactly where they were 0 before it.
        mask = ((left_mask | right_mask) if warp_path else outs[0].sum(-1) == 0).float()
    with span("pipeline.depth_outputs"):
        left_depth = torch.clamp(true_divide(left_d, 255.0), 0.0, 1.0)
        right_depth = torch.clamp(true_divide(right_d, 255.0), 0.0, 1.0)
    return {"stereo": outs, "left_depth": left_depth, "right_depth": right_depth,
            "mask": mask}


def stereo_pipeline(image: torch.Tensor, depth: torch.Tensor,
                    cfg: StereoConfig) -> Dict[str, object]:
    """Full depth->stereo conversion for a batch of frames.

    image: [B, H, W, C] float in [0, 1]; depth: [B, H, W] (0-1 or 0-255),
    both on one device, or both `parallel.ShardedTensor`s sharded alike
    over a mesh (`parallel.shard_batch`), and then every output comes back
    sharded as they are, bit-equal to the unsharded run
    (`parallel/pipeline.py`).

    Returns dict:
      stereo:      tuple of packed outputs, one per cfg.modes, 0-1; in the
                   colour dtype (cfg.color_dtype) for gpu_warp, float32 for
                   the fills
      left_depth:  [B, H, W] blurred left-eye depth, 0-1
      right_depth: [B, H, W]
      mask:        float 0/1 no-fill imperfection mask: [B, H, W] for
                   gpu_warp; for the fills, the first packed output's shape
                   without its channel axis
    """
    from .parallel.sharding import ShardedTensor
    with span("pipeline.stereo_pipeline"):
        if isinstance(image, ShardedTensor) or isinstance(depth, ShardedTensor):
            from .parallel.pipeline import sharded_pipeline
            return sharded_pipeline(image, depth, cfg)
        left_d, right_d = _blurred_eye_depths(_depth255(depth.float()), cfg)
        left_div, right_div = cfg.eye_divergences()
        src = _eye_source(image.float(), cfg)
        return _outputs(_eye(src, left_d, left_div, +1.0, cfg),
                        _eye(src, right_d, right_div, -1.0, cfg), left_d, right_d, cfg)
