"""Edge-aware directional depth blur (reference directional_motion_blur,
stereoimage_generation.py:1171-1251 and :1346-1419): Sobel-x edge detection,
a row distance transform, box motion blur, and a distance-weighted blend.

Operates on [..., H, W] float32 depth in the 0-255 domain. Padding follows
the reference's CPU variant: symmetric for Sobel, edge-replicate for the box
blurs (scipy `mode='nearest'`). The box blurs are explicit sums of shifted
slices in ascending window order, the order a sequential `reduce_window`
adds in, so they round as the JAX package does. Every division by a scalar
is a true division on every device (`device.true_divide`), so the card
gives the CPU's bits. Two kernels make the blur: the edge-distance kernel's
fused entry forms the Sobel gradient, the masks, the distances and the
weights in one pass (`kernels/distance.py:edge_weights_fused`), and the
box-blend kernel the weights' vertical box means, the depth's horizontal box
mean and both blends (`kernels/box_blend.py:box_blend`). Their plain
versions' pieces, `sobel_x`, `edge_masks`, `distance_weight`, `box_blur_w`
and `box_blur_h`, live beside them and are used here.

The side blurs of the JAX package, which no pipeline path calls, are here
too in its forms: `gaussian_blur` (reference blur_depth_map),
`edge_selective_blur` and `direction_aware_blur`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import scan
from ..device import sqrt, true_divide
from ..kernels.box_blend import _edge_pad, box_blend
from ..kernels.box_blend import box_blur_h, box_blur_w  # noqa: F401  (the blur's own)
from ..kernels.distance import edge_masks, sobel_x  # noqa: F401  (the blur's own)
from ..kernels.distance import distance_weight, edge_weights_fused
from ..utils.profiling import span


def edge_distance_weight(edge_mask: torch.Tensor, mask_radius: int,
                         falloff_exponent: float) -> torch.Tensor:
    """weight = clip(1 - dist/mask_radius, 0, 1)^falloff, dist = horizontal
    distance to the nearest edge pixel in the row (reference :1131-1168),
    `mask_radius + 1` where the row has none. [..., H, W] bool -> float32."""
    w = edge_mask.shape[-1]
    cols = torch.arange(w, dtype=torch.float32, device=edge_mask.device)
    large = float(mask_radius + 1)
    left_idx = scan.nearest_true_left(edge_mask)
    dist_l = torch.where(left_idx >= 0, cols - left_idx.float(), large)
    right_idx = scan.nearest_true_right(edge_mask)
    dist_r = torch.where(right_idx < w, right_idx.float() - cols, large)
    return distance_weight(torch.minimum(dist_l, dist_r), mask_radius, falloff_exponent)


def _f32(x: float) -> float:
    """A Python float rounded to float32, as JAX holds a traced scalar."""
    return float(np.float32(x))


def directional_motion_blur(depth: torch.Tensor, blur_strength: float,
                            edge_threshold: float, blur_mask_width: float = 5,
                            falloff_exponent: float = 1.0,
                            vert_smooth_px: int = 0):
    """Directional depth blur producing per-eye depth maps.

    The left eye blurs dark->light (rising) edges, the right eye light->dark,
    each blended by a distance-transform weight around the edge.

    depth: [..., H, W] float32 (0-255 domain). Returns (left, right).
    """
    if blur_strength <= 0:
        return depth, depth
    n = int(round(blur_strength))
    with span("blur.directional"):
        depth = depth.float()
        h, w = depth.shape[-2:]
        with span("blur.edge_weights"):
            wl, wr = edge_weights_fused(depth.reshape(-1, w).contiguous(),
                                        edge_threshold=edge_threshold,
                                        mask_radius=int(blur_mask_width),
                                        falloff=_f32(falloff_exponent), height=h)
        with span("blur.box_w"):
            left, right = box_blend(depth.reshape(-1, h, w).contiguous(), wl.reshape(-1, h, w),
                                    wr.reshape(-1, h, w), taps=n,
                                    radius=int(vert_smooth_px) if vert_smooth_px > 0 else 0)
        return left.reshape(depth.shape), right.reshape(depth.shape)


def gaussian_blur(depth: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur, radius = 3*sigma, edge-replicate padding
    (reference blur_depth_map, :1253-1281). [..., H, W]. The kernel taps are
    float32, normalised by their sum, and added in ascending tap order."""
    if sigma <= 0:
        return depth
    radius = int(3 * sigma)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=depth.device)
    kernel = torch.exp(true_divide(-(x * x), _f32(2.0 * sigma * sigma)))
    kernel = kernel / torch.sum(kernel)

    def conv_axis(v: torch.Tensor, dim: int) -> torch.Tensor:
        # correlation by stacked slices (the symmetric kernel makes convolve
        # == correlate)
        n = v.shape[dim]
        vp = _edge_pad(v, dim, radius, radius)
        acc = torch.zeros_like(v)
        for i in range(2 * radius + 1):
            acc = acc + kernel[i] * vp.narrow(dim, i, n)
        return acc

    return conv_axis(conv_axis(depth.float(), -1), -2)


def edge_selective_blur(depth: torch.Tensor, sigma: float,
                        edge_threshold: float) -> torch.Tensor:
    """Direction-agnostic edge-selective blur: full Sobel magnitude weight
    blended between original and Gaussian-blurred depth (reference
    edge_selective_blur_depth_map, :1283-1309)."""
    gx = sobel_x(depth)
    gy = sobel_x(depth.transpose(-1, -2)).transpose(-1, -2)
    mag = sqrt(gx * gx + gy * gy)
    weight = torch.clamp(true_divide(mag, edge_threshold), max=1.0)
    blurred = gaussian_blur(depth, sigma)
    return (1.0 - weight) * depth + weight * blurred


def _central_diff_w(depth: torch.Tensor) -> torch.Tensor:
    dp = _edge_pad(depth, -1, 1, 1)
    return true_divide(dp[..., 2:] - dp[..., :-2], 2.0)


def direction_aware_blur(depth: torch.Tensor, sigma: float, edge_threshold: float,
                         eye: str) -> torch.Tensor:
    """One-sided gradient-weighted blur (reference
    left/right_direction_aware_blur_depth_map, :1311-1344): the left eye
    blurs rising (dark->light) gradients, the right eye falling ones."""
    grad = _central_diff_w(depth.float())
    if eye == "left":
        weight = torch.where(grad > 0, torch.clamp(true_divide(grad, edge_threshold),
                                                   max=1.0), 0.0)
    else:
        weight = torch.where(grad < 0, torch.clamp(
            true_divide(torch.abs(grad), edge_threshold), max=1.0), 0.0)
    blurred = gaussian_blur(depth, sigma)
    return (1.0 - weight) * depth + weight * blurred
