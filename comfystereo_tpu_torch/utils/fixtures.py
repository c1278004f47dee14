"""Synthetic test fixtures: image + matching depth map.

Equivalent scene to the reference generator (create_test_images.py:9-57):
gradient background plus three circles at far/mid/near depths, with a
grayscale depth map (white = near, black = far). Implemented with numpy
meshgrids so fixtures are exactly reproducible without PIL.

A copy of `comfystereo_tpu.utils.fixtures` (numpy only), kept here so that
the port and its chip smoke test never import the JAX package.
"""
from __future__ import annotations

import numpy as np


def _disk(h: int, w: int, cy: float, cx: float, r: float) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    return (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r


def create_test_image(height: int = 600, width: int = 800) -> np.ndarray:
    """[H, W, 3] uint8 test image: gradient + three colored circles."""
    img = np.zeros((height, width, 3), dtype=np.uint8)
    y = np.arange(height, dtype=np.float32)[:, None]
    base = (180 + (y / height) * 60).astype(np.uint8)
    img[..., 0] = base
    img[..., 1] = np.clip(base.astype(np.int32) - 20, 0, 255).astype(np.uint8)
    img[..., 2] = np.clip(base.astype(np.int32) + 20, 0, 255).astype(np.uint8)

    sy, sx = height / 600.0, width / 800.0
    far = _disk(height, width, 225 * sy, 225 * sx, 75 * min(sy, sx))
    mid = _disk(height, width, 300 * sy, 450 * sx, 100 * min(sy, sx))
    near = _disk(height, width, 450 * sy, 300 * sx, 100 * min(sy, sx))
    img[far] = (100, 150, 200)
    img[mid] = (200, 100, 100)
    img[near] = (100, 200, 100)
    return img


def create_depth_map(height: int = 600, width: int = 800) -> np.ndarray:
    """[H, W] uint8 depth map matching create_test_image (white = near)."""
    y = np.arange(height, dtype=np.float32)[:, None]
    depth = np.broadcast_to(
        (80 + (y / height) * 50).astype(np.uint8), (height, width)).copy()
    sy, sx = height / 600.0, width / 800.0
    depth[_disk(height, width, 225 * sy, 225 * sx, 75 * min(sy, sx))] = 100
    depth[_disk(height, width, 300 * sy, 450 * sx, 100 * min(sy, sx))] = 170
    depth[_disk(height, width, 450 * sy, 300 * sx, 100 * min(sy, sx))] = 240
    return depth


def gradient_depth(height: int = 512, width: int = 512) -> np.ndarray:
    """Simple horizontal gradient depth (BASELINE.json config #1 style)."""
    x = np.linspace(0, 255, width, dtype=np.float32)[None, :]
    return np.broadcast_to(x, (height, width)).astype(np.uint8).copy()


def main():  # pragma: no cover - CLI convenience
    """Write test_image.png / test_depth.png (reference create_test_images)."""
    from PIL import Image

    Image.fromarray(create_test_image()).save("test_image.png")
    Image.fromarray(create_depth_map()).save("test_depth.png")
    print("wrote test_image.png, test_depth.png")


def batch_fixture(batch: int = 2, height: int = 96, width: int = 128,
                  seed: int = 0):
    """Small random-ish batch for fast unit tests: ([B,H,W,3] f32 0-1 image,
    [B,H,W] f32 0-1 depth)."""
    rng = np.random.default_rng(seed)
    imgs, depths = [], []
    for i in range(batch):
        img = create_test_image(height, width).astype(np.float32) / 255.0
        dm = create_depth_map(height, width).astype(np.float32) / 255.0
        img = np.clip(img + rng.normal(0, 0.02, img.shape).astype(np.float32), 0, 1)
        dm = np.clip(dm + rng.normal(0, 0.01, dm.shape).astype(np.float32), 0, 1)
        imgs.append(img)
        depths.append(dm)
    return np.stack(imgs), np.stack(depths)

if __name__ == "__main__":
    main()
