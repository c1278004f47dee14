"""The benchmark's scene generator: seeded images with depth maps of the kind
a monocular depth estimator gives.

A scene is a textured colour image and an 8-bit grey depth map (white =
near): a smooth ground gradient, far at the top and near at the bottom,
and 6-12 objects (ellipses and rounded boxes) at random depths, each with a
sharp edge and a smooth dome inside. Objects are painted far to near, so a
nearer one hides what it covers, as in a real scene. The colour image has
a low-frequency colour field, fine noise, and per-object stripes, so that
the warp's bilinear taps and the polylines' colour blends see real
gradients.

Everything comes from one `numpy.random.Generator` seeded with the run's
seed, so the same seed gives the same bytes on every machine; the work of
every seed has the same sizes and the same number of frames.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

OBJECTS = (6, 12)        # objects per scene, inclusive
GROUND = (20.0, 110.0)   # depth of the ground at the top and at the bottom
OBJECT_DEPTH = (60.0, 245.0)
DOME = 10.0              # depth added at an object's centre over its rim


def _ramp(rng: np.random.Generator, n: int, knots: int) -> np.ndarray:
    """A smooth random [n, 3] colour profile: `knots` random values joined
    linearly."""
    xs = np.linspace(0.0, knots - 1.0, n, dtype=np.float32)
    vals = rng.random((knots, 3), dtype=np.float32)
    return np.stack([np.interp(xs, np.arange(knots), vals[:, k]) for k in range(3)],
                    -1).astype(np.float32)


def scene(rng: np.random.Generator, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """One scene: (RGB uint8 [h, w, 3], grey depth uint8 [h, w])."""
    # A low-frequency colour field (a ramp along each axis) and fine noise.
    img = (_ramp(rng, h, 10)[:, None] * 110.0 + 20.0) + _ramp(rng, w, 16)[None] * 110.0
    img += rng.integers(0, 16, (h, w, 3), dtype=np.uint8)
    depth = np.broadcast_to(
        np.linspace(GROUND[0], GROUND[1], h, dtype=np.float32)[:, None], (h, w)).copy()

    n = int(rng.integers(OBJECTS[0], OBJECTS[1] + 1))
    objs = []
    for _ in range(n):
        objs.append(dict(
            d=float(rng.uniform(*OBJECT_DEPTH)),
            cy=float(rng.uniform(0.1, 0.9) * h), cx=float(rng.uniform(0.05, 0.95) * w),
            ry=float(rng.uniform(0.06, 0.3) * h), rx=float(rng.uniform(0.04, 0.2) * w),
            boxy=bool(rng.integers(0, 2)), color=rng.uniform(0.0, 255.0, 3).astype(np.float32),
            freq=float(rng.uniform(0.05, 0.6)), phase=float(rng.uniform(0.0, 6.3))))
    for o in sorted(objs, key=lambda o: o["d"]):  # far first, near last
        y0, y1 = max(int(o["cy"] - o["ry"]), 0), min(int(o["cy"] + o["ry"]) + 1, h)
        x0, x1 = max(int(o["cx"] - o["rx"]), 0), min(int(o["cx"] + o["rx"]) + 1, w)
        if y0 >= y1 or x0 >= x1:
            continue
        yy = ((np.arange(y0, y1, dtype=np.float32) - o["cy"]) / o["ry"])[:, None]
        xx = ((np.arange(x0, x1, dtype=np.float32) - o["cx"]) / o["rx"])[None, :]
        r2 = np.maximum(yy ** 4, xx ** 4) if o["boxy"] else yy * yy + xx * xx
        inside = r2 < 1.0
        depth[y0:y1, x0:x1] = np.where(inside, o["d"] + DOME * (1.0 - r2), depth[y0:y1, x0:x1])
        stripes = 0.5 + 0.5 * np.sin(xx * o["freq"] * o["rx"] + yy * o["freq"] * 0.3 * o["ry"]
                                     + o["phase"])
        tex = o["color"] * (0.6 + 0.4 * stripes[..., None])
        img[y0:y1, x0:x1] = np.where(inside[..., None], tex, img[y0:y1, x0:x1])
    rgb = np.clip(img, 0.0, 255.0).astype(np.uint8)
    return rgb, np.clip(depth, 0.0, 255.0).astype(np.uint8)


def video(seed: int, frames: int, h: int, w: int, pan: Tuple[int, int]):
    """`frames` frames of one scene panned sideways by a few columns per
    frame (a step drawn from `pan`, inclusive): (BGR uint8 [frames, h, w, 3]
    as a video decoder gives them, grey depth as BGR uint8 [frames, h, w,
    3])."""
    rng = np.random.default_rng(seed)
    step = int(rng.integers(pan[0], pan[1] + 1))
    rgb, depth = scene(rng, h, w + step * (frames - 1))
    bgr = np.stack([rgb[:, k * step:k * step + w, ::-1] for k in range(frames)])
    dep = np.stack([depth[:, k * step:k * step + w] for k in range(frames)])
    return np.ascontiguousarray(bgr), np.ascontiguousarray(np.repeat(dep[..., None], 3, -1))

