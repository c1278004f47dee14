"""The blur's box-blend kernel (one launch per chunk) against its bound: the
depth and both weights read once and both eyes written once, 20 B/px; per
pixel, with the cells' window (20 taps, radius 6), 2 x (12 adds, a division
and a clamp) for the weights, 19 adds and a division for the depth, and 2 x
4 for the blends: 56 operations. Reads nothing where no such kernel ran."""
from stereo_bench.readers import roofline

OPS_PER_PX = 2 * (12 + 2) + (19 + 1) + 2 * 4


def read(ctx):
    return roofline(ctx, r"\bbox_blend_kernel\b", lambda px: (20.0 * px, OPS_PER_PX * px), 1)
