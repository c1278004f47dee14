"""The blur's edge-weights kernel (one launch per chunk) against its bound."""
from stereo_bench.counts import kernels
from stereo_bench.readers import roofline


def read(ctx):
    return roofline(ctx, r"\bedge_distances_kernel\b", kernels.distance, 1)
