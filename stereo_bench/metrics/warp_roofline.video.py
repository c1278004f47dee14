"""The warp kernel (one launch per eye) against its bound."""
from stereo_bench.counts import kernels
from stereo_bench.readers import roofline


def read(ctx):
    return roofline(ctx, r"\bwarp_rows_kernel\b", kernels.warp, 2)
