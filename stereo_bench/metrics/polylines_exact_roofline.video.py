"""The exact polylines kernel (one launch per eye) against its bound."""
from stereo_bench.counts import kernels
from stereo_bench.readers import roofline


def read(ctx):
    return roofline(ctx, r"\bpolylines_exact_kernel\b", kernels.polylines_exact, 2)
