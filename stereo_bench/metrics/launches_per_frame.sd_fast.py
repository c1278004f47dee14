"""Device kernels launched in the traced stretch, per frame done."""
from stereo_bench.readers import launches


def read(ctx):
    return launches(ctx, per_frame=True)
