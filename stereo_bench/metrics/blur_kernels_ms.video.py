"""Kernel time per chunk of the directional depth blur (`blur.directional`)."""
from stereo_bench.spans import kernel_ms


def read(ctx):
    return kernel_ms(ctx.trace, ("blur.directional",))
