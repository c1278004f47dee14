"""Kernel time per chunk of the blur's box sums (`blur.box_h`, `blur.box_w`)."""
from stereo_bench.spans import kernel_ms


def read(ctx):
    return kernel_ms(ctx.trace, ("blur.box_h", "blur.box_w"))
