"""Kernel time per chunk of the pack and its clamp or divide (`pipeline.pack`)."""
from stereo_bench.spans import kernel_ms


def read(ctx):
    return kernel_ms(ctx.trace, ("pipeline.pack",))
