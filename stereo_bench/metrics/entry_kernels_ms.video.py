"""Kernel time per chunk of the chunk entry's conversions (`video.to_float`,
`video.to_u8`)."""
from stereo_bench.spans import kernel_ms


def read(ctx):
    return kernel_ms(ctx.trace, ("video.to_float", "video.to_u8"))
