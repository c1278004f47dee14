"""Kernel time per chunk of the mask and the two depth outputs
(`pipeline.mask`, `pipeline.depth_outputs`), which `device_chunk` does not
return."""
from stereo_bench.spans import kernel_ms


def read(ctx):
    return kernel_ms(ctx.trace, ("pipeline.mask", "pipeline.depth_outputs"))
