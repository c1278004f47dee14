"""Host time per chunk that the caller spends in `device_chunk`'s download
(`video.download`): the result's copy into page-locked host memory and the
wait for it, which holds the wait for the chunk's kernels."""
from stereo_bench.spans import host_ms


def read(ctx):
    return host_ms(ctx.trace, "video.download")
