"""Host time per chunk that the caller spends in `device_chunk`'s upload
(`video.upload`): its own HtoD copies and any wait behind the stream."""
from stereo_bench.spans import host_ms


def read(ctx):
    return host_ms(ctx.trace, "video.upload")
