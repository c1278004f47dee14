"""Host time per chunk in `device_chunk` outside its upload: the caller's
cost of launching the pass."""
from stereo_bench.spans import host_ms


def read(ctx):
    chunk, upload = host_ms(ctx.trace, "video.device_chunk"), host_ms(ctx.trace, "video.upload")
    return None if chunk is None or upload is None else chunk - upload
