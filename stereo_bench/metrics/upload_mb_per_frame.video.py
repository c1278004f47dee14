"""Bytes of host inputs that `device_chunk` moved to the card per frame, in
MB, from the program's counters (`utils/video.py`: `UPLOAD_BYTES` over
`FRAMES`; the warm-up calls count in both)."""
import sys


def read(ctx):
    video = sys.modules.get("comfystereo_tpu_torch.utils.video")
    frames, nbytes = getattr(video, "FRAMES", 0), getattr(video, "UPLOAD_BYTES", 0)
    return nbytes / frames / 1e6 if frames and nbytes else None
