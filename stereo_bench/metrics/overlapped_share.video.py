"""Share of the frames through `device_chunk` that ran on a CUDA device in a
chunk of two or more groups of frames, whose host staging overlapped the
card's work on the group before, from the program's counters
(`utils/video.py`: `OVERLAPPED_FRAMES` over `FRAMES`; the warm-up calls
count in both), in percent."""
import sys


def read(ctx):
    video = sys.modules.get("comfystereo_tpu_torch.utils.video")
    if video is None or not hasattr(video, "OVERLAPPED_FRAMES"):
        return None
    frames = getattr(video, "FRAMES", 0)
    return 100.0 * video.OVERLAPPED_FRAMES / frames if frames else None
