"""Share of the bytes that `device_chunk` moved between host and card, both
ways, that went through page-locked staging, from the program's counters
(`utils/video.py`: `STAGED_BYTES` over `UPLOAD_BYTES` plus
`DOWNLOAD_BYTES`; the warm-up calls count in all three), in percent."""
import sys


def read(ctx):
    video = sys.modules.get("comfystereo_tpu_torch.utils.video")
    if video is None or not hasattr(video, "STAGED_BYTES"):
        return None
    moved = getattr(video, "UPLOAD_BYTES", 0) + getattr(video, "DOWNLOAD_BYTES", 0)
    return 100.0 * video.STAGED_BYTES / moved if moved else None
