"""UNet calls of the inpainting loop per frame through `warp_inpaint`, from
the program's counters (`diffusion/sd_pipeline.py`: `UNET_CALLS` over
`FRAMES`; the warm-up calls count in both). Reads nothing where the program
has no such counters."""
import sys


def read(ctx):
    sd = sys.modules.get("comfystereo_tpu_torch.diffusion.sd_pipeline")
    if sd is None or not hasattr(sd, "UNET_CALLS"):
        return None
    frames = getattr(sd, "FRAMES", 0)
    return sd.UNET_CALLS / frames if frames else None
