"""Share of the inpainting loop's UNet calls that a CUDA graph's replay
served, from the program's counters (`diffusion/sd_unet.py`:
`UNET_GRAPH_CALLS` over `diffusion/sd_pipeline.py`: `UNET_CALLS`; the
warm-up calls count in both), in percent. Reads nothing where the program
has no such counter or made no UNet call."""
import sys


def read(ctx):
    unet = sys.modules.get("comfystereo_tpu_torch.diffusion.sd_unet")
    sd = sys.modules.get("comfystereo_tpu_torch.diffusion.sd_pipeline")
    if unet is None or sd is None or not hasattr(unet, "UNET_GRAPH_CALLS"):
        return None
    calls = getattr(sd, "UNET_CALLS", 0)
    return 100.0 * unet.UNET_GRAPH_CALLS / calls if calls else None
