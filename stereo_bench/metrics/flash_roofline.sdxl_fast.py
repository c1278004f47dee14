"""The flash attention kernel against its floor in the SDXL cell: the
launches of a call (`counts/sdxl.py`: each UNet call's 70 self-attentions,
10 at 4,096 tokens and 60 at 1,024, 13 calls a frame at the node's
defaults), each at the largest of its bytes, tensor-core operations and
exponentials over their peaks, over the traced kernels' time a call, in
percent. Reads nothing where no such kernel ran."""
import re

from stereo_bench.counts import peaks, sd, sdxl

KERNEL = re.compile(r"\bflash_fwd_kernel\b")


def read(ctx):
    t = ctx.trace
    if t is None or t.n_calls == 0:
        return None
    busy = sum(min(b, t.end) - max(a, t.start) for _, a, b in t.named(KERNEL)
               if b > t.start and a < t.end)
    if busy <= 0:
        return None
    per_unet = sum(peaks.tensor_floor_s(*sd.flash(*shape))
                   for shape in sdxl.flash_shapes(ctx.settings, ctx.traffic["size"]))
    floor = per_unet * sd.unet_calls(ctx.settings) * ctx.traffic["frames_per_call"]
    return 100.0 * floor / (busy / t.n_calls)
