"""The SDXL UNet's and the VAE's tensor operations of a call
(`counts/sdxl.py`) at the card's bf16 tensor-core peak, over the traced
stretch's time a call, in percent. Reads nothing without device events."""
from stereo_bench.counts import peaks, sdxl


def read(ctx):
    t = ctx.trace
    if t is None or t.n_calls == 0 or t.window_s <= 0 or not t.device:
        return None
    ops = sdxl.fast_frame(ctx.settings, ctx.traffic["size"]) * ctx.traffic["frames_per_call"]
    return 100.0 * ops / peaks.TENSOR_FLOP_PER_S / (t.window_s / t.n_calls)
