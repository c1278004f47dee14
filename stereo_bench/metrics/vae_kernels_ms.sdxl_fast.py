"""Kernel time per frame launched under the VAE's encodes and decode
(`diffusion.vae_encode`, `diffusion.vae_decode`). Reads nothing where the
program has no such span."""
from stereo_bench.spans import kernel_ms, spans

SPANS = ("diffusion.vae_encode", "diffusion.vae_decode")


def read(ctx):
    if ctx.trace is None or not any(spans(ctx.trace, s) for s in SPANS):
        return None
    ms = kernel_ms(ctx.trace, SPANS)
    return None if ms is None else ms / ctx.traffic["frames_per_call"]
