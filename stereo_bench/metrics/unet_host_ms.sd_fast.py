"""Host time per frame that the calling thread spends in the UNet calls
(`diffusion.unet`, summed): their launches, which the card's work hides
only where they outrun it. Reads nothing where the program has no such
span."""
from stereo_bench.spans import spans


def read(ctx):
    t = ctx.trace
    found = spans(t, "diffusion.unet") if t is not None and t.n_calls else []
    if not found:
        return None
    return 1e3 * sum(b - a for _, a, b in found) / t.n_calls / ctx.traffic["frames_per_call"]
