"""Frames completed in the window over the window's seconds."""


def read(ctx):
    w = ctx.window
    return w.calls * ctx.traffic["frames_per_call"] / w.elapsed_s if w.calls else None
