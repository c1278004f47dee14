"""Set-up: from process start to the first timed call (CUDA init, kernel
libraries loaded or built, scene generation, warm-up of the cell's shapes)."""


def read(ctx):
    return ctx.setup_s
