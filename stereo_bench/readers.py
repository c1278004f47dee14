"""What the metric readers under `metrics/` share. A reader is
`read(ctx) -> float or None`; `ctx` is a `run.Context`. A reader that finds
nothing to read returns None, and the run leaves its metric out; a share of
a roofline or of a peak is never given as 0 in place of a missing one.
Shares are in percent."""
from __future__ import annotations

import re
from typing import Callable, Optional

from stereo_bench.counts import passes, peaks


def _traced(ctx) -> bool:
    return ctx.trace is not None and ctx.trace.n_calls > 0 and ctx.trace.window_s > 0


def copy_share(ctx) -> Optional[float]:
    """Share of the traced stretch in which a copy between host and device
    runs."""
    if not _traced(ctx) or not ctx.trace.copies:
        return None
    return 100.0 * ctx.trace.busy_s(ctx.trace.copies) / ctx.trace.window_s


def idle_share(ctx) -> Optional[float]:
    """Share of the traced stretch with no kernel, copy or memset on the
    device."""
    if not _traced(ctx) or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def launches(ctx, per_frame: bool) -> Optional[float]:
    """Kernels launched in the traced stretch, per call or per frame."""
    if not _traced(ctx) or not ctx.trace.kernels:
        return None
    n = sum(1 for _, a, _ in ctx.trace.kernels if ctx.trace.start <= a < ctx.trace.end)
    units = ctx.trace.n_calls * (ctx.traffic["frames_per_call"] if per_frame else 1)
    return n / units


def roofline(ctx, pattern: str, count: Callable, launches_per_call: int) -> Optional[float]:
    """A kernel's share of its roofline: the floor of its work in one call
    (`count(pixels)` bytes and operations per launch, `launches_per_call`
    launches of a chunk's frames), over the kernel time per call that the
    trace shows for kernels named by `pattern`."""
    if not _traced(ctx):
        return None
    found = ctx.trace.named(re.compile(pattern))
    if not found:
        return None
    t = ctx.trace
    busy = sum(min(b, t.end) - max(a, t.start) for _, a, b in found if b > t.start and a < t.end)
    if busy <= 0:
        return None
    px = ctx.traffic["frames_per_call"] * ctx.traffic["height"] * ctx.traffic["width"]
    nbytes, ops = count(px)
    floor = launches_per_call * peaks.floor_s(nbytes, ops)
    return 100.0 * floor / (busy / t.n_calls)


def pass_mfu(ctx) -> Optional[float]:
    """The whole call's floor (`counts.passes`) over the traced stretch's
    time per call."""
    if not _traced(ctx) or not ctx.trace.device:  # no device in the trace: no card
        return None
    tr = ctx.traffic
    fn = getattr(passes, tr["entry"])
    nbytes, ops = fn(tr["frames_per_call"], tr["height"], tr["width"], ctx.settings, ctx.fill)
    return 100.0 * peaks.floor_s(nbytes, ops) / (ctx.trace.window_s / ctx.trace.n_calls)
