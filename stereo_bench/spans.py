"""What the program's own spans say about the traced stretch.

The port marks its stages with `utils.profiling.span`: `user_annotation`
events in the trace, on the caller's thread and on the clock of the
device's events. `Trace.program` keeps them with their thread. The
profiler gives each kernel the correlation id of the host call that
launched it (a `cuda_runtime` or `cuda_driver` event, `Trace.launch_calls`),
so a kernel is paired with its launch call whatever stream it ran on and
whichever thread launched it, and is put under every program span of that
thread that holds the call; the innermost of them launched it.

`kernel_ms` returns None, and so leaves its metric out of the run, unless
every kernel of the stretch has a launch call with its correlation id and
every kernel named in `HOME` falls under its span: anything else means the
kernels cannot be put to spans. Times are in milliseconds per traced call.

    python3 -m stereo_bench.spans build/stereo_bench/<cell>.trace.json

prints, for a trace a `--trace 1` run wrote, the launch calls' kinds and
each program span's host time and the kernel time launched under it and in
it alone, per call, for every program span of the stretch: those of
`SPANS` first, in its order.
"""
from __future__ import annotations

import re
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from stereo_bench.trace import HostEvent

# The chunk path's spans, in the order the table prints them.
SPANS = ("video.device_chunk", "video.upload", "video.to_float", "video.to_u8",
         "pipeline.stereo_pipeline", "pipeline.depth255", "pipeline.eye_source",
         "pipeline.eye", "pipeline.pack", "pipeline.mask", "pipeline.depth_outputs",
         "blur.directional", "blur.edge_weights", "blur.box_h", "blur.box_w", "blur.blend")
# The program's named kernels and the span each is launched in.
HOME = ((re.compile(r"\bedge_distances_kernel\b"), "blur.edge_weights"),
        (re.compile(r"\bwarp_rows_kernel\b"), "pipeline.eye"),
        (re.compile(r"\bpolylines_exact_kernel\b"), "pipeline.eye"))

Span = Tuple[str, float, float]


def _in_stretch(trace, events) -> List[Span]:
    return sorted((e for e in events if trace.start <= e[1] <= trace.end), key=lambda e: e[1])


def spans(trace, name: str) -> List[Span]:
    """The program's spans called `name` that start in the stretch."""
    return _in_stretch(trace, (s for s in trace.host if s[0] == name))


def host_ms(trace, name: str) -> Optional[float]:
    """Mean host duration of the spans called `name`, in ms."""
    found = spans(trace, name) if trace is not None else []
    return 1e3 * sum(b - a for _, a, b in found) / len(found) if found else None


def _stretch_kernels(trace) -> List[Tuple[Span, Optional[int]]]:
    """The kernels that start in the stretch, each with its correlation id,
    in the order they start."""
    return sorted(((k, c) for k, c in zip(trace.kernels, trace.kernel_ids)
                   if trace.start <= k[1] <= trace.end), key=lambda kc: kc[0][1])


def _holders(trace, calls: List[HostEvent]) -> List[List[HostEvent]]:
    """For each launch call, the program spans of its thread that hold it:
    one sweep over time, thread by thread."""
    todo: Dict[Tuple, List[HostEvent]] = {}  # by thread, latest start first
    for s in sorted(trace.program, key=lambda s: -s[1]):
        todo.setdefault(s[3], []).append(s)
    open_: Dict[Tuple, List[HostEvent]] = {}
    out: List[List[HostEvent]] = [[] for _ in calls]
    for k in sorted(range(len(calls)), key=lambda k: calls[k][1]):
        _, t, _, thread = calls[k]
        pending, held = todo.get(thread, []), open_.setdefault(thread, [])
        while pending and pending[-1][1] <= t:
            held.append(pending.pop())
        held[:] = [s for s in held if s[2] >= t]
        out[k] = list(held)
    return out


def attributed(trace) -> Optional[List[Tuple[str, float, frozenset, Optional[str]]]]:
    """Each kernel of the stretch as (name, seconds, names of the program
    spans that hold its launch call, the innermost of them), or None where
    a kernel has no launch call with its correlation id or a named kernel
    falls outside its span."""
    if trace is None or trace.n_calls == 0:
        return None
    kernels = _stretch_kernels(trace)
    if not kernels:
        return None
    calls = [trace.launch_calls.get(c) if c is not None else None for _, c in kernels]
    if any(c is None for c in calls):
        return None
    out = []
    for ((name, a, b), _), holders in zip(kernels, _holders(trace, calls)):
        under = frozenset(s[0] for s in holders)
        for pattern, home in HOME:
            if home not in under and pattern.search(name):
                return None
        innermost = max(holders, key=lambda s: s[1])[0] if holders else None
        out.append((name, b - a, under, innermost))
    return out


def kernel_ms(trace, names: Iterable[str]) -> Optional[float]:
    """Kernel time per traced call, in ms, of the kernels launched under
    any of the spans `names`."""
    found = attributed(trace)
    if found is None:
        return None
    names = set(names)
    return 1e3 * sum(dt for _, dt, under, _ in found if under & names) / trace.n_calls


def main(paths: List[str]) -> None:
    from stereo_bench.trace import Trace
    for path in paths:
        trace = Trace.load(path)
        n = trace.n_calls
        kernels = _stretch_kernels(trace)
        kinds: Dict[str, int] = {}
        for _, c in kernels:
            call = trace.launch_calls.get(c) if c is not None else None
            kind = call[0] if call else "(none)"
            kinds[kind] = kinds.get(kind, 0) + 1
        print(f"{path}: {n} calls, {len(kernels)} kernels, their launch calls {kinds}")
        found = attributed(trace)
        if found is None:
            print("  kernels and launch calls not paired: no attribution")
        seen = list(dict.fromkeys(s[0] for s in _in_stretch(trace, trace.program)))
        names = [s for s in SPANS if s in seen] + [s for s in seen if s not in SPANS]
        width = max(26, *(len(s) for s in names))
        print(f"  {'span':{width}} {'n/call':>7} {'host ms':>9} {'kernel ms':>9} {'in it ms':>9} "
              f"{'in it n':>7}")
        for name in names:
            got = spans(trace, name)
            row = [len(got) / n, host_ms(trace, name) or 0.0]
            if found is not None:
                row += [1e3 * sum(dt for _, dt, u, _ in found if name in u) / n,
                        1e3 * sum(dt for _, dt, _, i in found if i == name) / n,
                        sum(1 for *_, i in found if i == name) / n]
            print(f"  {name:{width}} " + " ".join(f"{v:9.3f}" for v in row))
        total = 1e3 * sum(b - a for (_, a, b), _ in kernels) / n
        if found is not None:
            outside = 1e3 * sum(dt for _, dt, _, i in found if i is None) / n
            print(f"  kernels of the stretch {total:.3f} ms/call, under no span {outside:.3f}")


if __name__ == "__main__":
    main(sys.argv[1:])
