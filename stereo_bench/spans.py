"""What the program's own spans say about the traced stretch.

The port marks its stages with `utils.profiling.span`: `user_annotation`
events in the trace, on the caller's thread and on the clock of the
device's events. `Trace.host` keeps them beside the launch calls
(`cuda_runtime` and `cuda_driver` events), and `Trace.kernels` keeps the
kernels. Every kernel of a chunk runs on the one default stream, and only
the caller's thread launches kernels (the download on the second thread is
a copy and launches none), so the k-th launch call of the stretch launched
its k-th kernel. A kernel is put under every program span that holds its
launch call; the innermost of them launched it.

`kernel_ms` returns None, and so leaves its metric out of the run, unless
the stretch has as many launch calls as kernels and every kernel named in
`HOME` falls under its span: anything else means the order cannot be
trusted. Times are in milliseconds per traced chunk.

    python3 -m stereo_bench.spans build/stereo_bench/<cell>.trace.json

prints, for a trace a `--trace 1` run wrote, each span's host time and the
kernel time launched under it and in it alone, per chunk.
"""
from __future__ import annotations

import re
import sys
from typing import Iterable, List, Optional, Tuple

SPANS = ("video.device_chunk", "video.upload", "video.to_float", "video.to_u8",
         "pipeline.stereo_pipeline", "pipeline.depth255", "pipeline.eye_source",
         "pipeline.eye", "pipeline.pack", "pipeline.mask", "pipeline.depth_outputs",
         "blur.directional", "blur.edge_weights", "blur.box_h", "blur.box_w", "blur.blend")
# Host calls that launch one kernel each; a driver call made inside a
# runtime call is the same launch.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
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


def _launches(trace) -> List[Span]:
    out: List[Span] = []
    for call in _in_stretch(trace, (s for s in trace.host if s[0] in LAUNCH_CALLS)):
        if not (out and out[-1][1] <= call[1] and call[2] <= out[-1][2]):
            out.append(call)
    return out


def attributed(trace) -> Optional[List[Tuple[str, float, frozenset, Optional[str]]]]:
    """Each kernel of the stretch as (name, seconds, names of the program
    spans that hold its launch call, the innermost of them), or None where
    the launches and the kernels cannot be paired."""
    if trace is None or trace.n_calls == 0:
        return None
    kernels = _in_stretch(trace, trace.kernels)
    launches = _launches(trace)
    if not kernels or len(kernels) != len(launches):
        return None
    program = _in_stretch(trace, (s for s in trace.host if s[0] in SPANS))
    out = []
    for (name, a, b), (_, t, _) in zip(kernels, launches):
        holders = [s for s in program if s[1] <= t <= s[2]]
        under = frozenset(s[0] for s in holders)
        for pattern, home in HOME:
            if home not in under and pattern.search(name):
                return None
        innermost = max(holders, key=lambda s: s[1])[0] if holders else None
        out.append((name, b - a, under, innermost))
    return out


def kernel_ms(trace, names: Iterable[str]) -> Optional[float]:
    """Kernel time per traced chunk, in ms, of the kernels launched under
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
        calls = {}
        for name, _, _ in _in_stretch(trace, trace.host):
            if "Launch" in name:
                calls[name] = calls.get(name, 0) + 1
        kernels = _in_stretch(trace, trace.kernels)
        print(f"{path}: {n} chunks, {len(kernels)} kernels, launch calls {calls}")
        found = attributed(trace)
        if found is None:
            print("  kernels and launch calls not paired: no attribution")
        print(f"  {'span':26} {'n/chunk':>7} {'host ms':>9} {'kernel ms':>9} {'in it ms':>9} "
              f"{'in it n':>7}")
        for name in SPANS:
            got = spans(trace, name)
            row = [len(got) / n, host_ms(trace, name) or 0.0]
            if found is not None:
                row += [1e3 * sum(dt for _, dt, u, _ in found if name in u) / n,
                        1e3 * sum(dt for _, dt, _, i in found if i == name) / n,
                        sum(1 for *_, i in found if i == name) / n]
            print(f"  {name:26} " + " ".join(f"{v:9.3f}" for v in row))
        total = 1e3 * sum(b - a for _, a, b in kernels) / n
        if found is not None:
            outside = 1e3 * sum(dt for _, dt, _, i in found if i is None) / n
            print(f"  kernels of the stretch {total:.3f} ms/chunk, under no span {outside:.3f}")


if __name__ == "__main__":
    main(sys.argv[1:])
