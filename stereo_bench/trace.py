"""Reduce a `torch.profiler` trace (Chrome trace format) to what the
per-layer metrics read.

The traced stretch is the span from the start of the first to the end of
the last of the harness's own call spans (`CALL_SPAN`, a
`record_function` around each call's submission, on the caller's thread).
The last span lasts until every traced call's output is on the host, so
the device's work for the stretch lies inside it. Device activity is every event of the categories `kernel`,
`gpu_memcpy` and `gpu_memset`; the device is busy where any of them runs.
Times are in seconds.

Apart from those, `program` holds the program's own spans (every
`user_annotation` but `CALL_SPAN`) with their host thread, and the
profiler's correlation ids tie each kernel to the host call that launched
it: `kernel_ids` gives each kernel's id (None where it has none), and
`launch_calls` the `cuda_runtime` or `cuda_driver` event of each id, the
outermost where a runtime call made a driver call of the same id.
"""
from __future__ import annotations

import bisect
import json
from typing import Dict, Iterable, List, Optional, Tuple

CALL_SPAN = "stereo_bench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10

Interval = Tuple[float, float]
# (name, start, end, (process, thread)) of a host event.
HostEvent = Tuple[str, float, float, Tuple]


def _union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Trace:
    """The device and host events of a traced stretch."""

    def __init__(self, events: List[Dict]):
        def of(cats):
            return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]

        def span(e):
            return e["name"], e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0.0)) * 1e-6

        def spans(cats):
            return [span(e) for e in of(cats)]

        def threaded(e) -> HostEvent:
            return span(e) + ((e.get("pid"), e.get("tid")),)

        def correlation(e) -> Optional[int]:
            return (e.get("args") or {}).get("correlation")

        self.calls = sorted((a, b) for n, a, b in spans(("user_annotation",)) if n == CALL_SPAN)
        self.device = spans(DEVICE_CATS)
        self.kernels = spans(("kernel",))
        self.copies = spans(("gpu_memcpy",))
        self.host = [s for s in spans(HOST_CATS) if s[0] != CALL_SPAN]
        self.program = [threaded(e) for e in of(("user_annotation",)) if e["name"] != CALL_SPAN]
        self.kernel_ids = [correlation(e) for e in of(("kernel",))]
        self.launch_calls: Dict[int, HostEvent] = {}
        for e in sorted(of(LAUNCH_CATS), key=lambda e: (e["ts"], -e.get("dur", 0.0))):
            if correlation(e) is not None:
                self.launch_calls.setdefault(correlation(e), threaded(e))
        if self.calls:
            self.start, self.end = self.calls[0][0], max(b for _, b in self.calls)
        else:
            self.start = self.end = 0.0

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def n_calls(self) -> int:
        return len(self.calls)

    def _clip(self, spans) -> List[Interval]:
        return [(max(a, self.start), min(b, self.end)) for _, a, b in spans
                if b > self.start and a < self.end]

    def busy_s(self, spans=None) -> float:
        """Seconds of the stretch in which any of `spans` (by default every
        device event) runs."""
        return sum(b - a for a, b in _union(self._clip(self.device if spans is None else spans)))

    def named(self, pattern) -> List[Tuple[str, float, float]]:
        """The kernels whose name matches the compiled regex `pattern`."""
        return [k for k in self.kernels if pattern.search(k[0])]

    def device_ops(self) -> List[List]:
        """The device operations that took the most time, summed by name."""
        tot: Dict[str, float] = {}
        for n, a, b in self.device:
            if b > self.start and a < self.end:
                tot[n[:160]] = tot.get(n[:160], 0.0) + (min(b, self.end) - max(a, self.start))
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[List]:
        """Idle time of the device, summed by what the host was doing: the
        innermost host event that covers the middle of each gap."""
        busy = _union(self._clip(self.device))
        gaps, t = [], self.start
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        host = sorted(self.host, key=lambda s: s[1])
        starts = [s[1] for s in host]
        tot: Dict[str, float] = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            label: Optional[Tuple[str, float, float]] = None
            # The latest-starting host event that still runs at `mid`.
            for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if host[k][2] >= mid:
                    label = host[k]
                    break
            name = label[0][:160] if label else "between calls"
            tot[name] = tot.get(name, 0.0) + (b - a)
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]
