"""Each metric reader gives the right number on a small synthetic profiler
trace, and reads nothing where the trace has nothing for it."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest

from stereo_bench import run
from stereo_bench.counts import kernels, passes, peaks
from stereo_bench.trace import CALL_SPAN, Trace

HERE = Path(__file__).resolve().parent
SETTINGS = json.loads((HERE / "configs" / "gpu_warp_default.json").read_text())["settings"]
VIDEO = dict(entry="video_chunk", height=10, width=20, frames_per_call=2)


def ev(name, cat, ts, dur, corr=None, tid=None):
    """A complete event; a kernel or a launch call takes the correlation id
    `corr`, a host event the thread `tid`."""
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    if tid is not None:
        e.update(pid=1, tid=tid)
    return e


def synthetic():
    """Two calls of 1000 us each (0-1000 and 1100-2100 us). Device: in
    each call a 100 us copy in, a warp kernel of 200 us, a distance kernel
    of 50 us and a 100 us copy out; one memset of 10 us; an elementwise
    kernel of 40 us that overlaps the warp by 20 us. Host: a cpu_op over
    the idle part of each call, and each kernel's launch call, outside
    the middles of the device's idle gaps."""
    events = []
    for k, base in enumerate((0.0, 1100.0)):
        c = 10 * k
        events += [ev(CALL_SPAN, "user_annotation", base, 1000.0),
                   ev("aten::copy_", "cpu_op", base, 900.0),
                   ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", base + 10, 100.0),
                   ev("cudaLaunchKernel", "cuda_runtime", base + 190, 1.0, c + 1),
                   ev("void warp_rows_kernel<true>(Args)", "kernel", base + 200, 200.0, c + 1),
                   ev("cudaLaunchKernel", "cuda_runtime", base + 370, 1.0, c + 2),
                   ev("void elementwise_kernel<128>", "kernel", base + 380, 40.0, c + 2),
                   ev("cudaLaunchKernel", "cuda_runtime", base + 490, 1.0, c + 3),
                   ev("edge_distances_kernel(Args)", "kernel", base + 500, 50.0, c + 3),
                   ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", base + 700, 100.0)]
    events.append(ev("Memset (Device)", "gpu_memset", 1050.0, 10.0))
    events.append(ev("cudaLaunchKernel", "cuda_runtime", 4990.0, 1.0, 99))
    events.append(ev("late kernel", "kernel", 5000.0, 100.0, 99))  # outside the stretch
    return Trace(events)


def reader(name):
    spec = importlib.util.spec_from_file_location(name, HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def ctx(traffic, trace=None, fill="gpu_warp", window=None):
    return run.Context(traffic=traffic, settings=SETTINGS, fill=fill, setup_s=12.5,
                       window=window or run.Window(), trace=trace)


def test_trace_reduction():
    t = synthetic()
    assert t.n_calls == 2 and t.window_s == pytest.approx(2100e-6)
    # per call: copies 200, kernels 200 + 40 - 20 overlap + 50 = 270; memset 10 once
    assert t.busy_s() == pytest.approx((2 * 470 + 10) * 1e-6)
    ops = dict(t.device_ops())
    assert ops["void warp_rows_kernel<true>(Args)"] == pytest.approx(400e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["aten::copy_"] + gaps["between calls"] == pytest.approx(2100e-6 - t.busy_s())


def test_copy_idle_and_launches():
    t = synthetic()
    c = ctx(VIDEO, t)
    assert reader("copy_share.video")(c) == pytest.approx(100 * 400 / 2100)
    assert reader("idle_share.video")(c) == pytest.approx(100 * (1 - 950 / 2100))
    assert reader("launches_per_frame.video")(c) == pytest.approx(6 / 4)


def test_rooflines():
    t = synthetic()
    c = ctx(VIDEO, t)
    px = 2 * 10 * 20
    warp = 2 * peaks.floor_s(*kernels.warp(px)) / 200e-6
    dist = peaks.floor_s(*kernels.distance(px)) / 50e-6
    assert reader("warp_roofline.video")(c) == pytest.approx(100 * warp)
    assert reader("distance_roofline.video")(c) == pytest.approx(100 * dist)
    assert reader("polylines_exact_roofline.video")(c) is None  # no such kernel traced


def test_pass_mfu():
    t = synthetic()
    floor = peaks.floor_s(*passes.video_chunk(2, 10, 20, SETTINGS, "gpu_warp"))
    # the stretch's 2100 us over its two calls
    assert reader("pass_mfu.video")(ctx(VIDEO, t)) == pytest.approx(100 * floor / 1050e-6)


def test_nothing_to_read():
    empty = Trace([])
    for name in ("copy_share.video", "idle_share.video", "launches_per_frame.video",
                 "warp_roofline.video", "distance_roofline.video",
                 "polylines_exact_roofline.video", "pass_mfu.video"):
        assert reader(name)(ctx(VIDEO, empty)) is None
        assert reader(name)(ctx(VIDEO, None)) is None


def test_end_to_end_readers():
    win = run.Window(calls=4, elapsed_s=2.0, latencies_s=[0.1, 0.2, 0.3, 0.4] * 5)
    assert reader("frames_per_s")(ctx(VIDEO, window=win)) == pytest.approx(4.0)
    assert reader("setup_s")(ctx(VIDEO)) == 12.5
