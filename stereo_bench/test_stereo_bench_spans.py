"""The readers of the program's spans and counters on a synthetic trace:
each reads the right number, and none reads anything where the kernels
cannot be put to spans, where there is no trace, or where the counters
are 0."""
from __future__ import annotations

import json
import sys

import pytest

from stereo_bench.spans import SPANS, attributed, kernel_ms
from stereo_bench.spans import main as spans_main
from stereo_bench.test_stereo_bench_readers import VIDEO, ctx, ev, reader
from stereo_bench.trace import CALL_SPAN, Trace

KERNEL_READERS = ["entry_kernels_ms.video", "blur_kernels_ms.video", "box_sums_ms.video",
                  "pack_kernels_ms.video", "unreturned_kernels_ms.video"]
HOST_READERS = ["upload_wait_ms.video", "submit_ms.video"]


def chunk(base, distance_in="blur.edge_weights", runtime=True):
    """One chunk's events, from `base` us: the program's spans (start, end),
    in each leaf span one launch call at its middle, and the kernels on the
    device in the order of their launches, each with its duration (us) and
    the correlation id of its launch call (a runtime call and the driver
    call inside it share one)."""
    spans = {"video.device_chunk": (10, 500), "video.upload": (20, 120),
             "video.to_float": (130, 150), "pipeline.stereo_pipeline": (160, 400),
             "pipeline.depth255": (165, 168), "blur.directional": (170, 260),
             "blur.edge_weights": (175, 185), "blur.box_h": (190, 210),
             "blur.box_w": (215, 230), "blur.blend": (235, 245),
             "pipeline.eye_source": (262, 264), "pipeline.eye": (270, 300),
             "pipeline.pack": (310, 320), "pipeline.mask": (330, 340),
             "pipeline.depth_outputs": (350, 360), "video.to_u8": (410, 450)}
    kernels = [("video.to_float", "vectorized_elementwise_kernel", 5),
               ("pipeline.depth255", "reduce_kernel", 1),
               ("blur.edge_weights", "void edge_distances_kernel<1>(Args)", 10),
               ("blur.box_h", "elementwise_kernel", 20), ("blur.box_w", "elementwise_kernel", 8),
               ("blur.blend", "elementwise_kernel", 2),
               ("pipeline.eye", "void warp_rows_kernel<true>(Args)", 4),
               ("pipeline.pack", "cat_kernel", 3), ("pipeline.mask", "elementwise_kernel", 1),
               ("pipeline.depth_outputs", "elementwise_kernel", 2),
               ("video.to_u8", "elementwise_kernel", 6)]
    events = [ev(CALL_SPAN, "user_annotation", base, 1000.0)]
    events += [ev(n, "user_annotation", base + a, b - a) for n, (a, b) in spans.items()]
    t = base + 600.0
    for k, (where, name, dur) in enumerate(kernels):
        a, b = spans[distance_in if "edge_distances" in name else where]
        mid = base + (a + b) / 2
        corr = int(base) + k + 1
        if runtime:
            events.append(ev("cudaLaunchKernel", "cuda_runtime", mid - 0.5, 1.0, corr))
        # inside the runtime call, where there is one
        events.append(ev("cuLaunchKernel", "cuda_driver", mid - 0.25, 0.5, corr))
        events.append(ev(name, "kernel", t, dur, corr))
        t += dur + 1
    events.append(ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", t, 100.0))
    events.append(ev("cudaMemcpyAsync", "cuda_runtime", base + 600.0, 300.0))
    return events


def trace(**kw):
    return Trace(chunk(0.0, **kw) + chunk(1100.0, **kw))


def read(name, tr):
    return reader(name)(ctx(VIDEO, tr))


EXPECTED = {"upload_wait_ms.video": 0.1, "submit_ms.video": 0.39,
            "entry_kernels_ms.video": 0.011, "blur_kernels_ms.video": 0.040,
            "box_sums_ms.video": 0.028, "pack_kernels_ms.video": 0.003,
            "unreturned_kernels_ms.video": 0.003}


@pytest.mark.parametrize("runtime", [True, False], ids=["runtime", "driver"])
@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reads_the_spans(name, runtime):
    """Per chunk, in ms; a launch is a runtime call, or a driver call alone."""
    assert read(name, trace(runtime=runtime)) == pytest.approx(EXPECTED[name])


def test_launches_and_kernels_differ_in_count():
    events = chunk(0.0) + chunk(1100.0)
    events.remove(next(e for e in events if e["name"] == "cudaLaunchKernel"))
    events.remove(next(e for e in events if e["name"] == "cuLaunchKernel"))
    for name in KERNEL_READERS:
        assert read(name, Trace(events)) is None
    for name in HOST_READERS:
        assert read(name, Trace(events)) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("corr", [987654, None], ids=["unknown_id", "no_id"])
def test_kernel_without_its_launch_call(corr):
    """A kernel whose correlation id no launch call has, or that has no id:
    no kernel is put to a span."""
    events = chunk(0.0) + chunk(1100.0)
    kernel = next(e for e in events if e["cat"] == "kernel")
    if corr is None:
        del kernel["args"]
    else:
        kernel["args"] = {"correlation": corr}
    for name in KERNEL_READERS:
        assert read(name, Trace(events)) is None


def with_block():
    """Two chunks and, after each chunk's spans, a span that `SPANS` does
    not list, with one kernel launched in it."""
    events = chunk(0.0) + chunk(1100.0)
    for base in (0.0, 1100.0):
        corr = 5000 + int(base)
        events += [ev("throwaway.block", "user_annotation", base + 520, 60.0),
                   ev("cudaLaunchKernel", "cuda_runtime", base + 550, 1.0, corr),
                   ev("ampere_sgemm_128x64_tn", "kernel", base + 950, 30.0, corr)]
    return events


def test_kernel_under_a_span_not_in_spans():
    """A program span that `SPANS` does not list holds its kernels; the
    chunk's spans read as before."""
    tr = Trace(with_block())
    assert "throwaway.block" not in SPANS
    assert kernel_ms(tr, ["throwaway.block"]) == pytest.approx(0.030)
    found = [f for f in attributed(tr) if f[0] == "ampere_sgemm_128x64_tn"]
    assert [(u, i) for _, _, u, i in found] == [(frozenset({"throwaway.block"}),
                                                 "throwaway.block")] * 2
    for name in KERNEL_READERS:
        assert read(name, tr) == pytest.approx(EXPECTED[name])


def test_table_lists_every_program_span(tmp_path, capsys):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": with_block()}))
    spans_main([str(path)])
    out = capsys.readouterr().out
    assert "launch calls {'cudaLaunchKernel': 24}" in out
    rows = [line.split() for line in out.splitlines()[2:-1]]
    assert [r[0] for r in rows] == list(SPANS) + ["throwaway.block"]
    assert rows[-1][1:] == ["1.000", "0.060", "0.030", "0.030", "1.000"]


def test_two_threads_and_two_streams():
    """Launch calls of two threads interleaved in time, inside spans that
    overlap in time, and their kernels on two streams in another order than
    their launches: each kernel goes to its own launch call and to the
    spans of that call's thread."""
    events = [ev(CALL_SPAN, "user_annotation", 0.0, 1000.0, tid=1),
              ev("a.block", "user_annotation", 10.0, 400.0, tid=1),
              ev("a.inner", "user_annotation", 60.0, 20.0, tid=1),
              ev("b.block", "user_annotation", 20.0, 400.0, tid=2)]
    launches = [(1, 1, 50.0), (2, 2, 60.0), (1, 3, 70.0), (2, 4, 80.0)]  # thread, id, us
    for thread, corr, t in launches:
        events.append(ev("cudaLaunchKernel", "cuda_runtime", t, 1.0, corr, tid=thread))
    device = [(4, 500.0, 80.0, 9), (2, 520.0, 20.0, 8), (3, 560.0, 40.0, 9), (1, 600.0, 10.0, 8)]
    for corr, t, dur, stream in device:
        events.append(dict(ev(f"k{corr}", "kernel", t, dur, corr), pid=0, tid=stream))
    tr = Trace(events)
    got = {name: (under, inner) for name, _, under, inner in attributed(tr)}
    assert got == {"k1": (frozenset({"a.block"}), "a.block"),
                   "k2": (frozenset({"b.block"}), "b.block"),
                   "k3": (frozenset({"a.block", "a.inner"}), "a.inner"),
                   "k4": (frozenset({"b.block"}), "b.block")}
    assert kernel_ms(tr, ["a.block"]) == pytest.approx(0.050)
    assert kernel_ms(tr, ["b.block"]) == pytest.approx(0.100)
    assert kernel_ms(tr, ["a.inner"]) == pytest.approx(0.040)


def test_named_kernel_outside_its_span():
    tr = trace(distance_in="blur.box_h")
    for name in KERNEL_READERS:
        assert read(name, tr) is None


def test_no_trace():
    for name in KERNEL_READERS + HOST_READERS:
        assert read(name, None) is None
    empty = Trace([ev(CALL_SPAN, "user_annotation", 0.0, 100.0)])  # the parent: no spans
    for name in KERNEL_READERS + HOST_READERS:
        assert read(name, empty) is None


def test_upload_counter(monkeypatch):
    from comfystereo_tpu_torch.utils import video
    assert "comfystereo_tpu_torch.utils.video" in sys.modules
    monkeypatch.setattr(video, "FRAMES", 24)
    monkeypatch.setattr(video, "UPLOAD_BYTES", 24 * 2 * 1080 * 1920 * 3)
    assert read("upload_mb_per_frame.video", None) == pytest.approx(12.4416)
    monkeypatch.setattr(video, "UPLOAD_BYTES", 0)  # the CPU: nothing uploaded
    assert read("upload_mb_per_frame.video", None) is None
    monkeypatch.setattr(video, "FRAMES", 0)
    assert read("upload_mb_per_frame.video", None) is None
    monkeypatch.delattr(video, "UPLOAD_BYTES")  # the parent: no counter
    assert read("upload_mb_per_frame.video", None) is None
