"""The readers of the program's spans and counters on a synthetic trace:
each reads the right number, and none reads anything where the kernels
cannot be put to spans, where there is no trace, or where the counters
are 0."""
from __future__ import annotations

import sys

import pytest

from stereo_bench.test_stereo_bench_readers import VIDEO, ctx, ev, reader
from stereo_bench.trace import CALL_SPAN, Trace

KERNEL_READERS = ["entry_kernels_ms.video", "blur_kernels_ms.video", "box_sums_ms.video",
                  "pack_kernels_ms.video", "unreturned_kernels_ms.video"]
HOST_READERS = ["upload_wait_ms.video", "submit_ms.video"]


def chunk(base, distance_in="blur.edge_weights", runtime=True):
    """One chunk's events, from `base` us: the program's spans (start, end),
    in each leaf span one launch call at its middle, and the kernels on the
    device in the order of their launches, each with its duration (us)."""
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
    for where, name, dur in kernels:
        a, b = spans[distance_in if "edge_distances" in name else where]
        mid = base + (a + b) / 2
        if runtime:
            events.append(ev("cudaLaunchKernel", "cuda_runtime", mid - 0.5, 1.0))
        events.append(ev("cuLaunchKernel", "cuda_driver", mid - 0.25, 0.5))  # in the runtime's
        events.append(ev(name, "kernel", t, dur))
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
