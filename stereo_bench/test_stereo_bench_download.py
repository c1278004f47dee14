"""The readers of the chunk entry's download span and staging counter, on
the synthetic chunks of `test_stereo_bench_spans`: `download_ms.video`
reads the span's host time and leaves the kernels' attribution as it was,
`staged_share.video` reads the counters, and neither reads anything where
the program has no such span or counter."""
from __future__ import annotations

import sys

import pytest

from stereo_bench.test_stereo_bench_readers import ev
from stereo_bench.test_stereo_bench_spans import EXPECTED, KERNEL_READERS, chunk, read
from stereo_bench.trace import CALL_SPAN, Trace

# One chunk's download span, from its chunk's base, in us: after `video.to_u8`
# (410-450) and inside `video.device_chunk` (10-500).
DOWNLOAD = (455.0, 495.0)


def with_download(base):
    return chunk(base) + [ev("video.download", "user_annotation", base + DOWNLOAD[0],
                             DOWNLOAD[1] - DOWNLOAD[0])]


def test_reads_the_download_span():
    tr = Trace(with_download(0.0) + with_download(1100.0))
    assert read("download_ms.video", tr) == pytest.approx(0.04)


@pytest.mark.parametrize("name", KERNEL_READERS + ["upload_wait_ms.video", "submit_ms.video"])
def test_download_span_moves_no_other_reader(name):
    """The span holds no launch, so every kernel stays where it was."""
    tr = Trace(with_download(0.0) + with_download(1100.0))
    assert read(name, tr) == pytest.approx(EXPECTED[name])


def test_no_download_span():
    assert read("download_ms.video", None) is None
    assert read("download_ms.video", Trace(chunk(0.0) + chunk(1100.0))) is None  # the parent
    assert read("download_ms.video", Trace([ev(CALL_SPAN, "user_annotation", 0.0, 100.0)])) is None


MB = 1080 * 1920 * 3


@pytest.mark.parametrize("upload,download,staged,share", [
    (24 * 2 * MB, 24 * 2 * MB, 24 * 4 * MB, 100.0),  # host inputs: both ways staged
    (0, 24 * 2 * MB, 24 * 2 * MB, 100.0),  # inputs already on the card
    (24 * 2 * MB, 24 * 2 * MB, 24 * 2 * MB, 50.0),  # half of the bytes staged
    (24 * 2 * MB, 24 * 2 * MB, 0, 0.0),  # none staged
])
def test_staged_share(monkeypatch, upload, download, staged, share):
    from comfystereo_tpu_torch.utils import video
    assert "comfystereo_tpu_torch.utils.video" in sys.modules
    monkeypatch.setattr(video, "UPLOAD_BYTES", upload)
    monkeypatch.setattr(video, "DOWNLOAD_BYTES", download)
    monkeypatch.setattr(video, "STAGED_BYTES", staged)
    assert read("staged_share.video", None) == pytest.approx(share)


def test_staged_share_reads_nothing_without_counts(monkeypatch):
    from comfystereo_tpu_torch.utils import video
    for name in ("UPLOAD_BYTES", "DOWNLOAD_BYTES", "STAGED_BYTES"):
        monkeypatch.setattr(video, name, 0)  # the CPU: nothing moved
    assert read("staged_share.video", None) is None
    monkeypatch.setattr(video, "UPLOAD_BYTES", 2 * MB)
    monkeypatch.delattr(video, "STAGED_BYTES")  # the parent: no staging counter
    monkeypatch.delattr(video, "DOWNLOAD_BYTES")
    assert read("staged_share.video", None) is None
