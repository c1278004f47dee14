"""The reader of the chunk entry's overlap counter: `overlapped_share.video`
reads `OVERLAPPED_FRAMES` over `FRAMES` from the program's counters, and
reads nothing where the program has no such counter or ran no frame."""
from __future__ import annotations

import sys

import pytest

from stereo_bench.test_stereo_bench_spans import read


@pytest.mark.parametrize("frames,overlapped,share", [
    (48, 48, 100.0),  # every chunk in groups on the card
    (48, 12, 25.0),  # one chunk of four
    (48, 0, 0.0),  # chunks of one group, or the CPU
])
def test_overlapped_share(monkeypatch, frames, overlapped, share):
    from comfystereo_tpu_torch.utils import video
    monkeypatch.setattr(video, "FRAMES", frames)
    monkeypatch.setattr(video, "OVERLAPPED_FRAMES", overlapped)
    assert read("overlapped_share.video", None) == pytest.approx(share)


def test_overlapped_share_reads_nothing_without_counts(monkeypatch):
    from comfystereo_tpu_torch.utils import video
    monkeypatch.setattr(video, "FRAMES", 0)  # no chunk yet
    assert read("overlapped_share.video", None) is None
    monkeypatch.setattr(video, "FRAMES", 48)
    monkeypatch.delattr(video, "OVERLAPPED_FRAMES")  # the parent: no overlap counter
    assert read("overlapped_share.video", None) is None
    monkeypatch.delitem(sys.modules, "comfystereo_tpu_torch.utils.video")
    assert read("overlapped_share.video", None) is None
