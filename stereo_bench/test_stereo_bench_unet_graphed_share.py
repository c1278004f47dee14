"""The reader of the UNet's graph counter: `unet_graphed_share.sd_fast`
reads `UNET_GRAPH_CALLS` over the inpainting loop's `UNET_CALLS` from the
program's counters, and reads nothing where the program has no such
counter or made no UNet call."""
from __future__ import annotations

import sys

import pytest

from stereo_bench.test_stereo_bench_spans import read


@pytest.mark.parametrize("calls,graphed,share", [
    (65, 65, 100.0),  # every call a replay, on the card
    (65, 13, 20.0),  # one frame of five
    (65, 0, 0.0),  # the CPU
])
def test_unet_graphed_share(monkeypatch, calls, graphed, share):
    from comfystereo_tpu_torch.diffusion import sd_pipeline, sd_unet
    monkeypatch.setattr(sd_pipeline, "UNET_CALLS", calls)
    monkeypatch.setattr(sd_unet, "UNET_GRAPH_CALLS", graphed)
    assert read("unet_graphed_share.sd_fast", None) == pytest.approx(share)


def test_unet_graphed_share_reads_nothing_without_counts(monkeypatch):
    from comfystereo_tpu_torch.diffusion import sd_pipeline, sd_unet
    monkeypatch.setattr(sd_pipeline, "UNET_CALLS", 0)  # no UNet call yet
    assert read("unet_graphed_share.sd_fast", None) is None
    monkeypatch.setattr(sd_pipeline, "UNET_CALLS", 65)
    monkeypatch.delattr(sd_unet, "UNET_GRAPH_CALLS")  # the parent: no graph counter
    assert read("unet_graphed_share.sd_fast", None) is None
    monkeypatch.delitem(sys.modules, "comfystereo_tpu_torch.diffusion.sd_unet")
    assert read("unet_graphed_share.sd_fast", None) is None
