"""The copied bound arithmetic gives the numbers PERF.md prints for the
kernels at [12960, 1920] rows (12 frames of 1080p): 722 MB for the warp,
299 MB for the distance kernel, 697 MB for the exact polylines."""
from __future__ import annotations

import pytest

from stereo_bench.counts import kernels, passes, peaks

PX = 12960 * 1920


@pytest.mark.parametrize("fn, mb", [(kernels.warp, 722), (kernels.distance, 299),
                                    (kernels.polylines_exact, 697)])
def test_kernel_bytes(fn, mb):
    assert round(fn(PX)[0] / 1e6) == mb


def test_floor_takes_the_larger_bound():
    assert (peaks.BYTES_PER_S, peaks.FLOP_PER_S) == (3.35e12, 67e12)
    assert peaks.floor_s(3.35e12, 0.0) == 1.0
    assert peaks.floor_s(0.0, 2 * 67e12) == 2.0


def test_pass_bytes():
    s = dict(depth_blur_vert_smooth=6, depth_blur_strength=20.0)
    nbytes, ops = passes.video_chunk(12, 1080, 1920, s, "gpu_warp")
    assert nbytes == 12 * 1080 * 1920 * 12  # 3 + 3 bytes in, 6 out per pixel
    assert ops > 0
