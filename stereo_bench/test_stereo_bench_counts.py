"""The copied bound arithmetic gives the numbers PERF.md prints for the
kernels at [12960, 1920] rows (12 frames of 1080p): 722 MB for the warp,
299 MB for the distance kernel, 697 MB for the exact polylines; the peaks
are `chip_smoke.py`'s, and the tensor-core floor takes the largest of its
three bounds."""
from __future__ import annotations

import ast
from pathlib import Path

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


def _chip_smoke_peaks():
    """`chip_smoke.py`'s `_PEAKS`, read from its source, or None once that
    copy is gone."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    if not path.is_file():
        return None
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_PEAKS" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


def test_peaks_are_chip_smokes():
    """The four H100 peaks equal `chip_smoke.py`'s, while it keeps a copy."""
    found = _chip_smoke_peaks()
    if found is None:
        pytest.skip("chip_smoke.py holds no _PEAKS: counts/peaks.py is the only copy")
    assert (peaks.BYTES_PER_S, peaks.FLOP_PER_S, peaks.TENSOR_FLOP_PER_S,
            peaks.EXP_PER_S) == found["H100"]
    assert (peaks.TENSOR_FLOP_PER_S, peaks.EXP_PER_S) == (989e12, 3.9e12)


@pytest.mark.parametrize("nbytes, tensor_ops, exps, floor", [
    (2 * 3.35e12, 989e12, 3.9e12, 2.0),  # the bytes bound it
    (3.35e12, 3 * 989e12, 3.9e12, 3.0),  # the tensor-core operations
    (3.35e12, 989e12, 4 * 3.9e12, 4.0),  # the exponentials
    (3.35e12, 989e12, None, 1.0),  # no exponentials given
])
def test_tensor_floor_takes_the_largest_bound(nbytes, tensor_ops, exps, floor):
    args = (nbytes, tensor_ops) + (() if exps is None else (exps,))
    assert peaks.tensor_floor_s(*args) == pytest.approx(floor, rel=1e-12)


def test_pass_bytes():
    s = dict(depth_blur_vert_smooth=6, depth_blur_strength=20.0)
    nbytes, ops = passes.video_chunk(12, 1080, 1920, s, "gpu_warp")
    assert nbytes == 12 * 1080 * 1920 * 12  # 3 + 3 bytes in, 6 out per pixel
    assert ops > 0
