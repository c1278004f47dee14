"""The kernel wrappers' input contracts, on the CPU.

Each wrapper runs its plain version for CPU tensors and its CUDA kernel for
CUDA tensors, whatever the shapes: the kernels take any C and rows up to
each kernel's MAX_WIDTH (a row whose planes do not fit in one CTA's shared
memory goes to the kernel's workspace or direct instance), the exact
polylines kernel max_pieces 1 to 16 and the supersampled one k_candidates
1 to 8. Past those a wrapper raises on the card before any launch. Meta
tensors stand for the card's: a wrapper that accepts their shapes gets as
far as its device check ("unsupported device meta"), and one that does not
raises naming the limit, in either case before any launch.
"""
import pytest
import torch

from comfystereo_tpu_torch.kernels import _common
from comfystereo_tpu_torch.kernels import distance, gather, polylines, polylines_exact
from comfystereo_tpu_torch.kernels import warp_kernel

MODS = (warp_kernel, distance, gather, polylines_exact, polylines)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _launches():
    return tuple(m.LAUNCHES for m in MODS)


def test_warp_route():
    """Shared memory up to SHARED_WIDTH, the workspace past it, any C, and
    an error past 65,536 columns."""
    assert warp_kernel.smem_bytes(warp_kernel.SHARED_WIDTH) <= _common.SMEM_LIMIT
    assert warp_kernel.smem_bytes(warp_kernel.SHARED_WIDTH + 1) > _common.SMEM_LIMIT
    kw = dict(gradient_threshold=1.5, max_stretch=8, max_disp=6)
    before = _launches()
    for w, c in ((1920, 1), (1920, 2), (1920, 4), (1920, 5), (16384, 3), (65536, 4)):
        rows = _meta(2, w)
        with pytest.raises(ValueError, match="unsupported device"):
            warp_kernel.warp_rows(rows, rows, _meta(2, w, c), **kw)
    rows = _meta(2, 65537)
    with pytest.raises(ValueError, match="65536 columns"):
        warp_kernel.warp_rows(rows, rows, _meta(2, 65537, 3), **kw)
    assert _launches() == before


def test_distance_route():
    """Shared memory up to 309,920 columns, the workspace past it, and an
    error past 2^24 columns."""
    assert distance.smem_bytes(distance.SHARED_WIDTH) <= distance.SMEM_LIMIT
    assert distance.row_words(1920) == 6 * 60
    before = _launches()
    for w in (1920, distance.SHARED_WIDTH + 1, distance.MAX_WIDTH):
        m = _meta(1, w, dtype=torch.bool)
        with pytest.raises(ValueError, match="unsupported device"):
            distance.edge_distances(m, m)
    m = _meta(1, distance.MAX_WIDTH + 1, dtype=torch.bool)
    with pytest.raises(ValueError, match="columns"):
        distance.edge_distances(m, m)
    assert _launches() == before


def test_gather_route():
    """M = N up to 29,053 staged row for row, 14,525 for a three-channel
    plane; wider rows go to the direct instance, which takes any width."""
    assert gather.staged(1920, 1920, 3)
    assert gather.staged(29053, 29053, 1) and not gather.staged(29054, 29054, 1)
    assert gather.staged(14525, 14525, 3) and not gather.staged(14526, 14526, 3)
    assert not gather.staged(16384, 16384, 3)
    before = _launches()
    with pytest.raises(ValueError, match="unsupported device"):
        gather.bounded_take_along_w(_meta(1, 3, 2, 16384),
                                    _meta(1, 1, 2, 16384, dtype=torch.int32), 8)
    assert _launches() == before


def test_polylines_exact_route():
    """max_pieces 1 to 16 and any C in the kernel; planes in shared memory
    up to 26,181 columns (8 B per column, 8 per 32 columns, 16 KB of lists
    and 64 static bytes), in the workspace past it; K of 0 or above 16 and
    rows past 2^24 columns raise."""
    assert polylines_exact.SHARED_WIDTH == 26181
    assert (polylines_exact.smem_bytes(26181) + 64 <= _common.SMEM_LIMIT
            < polylines_exact.smem_bytes(26182) + 64)
    before = _launches()
    kw = dict(sharp=True, max_disp=6)
    for w, c, k in ((1920, 3, 1), (1920, 4, 12), (1920, 7, 16), (26182, 3, 12)):
        with pytest.raises(ValueError, match="unsupported device"):
            polylines_exact.polylines_exact_rows_fused(_meta(2, w), _meta(2, w, c), 0.0,
                                                       max_pieces=k, **kw)
    for k in (0, 17, 24):
        with pytest.raises(ValueError, match="max_pieces"):
            polylines_exact.polylines_exact_rows_fused(_meta(2, 64), _meta(2, 64, 3), 0.0,
                                                       max_pieces=k, **kw)
    w = polylines_exact.MAX_WIDTH + 1
    with pytest.raises(ValueError, match="columns"):
        polylines_exact.polylines_exact_rows_fused(_meta(1, w), _meta(1, w, 3), 0.0,
                                                   max_pieces=12, **kw)
    assert _launches() == before


def test_polylines_route():
    """k_candidates 1 to 8 and any C in the kernel; planes staged while they
    fit (24 B per column, the sample offsets, 2 KB static: 9,598 columns at
    S = 8), in the workspace past it; K above 8 raises."""
    assert polylines.staged(9598, 8) and not polylines.staged(9599, 8)
    assert polylines.smem_bytes(9598, 8) + 2048 <= _common.SMEM_LIMIT
    before = _launches()
    kw = dict(sharp=True, samples=8, max_disp=6)
    for w, c, k in ((1920, 3, 1), (1920, 4, 4), (1920, 6, 8), (16384, 3, 4)):
        with pytest.raises(ValueError, match="unsupported device"):
            polylines.polylines_scanline_fused(_meta(2, w), _meta(2, w, c), 0.0,
                                               k_candidates=k, **kw)
    with pytest.raises(ValueError, match="k_candidates"):
        polylines.polylines_scanline_fused(_meta(2, 64), _meta(2, 64, 3), 0.0,
                                           k_candidates=9, **kw)
    assert _launches() == before


def test_strict_wrappers_raise_before_any_launch():
    """Counts past the kernels' ranges raise a ValueError and count no
    launch, C = 4 included."""
    coord = _meta(2, 64)
    c4 = _meta(2, 64, 4)
    before = _launches()
    kw = dict(sharp=True, max_disp=6)
    with pytest.raises(ValueError, match="max_pieces"):
        polylines_exact.polylines_exact_rows_fused(coord, c4, 0.0, max_pieces=17, **kw)
    with pytest.raises(ValueError, match="k_candidates"):
        polylines.polylines_scanline_fused(coord, c4, 0.0, samples=8, k_candidates=9, **kw)
    assert _launches() == before


@pytest.mark.parametrize("channels", [4, 5])
def test_cpu_wrappers_run_the_plain_version(channels):
    """On the CPU every wrapper runs the plain version: C over 3, K = 20 and
    K = 9 included, with no launch counted."""
    rng = torch.Generator().manual_seed(0)
    coord = (torch.rand((3, 40), generator=rng) - 0.5) * 6
    colors = torch.trunc(torch.rand((3, 40, channels), generator=rng) * 255)
    before = _launches()
    got = polylines_exact.polylines_exact_rows_fused(coord, colors, 0.5, sharp=True,
                                                     max_pieces=20, max_disp=8)
    assert torch.equal(got, polylines_exact.polylines_exact_rows_fused_plain(
        coord, colors, 0.5, True, 20, 8))
    kw = dict(sharp=False, samples=8, k_candidates=9, max_disp=8)
    got = polylines.polylines_scanline_fused(coord, colors, 0.5, **kw)
    assert torch.equal(got, polylines.polylines_scanline_fused_plain(coord, colors, 0.5, **kw))
    wkw = dict(gradient_threshold=1.5, max_stretch=8, max_disp=8)
    got = warp_kernel.warp_rows(coord, coord.abs(), colors / 255.0, **wkw)
    want = warp_kernel.warp_rows_plain(coord, coord.abs(), colors / 255.0, **wkw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert _launches() == before
