"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: these need an NVIDIA GPU and nvcc, and skip where CUDA is
absent. On the card run them with `python -m pytest tests/test_torch_port_cuda.py
-m cuda -q`. chip_smoke.py makes the same comparisons at the main path's
full 1080p shapes.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from comfystereo_tpu_torch import FILL_TECHNIQUES, StereoConfig, stereo_pipeline
from comfystereo_tpu_torch.kernels import (box_blend, distance, flash_attention, gather,
                                           polylines, polylines_exact, warp_kernel)
from comfystereo_tpu_torch.ops import blur as blur_ops
from comfystereo_tpu_torch.ops import depth as depth_ops
from comfystereo_tpu_torch.ops import polylines as polylines_ops
from comfystereo_tpu_torch.utils import fixtures

pytestmark = pytest.mark.cuda

H, W = 48, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(dev, depth, div_px, sep_px, dtype=torch.float32, channels=3):
    img = fixtures.create_test_image(H, W).astype(np.float32) / 255.0
    image = torch.from_numpy(img[..., :channels].copy()).to(dev, dtype)[None]
    nd = depth_ops.normalize_depth(torch.from_numpy(depth).to(dev)[None])
    off = depth_ops.pixel_offsets(nd, div_px, sep_px, 2.0, 0.5, prenormalized=True)
    kw = dict(gradient_threshold=1.5, max_stretch=8, max_disp=10)
    return (off.reshape(H, W).contiguous(), nd.reshape(H, W).contiguous(),
            image.reshape(H, W, channels).contiguous(), kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("div_px,sep_px", [(3.0, 0.0), (-3.0, 0.0), (5.0, 1.0)])
def test_warp_kernel_matches_plain(dev, div_px, sep_px, channels, dtype):
    depth = fixtures.create_depth_map(H, W).astype(np.float32)
    off, nd, rows, kw = _rows(dev, depth, div_px, sep_px, dtype, channels)
    before = warp_kernel.LAUNCHES
    out_k, gap_k = warp_kernel.warp_rows(off, nd, rows, **kw)
    torch.cuda.synchronize()
    assert warp_kernel.LAUNCHES == before + 1
    out_p, gap_p = warp_kernel.warp_rows_plain(off, nd, rows, **kw)
    assert torch.equal(gap_k, gap_p)
    assert float((out_k.float() - out_p.float()).abs().max()) <= 1e-5


@pytest.mark.parametrize("channels", [2, 4, 5])
def test_warp_kernel_takes_other_channel_counts(dev, channels):
    """C of 2, 4 and 5 run in the kernel (its taps loop over the channels),
    one launch each, as the plain version computes them."""
    depth = fixtures.create_depth_map(H, W).astype(np.float32)
    off, nd, _, kw = _rows(dev, depth, 3.0, 0.0)
    image = torch.rand(H, W, channels, device=dev)
    before = warp_kernel.LAUNCHES
    out_k, gap_k = warp_kernel.warp_rows(off, nd, image, **kw)
    torch.cuda.synchronize()
    assert warp_kernel.LAUNCHES == before + 1
    out_p, gap_p = warp_kernel.warp_rows_plain(off, nd, image, **kw)
    assert torch.equal(gap_k, gap_p)
    assert float((out_k - out_p).abs().max()) <= 1e-5


@pytest.mark.parametrize("p", [0.0, 0.02, 0.5])
def test_distance_kernel_matches_plain(dev, p):
    rng = np.random.default_rng(0)
    ml = torch.from_numpy(rng.random((37, 300)) < p).to(dev)
    mr = torch.from_numpy(rng.random((37, 300)) < p / 2).to(dev)
    before = distance.LAUNCHES
    kl, kr = distance.edge_distances(ml, mr)
    torch.cuda.synchronize()
    assert distance.LAUNCHES == before + 1
    pl, pr = distance.edge_distances_plain(ml, mr)
    assert torch.equal(kl, pl) and torch.equal(kr, pr)


def _eye_depth(kinds, h, w, seed=0):
    """[len(kinds) * h, w] float32 0-255 depth rows, one image per kind:
    the fixture scene, uniform noise, flat (range 0), or a horizontal ramp
    (no Sobel-x edge anywhere)."""
    rng = np.random.default_rng(seed)
    images = []
    for kind in kinds:
        if kind == "fixture":
            d = fixtures.create_depth_map(h, w).astype(np.float32)
        elif kind == "noise":
            d = rng.uniform(0, 255, (h, w)).astype(np.float32)
        elif kind == "flat":
            d = np.full((h, w), 77.0, np.float32)
        else:
            d = np.repeat(np.linspace(0.0, 255.0, h, dtype=np.float32)[:, None], w, 1)
        images.append(d)
    return np.concatenate(images)


def _warp_fused_case(dev, kinds, h, w, div_px, sep_px, exponent, dtype, channels):
    depth = torch.from_numpy(_eye_depth(kinds, h, w)).to(dev)
    b = len(kinds)
    dmin, dmax = torch.aminmax(depth.reshape(b, h * w), dim=-1)
    img = np.concatenate([fixtures.create_test_image(h, w)] * b).astype(np.float32) / 255.0
    image = torch.from_numpy(np.ascontiguousarray(img[..., :channels])).to(dev, dtype)
    cmax = 0.5 ** exponent
    kw = dict(divergence_px=div_px, separation_px=sep_px, exponent=exponent,
              convergence_point=0.5, gradient_threshold=1.5, max_stretch=8,
              max_disp=int(np.ceil(cmax * abs(div_px) + abs(sep_px))) + 4, height=h)
    return depth, dmin, dmax, image, kw


def _check_warp(out_k, gap_k, out_p, gap_p, kinds, h):
    """Gap masks bit-equal; colours within 1e-5 on every image but noise,
    where under 0.1% of pixels may differ by more."""
    assert torch.equal(gap_k, gap_p)
    err = (out_k.float() - out_p.float()).abs().amax(-1)
    for k, kind in enumerate(kinds):
        e = err[k * h:(k + 1) * h]
        if kind == "noise":
            assert float((e > 1e-5).float().mean()) < 0.001
        else:
            assert float(e.max()) <= 1e-5


@pytest.mark.parametrize("exponent", [2.0, 1.7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("w,div_px,sep_px", [(1920, 86.4, 0.0), (300, -13.5, 3.0),
                                             (64, 3.0, 0.0), (7, -2.0, 0.5)])
def test_warp_fused_entry_matches_plain(dev, w, div_px, sep_px, channels, dtype, exponent):
    """The fused entry (nd and offsets formed in the kernel) against its
    plain composition on the card, on fixture, noise and flat images."""
    kinds = ("fixture", "noise", "flat")
    depth, dmin, dmax, image, kw = _warp_fused_case(dev, kinds, 9, w, div_px, sep_px,
                                                    exponent, dtype, channels)
    before = warp_kernel.LAUNCHES
    out_k, gap_k = warp_kernel.warp_rows_fused(depth, dmin, dmax, image, **kw)
    torch.cuda.synchronize()
    assert warp_kernel.LAUNCHES == before + 1
    out_p, gap_p = warp_kernel.warp_rows_fused_plain(depth, dmin, dmax, image, **kw)
    _check_warp(out_k, gap_k, out_p, gap_p, kinds, 9)


@pytest.mark.parametrize("w,div_px", [(1920, 86.4), (300, -13.5), (64, 3.0), (7, -2.0)])
def test_warp_rows_entry_other_widths(dev, w, div_px):
    """The entry taking offsets and nd against warp_rows_plain at the same
    widths, on the nd and offsets the fused entry's composition forms."""
    kinds = ("fixture", "noise", "flat")
    depth, dmin, dmax, image, kw = _warp_fused_case(dev, kinds, 9, w, div_px, 1.0, 2.0,
                                                    torch.float32, 3)
    nd = depth_ops.normalize_between(depth.reshape(3, 9, w), dmin[:, None, None],
                                     dmax[:, None, None])
    off = depth_ops.pixel_offsets(nd, div_px, 1.0, 2.0, 0.5, prenormalized=True)
    nd, off = nd.reshape(-1, w).contiguous(), off.reshape(-1, w).contiguous()
    rkw = dict(gradient_threshold=1.5, max_stretch=8, max_disp=kw["max_disp"])
    out_k, gap_k = warp_kernel.warp_rows(off, nd, image, **rkw)
    out_p, gap_p = warp_kernel.warp_rows_plain(off, nd, image, **rkw)
    _check_warp(out_k, gap_k, out_p, gap_p, kinds, 9)


@pytest.mark.parametrize("w", [warp_kernel.SHARED_WIDTH, warp_kernel.SHARED_WIDTH + 1,
                               16384, warp_kernel.MAX_WIDTH])
def test_warp_entries_take_rows_over_shared_memory(dev, w):
    """The widest row whose planes fit in shared memory, the next (the
    workspace instances) and 65,536 columns, through both entries, one
    launch each; a wider row raises before any launch."""
    depth = torch.rand(2, w, device=dev) * 255.0
    image = torch.rand(2, w, 3, device=dev)
    dmin, dmax = torch.aminmax(depth.reshape(1, -1), dim=-1)
    kw = dict(divergence_px=20.0, separation_px=0.0, exponent=2.0, convergence_point=0.5,
              gradient_threshold=1.5, max_stretch=8, max_disp=9, height=2)
    before = warp_kernel.LAUNCHES
    out_k, gap_k = warp_kernel.warp_rows_fused(depth, dmin, dmax, image, **kw)
    nd = depth_ops.normalize_between(depth, dmin, dmax).contiguous()
    off = depth_ops.pixel_offsets(nd, 20.0, 0.0, 2.0, 0.5, prenormalized=True).contiguous()
    rkw = dict(gradient_threshold=1.5, max_stretch=8, max_disp=9)
    out_r, gap_r = warp_kernel.warp_rows(off, nd, image, **rkw)
    torch.cuda.synchronize()
    assert warp_kernel.LAUNCHES == before + 2
    out_p, gap_p = warp_kernel.warp_rows_fused_plain(depth, dmin, dmax, image, **kw)
    _check_warp(out_k, gap_k, out_p, gap_p, ("noise",), 2)
    out_p, gap_p = warp_kernel.warp_rows_plain(off, nd, image, **rkw)
    _check_warp(out_r, gap_r, out_p, gap_p, ("noise",), 2)


def test_warp_entries_reject_rows_over_their_range(dev):
    w = warp_kernel.MAX_WIDTH + 1
    depth = torch.zeros(2, w, device=dev)
    image = torch.zeros(2, w, 3, device=dev)
    lim = torch.zeros(2, device=dev)
    before = warp_kernel.LAUNCHES
    with pytest.raises(ValueError, match=str(warp_kernel.MAX_WIDTH)):
        warp_kernel.warp_rows(depth, depth, image, gradient_threshold=1.5, max_stretch=8,
                              max_disp=6)
    with pytest.raises(ValueError, match=str(warp_kernel.MAX_WIDTH)):
        warp_kernel.warp_rows_fused(depth, lim[:1], lim[:1], image, divergence_px=3.0,
                                    separation_px=0.0, exponent=2.0, convergence_point=0.5,
                                    gradient_threshold=1.5, max_stretch=8, max_disp=6,
                                    height=2)
    assert warp_kernel.LAUNCHES == before


@pytest.mark.parametrize("falloff", [2.0, 1.7])
@pytest.mark.parametrize("w", [1920, 300, 64, 7])
def test_edge_weights_fused_matches_plain(dev, w, falloff):
    """The fused entry (Sobel, masks, distances and weights in the kernel)
    bit-equal to its plain composition on the card, on images with edges,
    with noise, flat, and with no Sobel-x edge at all."""
    depth = torch.from_numpy(_eye_depth(("fixture", "noise", "flat", "ramp"), 9, w)).to(dev)
    kw = dict(edge_threshold=20.0, mask_radius=20, falloff=falloff, height=9)
    before = distance.LAUNCHES
    kl, kr = distance.edge_weights_fused(depth, **kw)
    torch.cuda.synchronize()
    assert distance.LAUNCHES == before + 1
    pl, pr = distance.edge_weights_plain(depth, **kw)
    assert torch.equal(kl, pl) and torch.equal(kr, pr)
    assert float(pl[18:].abs().max()) == 0.0  # no edge in the flat and ramp images


@pytest.mark.parametrize("w", [1920, 300, 64, 33, 7])
def test_distance_kernel_words(dev, w):
    """The mask entry against its plain version: rows with no edge, edges
    only in the first or the last word, one edge per row, and dense rows."""
    rng = np.random.default_rng(w)
    ml = rng.random((12, w)) < 0.05
    mr = rng.random((12, w)) < 0.3
    ml[0] = False
    mr[0] = False
    ml[1], mr[1] = False, False
    ml[1, 0], mr[1, w - 1] = True, True
    ml[2], mr[2] = False, False
    ml[2, : min(w, 32)] = rng.random(min(w, 32)) < 0.2
    mr[2, max(0, w - 32):] = rng.random(min(w, 32)) < 0.2
    ml[3], mr[3] = False, False
    ml[3, w // 2] = mr[3, w // 3] = True
    ml, mr = torch.from_numpy(ml).to(dev), torch.from_numpy(mr).to(dev)
    kl, kr = distance.edge_distances(ml, mr)
    pl, pr = distance.edge_distances_plain(ml, mr)
    assert torch.equal(kl, pl) and torch.equal(kr, pr)


@pytest.mark.parametrize("w", [distance.SHARED_WIDTH, distance.SHARED_WIDTH + 32])
def test_distance_entries_take_rows_over_shared_memory(dev, w):
    """The widest row whose words fit in shared memory and a wider one (the
    workspace instances), through both entries, bit-equal, one launch each."""
    depth = torch.rand(3, w, device=dev) * 255.0
    kw = dict(edge_threshold=20.0, mask_radius=20, falloff=2.0, height=3)
    ml, mr = distance.edge_masks(depth[None], 20.0)
    ml, mr = ml[0].contiguous(), mr[0].contiguous()
    before = distance.LAUNCHES
    kl, kr = distance.edge_weights_fused(depth, **kw)
    dl, dr = distance.edge_distances(ml, mr)
    torch.cuda.synchronize()
    assert distance.LAUNCHES == before + 2
    pl, pr = distance.edge_weights_plain(depth, **kw)
    assert torch.equal(kl, pl) and torch.equal(kr, pr)
    pl, pr = distance.edge_distances_plain(ml, mr)
    assert torch.equal(dl, pl) and torch.equal(dr, pr)


def test_blur_and_outputs_card_bit_equal_to_cpu(dev):
    """With the depth blur on, the blurred depth, the pipeline's depth
    outputs and its masks are bit-equal between card and CPU: every
    division by a scalar divides truly on both (device.true_divide), and
    the fused kernels divide in IEEE arithmetic."""
    imgs, depths = fixtures.batch_fixture(2, 270, 480)
    d255 = torch.from_numpy(depths * 255.0)
    kw = dict(blur_strength=20, edge_threshold=20, blur_mask_width=20, falloff_exponent=2.0,
              vert_smooth_px=6)
    for g, c in zip(blur_ops.directional_motion_blur(d255.to(dev), **kw),
                    blur_ops.directional_motion_blur(d255, **kw)):
        assert torch.equal(g.cpu(), c)
    for fill in ("gpu_warp", "polylines_sharp", "naive"):
        cfg = StereoConfig(fill_technique=fill, modes=("left-right", "top-bottom"))
        gpu = stereo_pipeline(torch.from_numpy(imgs).to(dev), torch.from_numpy(depths).to(dev),
                              cfg)
        cpu = stereo_pipeline(torch.from_numpy(imgs), torch.from_numpy(depths), cfg)
        for k in ("left_depth", "right_depth", "mask"):
            assert torch.equal(gpu[k].cpu(), cpu[k]), (fill, k)


def _blend_inputs(shape, seed=0):
    """Depth in 0-255 and two weight planes in [0, 1] with exact zeros and
    ones, as the edge weights have them (host tensors)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 255, shape).astype(np.float32)
    wl, wr = (np.where(rng.random(shape) < 0.4, 0.0, rng.random(shape) ** 2).astype(np.float32)
              for _ in range(2))
    wl[..., ::5, :] = 1.0
    return torch.from_numpy(d), torch.from_numpy(wl), torch.from_numpy(wr)


@pytest.mark.parametrize("shape", [(1, 5, 7), (3, 4, 3), (3, 13, 9), (1, 31, 45), (3, 21, 64),
                                   (2, 70, 530), (1, 130, 1031)])
@pytest.mark.parametrize("taps,radius", [(1, 0), (2, 1), (5, 6), (20, 6), (20, 0), (3, 9),
                                         (20, 12)])
def test_box_blend_kernel_matches_plain(dev, taps, radius, shape):
    """The box-blend kernel against its plain version, bit for bit: H < 2r
    + 1 and W < n, odd H and W, shapes across the kernel's strips and tiles,
    radii in the register ring and past it; one launch a call."""
    host = _blend_inputs(shape, seed=taps + radius)
    card = [t.to(dev) for t in host]
    before = box_blend.LAUNCHES
    got = box_blend.box_blend(*card, taps=taps, radius=radius)
    torch.cuda.synchronize()
    assert box_blend.LAUNCHES == before + 1
    want = box_blend.box_blend_plain(*card, taps=taps, radius=radius)
    for g, w, c in zip(got, want, box_blend.box_blend(*host, taps=taps, radius=radius)):
        assert torch.equal(g, w) and torch.equal(g.cpu(), c)


def test_box_blend_kernel_at_the_cells_shape(dev):
    """[12, 1080, 1920] with the cells' parameters (20 taps, radius 6), on
    the edge weights of fixture depth: bit-equal to the plain version on the
    card and to the CPU."""
    _, depths = fixtures.batch_fixture(12, 1080, 1920)
    d255 = torch.from_numpy(depths * 255.0)
    wl, wr = distance.edge_weights_fused(d255.reshape(-1, 1920).to(dev), edge_threshold=20.0,
                                         mask_radius=20, falloff=2.0, height=1080)
    card = (d255.to(dev), wl.reshape(d255.shape), wr.reshape(d255.shape))
    before = box_blend.LAUNCHES
    got = box_blend.box_blend(*card, taps=20, radius=6)
    torch.cuda.synchronize()
    assert box_blend.LAUNCHES == before + 1
    want = box_blend.box_blend_plain(*card, taps=20, radius=6)
    cpu = box_blend.box_blend_plain(*(t.cpu() for t in card), taps=20, radius=6)
    for g, w, c in zip(got, want, cpu):
        assert torch.equal(g, w) and torch.equal(g.cpu(), c)


def test_box_blend_kernel_takes_unaligned_planes(dev):
    """Planes that start one float past a 16-byte boundary, and a width
    that is no multiple of 4."""
    host = _blend_inputs((2, 19, 77), seed=4)
    card = []
    for t in host:
        buf = torch.empty(t.numel() + 1, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        card.append(view)
    assert card[0].data_ptr() % 16 == 4
    got = box_blend.box_blend(*card, taps=20, radius=6)
    for g, c in zip(got, box_blend.box_blend(*host, taps=20, radius=6)):
        assert torch.equal(g.cpu(), c)


def test_box_blend_kernel_rejects_what_it_does_not_take(dev):
    """A window over MAX_TAPS raises before any launch; non-contiguous
    planes raise."""
    d, wl, wr = (t.to(dev) for t in _blend_inputs((1, 8, 16)))
    before = box_blend.LAUNCHES
    with pytest.raises(ValueError, match="taps"):
        box_blend.box_blend(d, wl, wr, taps=box_blend.MAX_TAPS + 1, radius=0)
    with pytest.raises(ValueError, match="contiguous"):
        box_blend.box_blend(d[..., ::2], wl[..., ::2], wr[..., ::2], taps=5, radius=1)
    assert box_blend.LAUNCHES == before
    got = box_blend.box_blend(d, wl, wr, taps=box_blend.MAX_TAPS, radius=0)
    want = box_blend.box_blend_plain(d, wl, wr, taps=box_blend.MAX_TAPS, radius=0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_pipeline_on_card_matches_cpu(dev):
    imgs, depths = fixtures.batch_fixture(2, H, W)
    cfg = StereoConfig(depth_map_blur=False, modes=("left-right", "top-bottom"))
    gpu = stereo_pipeline(torch.from_numpy(imgs).to(dev),
                          torch.from_numpy(depths).to(dev), cfg)
    cpu = stereo_pipeline(torch.from_numpy(imgs), torch.from_numpy(depths), cfg)
    assert torch.equal(gpu["mask"].cpu(), cpu["mask"])
    for g, c in zip(gpu["stereo"], cpu["stereo"]):
        assert float((g.cpu() - c).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("m,n", [(300, 300), (320, 300), (300, 257)])
def test_gather_kernel_matches_torch_gather(dev, dtype, m, n):
    rng = np.random.default_rng(m + n)
    values = torch.from_numpy(rng.integers(-10 ** 6, 10 ** 6, (3, 7, m))).to(dev, dtype)
    idx = np.clip(np.arange(n) + rng.integers(-20, 21, (3, 7, n)), 0, m - 1)
    idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
    before = gather.LAUNCHES
    got = gather.bounded_take_along_w(values, idx, 24)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == before + 1
    assert torch.equal(got, torch.gather(values, -1, idx.long()))


def test_gather_kernel_broadcasts_index_planes(dev):
    """[B, 1, H, N] indices over [B, C, H, M] values, as the fills call it."""
    rng = np.random.default_rng(5)
    values = torch.from_numpy(rng.standard_normal((2, 3, 9, 200)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 200, (2, 1, 9, 200)).astype(np.int32)).to(dev)
    got = gather.bounded_take_along_w(values, idx, 200)
    assert torch.equal(got, gather.bounded_take_along_w_plain(values, idx))


@pytest.mark.parametrize("m,n", [(200, 200), (203, 197), (37, 30)])
def test_gather_kernel_planes_m_not_n(dev, m, n):
    """rep = 3 value rows per index row with M != N and N % 4 != 0: rows start
    at every 16-byte phase, so the scalar heads and tails run."""
    rng = np.random.default_rng(m * n)
    values = torch.from_numpy(rng.standard_normal((2, 3, 9, m)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, m, (2, 1, 9, n)).astype(np.int32)).to(dev)
    got = gather.bounded_take_along_w(values, idx, m)
    assert torch.equal(got, torch.gather(values, -1, idx.long().expand(2, 3, 9, n)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_gather_kernel_unaligned_views(dev, dtype):
    """values and index whose data start 4 bytes past a 16-byte boundary (a
    contiguous view at storage offset 1)."""
    rng = np.random.default_rng(7)
    vbase = torch.from_numpy(rng.integers(-10 ** 6, 10 ** 6, 3 * 7 * 300 + 1)).to(dev, dtype)
    ibase = torch.from_numpy(rng.integers(0, 300, 3 * 7 * 256 + 1).astype(np.int32)).to(dev)
    values, idx = vbase[1:].view(3, 7, 300), ibase[1:].view(3, 7, 256)
    assert values.data_ptr() % 16 == 4 and idx.data_ptr() % 16 == 4
    got = gather.bounded_take_along_w(values, idx, 300)
    assert torch.equal(got, torch.gather(values, -1, idx.long()))


def test_gather_kernel_binary_search_pattern(dev):
    """int32 sorted keys gathered at indices spread over the whole row, as
    the fills' binary searches' midpoints can fall."""
    rng = np.random.default_rng(11)
    keys = np.sort(rng.integers(0, 4000, (4, 30, 1920)), axis=-1).astype(np.int32)
    mid = rng.integers(0, 1920, (4, 30, 1920)).astype(np.int32)
    keys, mid = torch.from_numpy(keys).to(dev), torch.from_numpy(mid).to(dev)
    got = gather.bounded_take_along_w(keys, mid, 8)
    assert torch.equal(got, torch.gather(keys, -1, mid.long()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_gather_kernel_takes_rows_over_shared_memory(dev, dtype):
    """Rows too wide to stage (30,000 columns row for row; a 16,384-column
    three-channel plane) go to the direct instance: torch.gather's bits, one
    launch each."""
    rng = np.random.default_rng(5)
    values = torch.from_numpy(rng.integers(-2**20, 2**20, (2, 30000))).to(dev, dtype)
    idx = torch.from_numpy(rng.integers(0, 30000, (2, 30000)).astype(np.int32)).to(dev)
    planes = torch.from_numpy(rng.random((1, 3, 4, 16384))).to(dev, dtype)
    pidx = torch.from_numpy(rng.integers(0, 16384, (1, 1, 4, 16384)).astype(np.int32)).to(dev)
    assert not gather.staged(30000, 30000, 1) and not gather.staged(16384, 16384, 3)
    before = gather.LAUNCHES
    got = gather.bounded_take_along_w(values, idx, 8)
    got_p = gather.bounded_take_along_w(planes, pidx, 8)
    torch.cuda.synchronize()
    assert gather.LAUNCHES == before + 2
    assert torch.equal(got, gather.bounded_take_along_w_plain(values, idx))
    assert torch.equal(got_p, gather.bounded_take_along_w_plain(planes, pidx))


def _poly_rows(dev, depth, div_px, sep_px, channels):
    """Both polylines kernels' row arguments (x, signed coord, colours,
    max_disp), as the ops modules make them; the exact kernel takes |coord|."""
    img = fixtures.create_test_image(H, W).astype(np.float32)[..., :channels]
    nd = depth_ops.normalize_depth(torch.from_numpy(depth).to(dev)[None]) - 0.5
    coord = depth_ops.signed_power(nd, 2.0)[0] * div_px
    x = torch.arange(W, dtype=torch.float32, device=dev) + 0.5 + coord + sep_px
    colors = torch.from_numpy(np.ascontiguousarray(img)).to(dev)
    max_disp = int(np.ceil(abs(div_px) + abs(sep_px))) + 4
    return x.contiguous(), coord.contiguous(), colors, max_disp


def _depth(kind):
    if kind == "fixture":
        return fixtures.create_depth_map(H, W).astype(np.float32)
    return np.random.default_rng(0).uniform(0, 255, (H, W)).astype(np.float32)


@pytest.mark.parametrize("sharp", [True, False])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("div_px,sep_px,kind", [(3.0, 0.0, "fixture"), (-3.0, 0.0, "fixture"),
                                                (4.5, 1.0, "noise"), (-6.0, 0.5, "noise")])
def test_polylines_kernel_matches_plain(dev, sharp, channels, div_px, sep_px, kind):
    x, coord, colors, max_disp = _poly_rows(dev, _depth(kind), div_px, sep_px, channels)
    cl = coord.abs()
    kw = dict(sharp=sharp, max_pieces=12, max_disp=max_disp)
    before = polylines_exact.LAUNCHES
    got = polylines_exact.polylines_exact_rows(x, cl, colors, **kw)
    torch.cuda.synchronize()
    assert polylines_exact.LAUNCHES == before + 1
    want = polylines_exact.polylines_exact_rows_plain(x, cl, colors, sharp, 12, max_disp)
    assert torch.equal(got, want)


@pytest.mark.parametrize("sharp", [True, False])
@pytest.mark.parametrize("div_px,sep_px,kind", [(3.0, 0.0, "fixture"), (-4.5, 1.0, "noise")])
def test_polylines_fused_entries_match_plain(dev, sharp, div_px, sep_px, kind):
    """Both fused entries (x, and for the exact kernel |coord|, formed in
    the kernel; the supersampled one also finishes the colour) against
    their plain compositions, bit-equal, each counting one launch."""
    _, coord, colors, max_disp = _poly_rows(dev, _depth(kind), div_px, sep_px, 3)
    kw = dict(sharp=sharp, max_pieces=12, max_disp=max_disp)
    before = polylines_exact.LAUNCHES
    got = polylines_exact.polylines_exact_rows_fused(coord, colors, sep_px, **kw)
    torch.cuda.synchronize()
    assert polylines_exact.LAUNCHES == before + 1
    assert torch.equal(got, polylines_exact.polylines_exact_rows_fused_plain(
        coord, colors, sep_px, sharp, 12, max_disp))
    skw = dict(sharp=sharp, samples=8, k_candidates=4, max_disp=max_disp)
    before = polylines.LAUNCHES
    got = polylines.polylines_scanline_fused(coord, colors, sep_px, **skw)
    torch.cuda.synchronize()
    assert polylines.LAUNCHES == before + 1
    assert torch.equal(got, polylines.polylines_scanline_fused_plain(coord, colors, sep_px,
                                                                     **skw))


@pytest.mark.parametrize("list_cap", [0, 1, 3])
@pytest.mark.parametrize("kind", ["fixture", "noise"])
def test_polylines_kernel_overflowing_lists(dev, list_cap, kind):
    """Columns whose candidate list outgrows list_cap scan their range of
    sources instead: the output stays bit-equal, and the kernel counts
    those columns as `candidate_lists` does."""
    x, coord, colors, max_disp = _poly_rows(dev, _depth(kind), 4.5, 1.0, 3)
    cl = coord.abs()
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    got = polylines_exact.polylines_exact_rows(x, cl, colors, sharp=True, max_pieces=12,
                                               max_disp=max_disp, list_cap=list_cap,
                                               overflow=overflow)
    torch.cuda.synchronize()
    assert torch.equal(got, polylines_exact.polylines_exact_rows_plain(x, cl, colors, True, 12,
                                                                       max_disp))
    lengths = polylines_exact.candidate_lists(x, True, max_disp)[0]
    assert int(overflow) == int((lengths > list_cap).sum()) > 0


@pytest.mark.parametrize("w,div_px", [(300, 6.0), (20, 40.0), (7, 25.0)])
@pytest.mark.parametrize("sharp", [True, False])
def test_polylines_kernels_other_widths(dev, w, div_px, sharp):
    """Widths that are not a multiple of 256 (a partial last warp and
    block of 32 columns), and widths smaller than the candidate window."""
    rng = np.random.default_rng(w)
    depth = torch.from_numpy(rng.uniform(0, 255, (5, w)).astype(np.float32)).to(dev)
    nd = depth_ops.normalize_depth(depth[None]) - 0.5
    coord = (depth_ops.signed_power(nd, 2.0)[0] * div_px).contiguous()
    colors = torch.from_numpy(rng.integers(0, 256, (5, w, 3)).astype(np.float32)).to(dev)
    max_disp = int(np.ceil(div_px)) + 5
    x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5 + coord + 1.0).contiguous()
    cl = coord.abs()
    got = polylines_exact.polylines_exact_rows(x, cl, colors, sharp=sharp, max_pieces=12,
                                               max_disp=max_disp)
    assert torch.equal(got, polylines_exact.polylines_exact_rows_plain(x, cl, colors, sharp, 12,
                                                                       max_disp))
    got = polylines_exact.polylines_exact_rows_fused(coord, colors, 1.0, sharp=sharp,
                                                     max_pieces=12, max_disp=max_disp)
    assert torch.equal(got, polylines_exact.polylines_exact_rows_fused_plain(
        coord, colors, 1.0, sharp, 12, max_disp))
    skw = dict(sharp=sharp, samples=8, k_candidates=4, max_disp=max_disp)
    assert torch.equal(polylines.polylines_scanline(x, coord, colors, **skw),
                       polylines.polylines_scanline_plain(x, coord, colors, **skw))
    assert torch.equal(polylines.polylines_scanline_fused(coord, colors, 1.0, **skw),
                       polylines.polylines_scanline_fused_plain(coord, colors, 1.0, **skw))


def test_polylines_kernel_rejects_list_caps_it_lacks(dev):
    x, coord, colors, max_disp = _poly_rows(dev, _depth("fixture"), 3.0, 0.0, 3)
    with pytest.raises(ValueError, match="list_cap"):
        polylines_exact.polylines_exact_rows(x, coord.abs(), colors, sharp=True, max_pieces=12,
                                             max_disp=max_disp,
                                             list_cap=polylines_exact.LIST_CAP + 1)


@pytest.mark.parametrize("sharp", [True, False])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("div_px,sep_px,kind", [(3.0, 0.0, "fixture"), (-3.0, 0.0, "fixture"),
                                                (4.5, 1.0, "noise"), (-6.0, 0.5, "noise")])
def test_supersampled_polylines_kernel_matches_plain(dev, sharp, channels, div_px, sep_px,
                                                     kind):
    x, coord, colors, max_disp = _poly_rows(dev, _depth(kind), div_px, sep_px, channels)
    kw = dict(sharp=sharp, samples=8, k_candidates=4, max_disp=max_disp)
    before = polylines.LAUNCHES
    got = polylines.polylines_scanline(x, coord, colors, **kw)
    torch.cuda.synchronize()
    assert polylines.LAUNCHES == before + 1
    assert torch.equal(got, polylines.polylines_scanline_plain(x, coord, colors, **kw))


@pytest.mark.parametrize("samples", [1, 4, 5])
def test_supersampled_polylines_kernel_other_sample_counts(dev, samples):
    x, coord, colors, max_disp = _poly_rows(dev, _depth("noise"), 5.0, -0.5, 3)
    kw = dict(sharp=True, samples=samples, k_candidates=4, max_disp=max_disp)
    got = polylines.polylines_scanline(x, coord, colors, **kw)
    assert torch.equal(got, polylines.polylines_scanline_plain(x, coord, colors, **kw))


def test_supersampled_polylines_kernel_rejects_unsupported(dev):
    """k_candidates 0 and 9 raise before any launch (C = 4 and K = 3 are in
    the kernel's range)."""
    x, coord, colors, max_disp = _poly_rows(dev, _depth("fixture"), 3.0, 0.0, 3)
    before = polylines.LAUNCHES
    for k in (0, 9):
        with pytest.raises(ValueError):
            polylines.polylines_scanline(x, coord, colors, sharp=True, samples=8,
                                         k_candidates=k, max_disp=max_disp)
    assert polylines.LAUNCHES == before


@pytest.mark.parametrize("sharp", [True, False])
def test_supersampled_routes_on_card_match_cpu(dev, sharp):
    """Each route of apply_polylines gives the same bits on the card as on
    the CPU (the kernel against its plain version, the twin's PyTorch ops
    on both devices)."""
    img, depths = fixtures.batch_fixture(2, H, W)
    img = np.trunc(img * 255.0).astype(np.float32)
    nd = depth_ops.normalize_depth(torch.from_numpy(depths)) - 0.5
    for impl in ("kernel", "twin"):
        outs = [polylines_ops.apply_polylines(torch.from_numpy(img).to(d), nd.to(d), 4.0, 1.0,
                                              2.0, sharp=sharp, impl=impl).cpu()
                for d in (dev, torch.device("cpu"))]
        assert torch.equal(outs[0], outs[1]), impl


@pytest.mark.parametrize("fill", [f for f in FILL_TECHNIQUES if f != "gpu_warp"])
def test_fill_pipeline_on_card_matches_cpu(dev, fill):
    """Stereo outputs equal in uint8 (x255) and masks bit-equal; the hybrid
    fills (torch.cumsum's and exp's rounding differ between card and CPU)
    within 1 LSB on at most 1% of values."""
    imgs, depths = fixtures.batch_fixture(2, H, W)
    cfg = StereoConfig(depth_map_blur=False, fill_technique=fill,
                       modes=("left-right", "red-cyan-anaglyph"))
    gpu = stereo_pipeline(torch.from_numpy(imgs).to(dev),
                          torch.from_numpy(depths).to(dev), cfg)
    cpu = stereo_pipeline(torch.from_numpy(imgs), torch.from_numpy(depths), cfg)
    hybrid = fill.startswith("hybrid")
    mask_off = float((gpu["mask"].cpu() != cpu["mask"]).float().mean())
    assert mask_off <= (0.001 if hybrid else 0.0)
    for g, c in zip(gpu["stereo"], cpu["stereo"]):
        diff = (torch.round(g.cpu() * 255) - torch.round(c * 255)).abs()
        if hybrid:
            assert float(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 0.01
        else:
            assert float(diff.max()) == 0.0


@pytest.mark.parametrize("bh,nq,nk,d", [
    (16, 4096, 4096, 40),   # SD 1.5 level-0 self-attention, CFG batch 2 x 8 heads
    (16, 1024, 1024, 80),   # level 1
    (4, 1024, 2048, 40),    # BN 'bi' stereo: kv = both views
    (2, 1024, 1024, 64),
    (2, 1152, 1024, 20),    # d not a multiple of 8: the wrapper pads to 24 and slices
    (2, 1024, 1024, 128),   # a padded head dimension of 128 (two 64-column blocks)
    (2, 1024, 1024, 48),    # d between 40 and 64
    (2, 2048, 1024, 80),    # nq != nk
])
def test_flash_kernel_matches_reference(dev, bh, nq, nk, d):
    """bf16 outputs within 4e-3 of the plain version in f32 (JAX's own bound
    for its kernel against `_reference`, tests/test_flash_attention.py)."""
    rng = np.random.default_rng(bh * nq + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, n, d), dtype=np.float32)).to(
        dev, torch.bfloat16) for n in (nq, nk, nk))
    assert flash_attention.supports(nq, nk, d, torch.bfloat16)
    before = flash_attention.LAUNCHES
    got = flash_attention.flash_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = flash_attention.reference(q, k, v, d ** -0.5)
    assert float((got.float() - want.float()).abs().max()) <= 4e-3


def test_flash_kernel_rejects_unsupported_shapes(dev):
    q = torch.zeros(2, 512, 40, device=dev, dtype=torch.bfloat16)
    before = flash_attention.LAUNCHES
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q, q, 0.1)
    assert flash_attention.LAUNCHES == before


# --- the flash kernel's gradient and the Standard path --------------------------

def _flash_qkv(dev, bh, nq, nk, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((bh, n, d), dtype=np.float32)).to(
        dev, torch.bfloat16) for n in (nq, nk, nk)]


@pytest.mark.parametrize("bh,nq,nk,d", [
    (8, 4096, 4096, 40),    # null-text backward, level 0 (one latent, 8 heads)
    (16, 4096, 8192, 40),   # BN 'bi' pair
    (8, 1024, 1024, 80),    # level 1
    (2, 1024, 1024, 80),
    (2, 1152, 1024, 20),    # padded head dimension
])
def test_flash_autograd_matches_reference_bf16_gradient(dev, bh, nq, nk, d):
    """The backward is `reference_bf16`'s VJP bit for bit for one cotangent
    and launches nothing; the gradient of sum(o^2) is within 2% of the
    largest |component| of `reference_bf16`'s own (5 bf16 ulps there): the
    forwards differ (f32 logits in the kernel, bf16 in `reference_bf16`),
    so the cotangents 2o differ too (on the CPU, with `reference` as the
    forward: up to 2 ulps, 7.8e-3 at 0.52)."""
    q, k, v = _flash_qkv(dev, bh, nq, nk, d, bh + nq + d)
    scale = d ** -0.5
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    g = torch.randn((bh, nq, d), device=dev).to(torch.bfloat16)
    before = flash_attention.LAUNCHES
    out = flash_attention.flash_attention(*qkv, scale)
    got = torch.autograd.grad(out, qkv, g)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + 1
    want = torch.autograd.grad(flash_attention.reference_bf16(*qkv, scale), qkv, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    def grads(fn):
        x = [t.clone().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad((fn(*x, scale).float() ** 2).sum(), x)

    for a, b in zip(grads(flash_attention.flash_attention), grads(flash_attention.reference_bf16)):
        assert bool(torch.isfinite(a).all())
        assert float((a.float() - b.float()).abs().max()) <= 2e-2 * float(b.float().abs().max())


def test_text2stereo_tiny_on_card_matches_cpu(dev, monkeypatch):
    """float32 TINY UNet + VAE, 64x64, 4 steps, null-text with 2 inner
    steps, deblur on with the same injected noise: left and right within
    1e-3 of the CPU's (float32 sums in other orders through the loop). TF32
    off, as chip_smoke.py runs: cuDNN's default TF32 convolutions alone put
    the card 1.7e-2 from the CPU here."""
    from comfystereo_tpu_torch.diffusion import (TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG,
                                                 build_sd_model, sd_pipeline)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    img = fixtures.create_test_image(64, 64).astype(np.float32)[None] / 255.0
    depth = fixtures.create_depth_map(64, 64).astype(np.float32)[None] / 255.0
    x = torch.from_numpy(img).permute(0, 3, 1, 2) * 2.0 - 1.0
    noise = torch.randn((1, 4, 32, 32), generator=torch.Generator().manual_seed(3))
    outs = []
    for d in (dev, torch.device("cpu")):
        m = build_sd_model(TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, seed=0, device=d)
        outs.append(sd_pipeline.text2stereo(
            m, x.to(d), torch.from_numpy(depth).to(d), "a cat", scale_factor=8.0,
            deblur=True, guidance_scale=3.0, num_inference_steps=4,
            null_text_optimization=True, num_inner_steps=2, noise=noise.to(d)))
    for a, b in zip(outs[0], outs[1]):
        assert a.device.type == "cuda"
        assert float((a.cpu() - b).abs().max()) <= 1e-3


def test_null_text_gradient_through_kernel_tiny_bf16(dev):
    """The TINY UNet in bf16 at 64x64 takes the kernel at its 1024-token
    level: the null-text gradient of u through the kernel's autograd is
    within 0.05 (relative L2) of the gradient with the attention forced to
    its plain version, and the self-attentions carry part of it."""
    from comfystereo_tpu_torch.diffusion import (TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG,
                                                 build_sd_model, schedulers)
    m = build_sd_model(TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, seed=0, device=dev,
                       dtype=torch.bfloat16)
    sched = schedulers.make_ddim(10)
    t = int(sched.timesteps[0])
    gen = torch.Generator().manual_seed(1)
    lat = torch.randn((1, 4, 32, 32), generator=gen).to(dev)
    prev = lat + 0.05 * torch.randn(lat.shape, generator=gen).to(dev)

    def grad():
        cond = m.text_encode("")
        with torch.no_grad():
            eps_c = m.unet_apply(lat, t, cond)
        u = cond.clone().requires_grad_(True)
        eps_u = m.unet_apply(lat, t, u)
        eps = eps_u + 3.0 * (eps_c - eps_u)
        loss = torch.mean((schedulers.ddim_step(sched, eps, t, lat) - prev) ** 2)
        return torch.autograd.grad(loss, u)[0].float()

    kernel = flash_attention.flash_attention
    before = flash_attention.LAUNCHES
    g_k = grad()
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES > before
    try:
        flash_attention.flash_attention = flash_attention.reference
        g_p = grad()
        flash_attention.flash_attention = lambda q, k, v, s: kernel(q, k, v, s).detach()
        g_cut = grad()
    finally:
        flash_attention.flash_attention = kernel
    rel = float((g_k - g_p).norm() / g_p.norm())
    assert rel <= 0.05
    assert float((g_k - g_cut).norm() / g_k.norm()) > rel


def test_tiny_checkpoint_dir_on_card_matches_cpu(dev, tmp_path, monkeypatch):
    """A TINY diffusers directory (float16 files) loaded in float32 on the
    card and on the CPU: text embeddings, one UNet call, VAE encode and
    decode, and the w8 model's eps (min_elems 1024, q and scale bit-equal)
    within 1e-4. TF32 off, as chip_smoke.py runs."""
    from comfystereo_tpu_torch.diffusion import (TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG,
                                                 TINY_TEXT_CONFIG, build_sd_model, porting,
                                                 quantize)
    from torch_checkpoint import toy_vocab, write_sd_dir
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    states, _, _ = write_sd_dir(str(tmp_path), TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG,
                                TINY_TEXT_CONFIG, toy_vocab(), seed=2)
    gen = torch.Generator().manual_seed(0)
    lat, img = torch.randn(2, 4, 16, 16, generator=gen), torch.rand(1, 3, 32, 32, generator=gen)
    ctx = torch.randn(2, 77, 64, generator=gen)
    outs = []
    for d in (dev, torch.device("cpu")):
        m = porting.load_sd_from_diffusers_dir(str(tmp_path), TINY_SD_UNET_CONFIG,
                                               TINY_SD_VAE_CONFIG, dtype=torch.float32, device=d)
        z = m.vae_encode(img.to(d) * 2 - 1)
        w8 = build_sd_model(TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, device=d,
                            unet_state=states["unet"])
        quantize.quantize_module_(w8.unet, torch.float32, min_elems=1024)
        qs = [x.q.cpu() for x in w8.unet.modules() if isinstance(x, quantize.W8Linear)]
        outs.append(([m.text_encode(p) for p in ("low", "lower lower", "")]
                     + [m.unet_apply(lat.to(d), 500, ctx.to(d)), z, m.vae_decode(z),
                        w8.unet_apply(lat.to(d), 500, ctx.to(d))], qs))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert a.device.type == "cuda"
        assert float((a.cpu() - b).abs().max()) <= 1e-4
    assert len(outs[0][1]) > 10 and all(torch.equal(a, b) for a, b in zip(*[o[1] for o in outs]))


def _graph_bundle(dev):
    """The TINY UNet with the SD-inpainting input (9 channels) in bf16: at
    64x64 latents its self-attentions take the flash kernel at both
    levels."""
    from comfystereo_tpu_torch.diffusion import (TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG,
                                                 build_sd_model)
    cfg = dataclasses.replace(TINY_SD_UNET_CONFIG, in_channels=9)
    return build_sd_model(cfg, TINY_SD_VAE_CONFIG, dtype=torch.bfloat16, seed=0, device=dev)


def _graph_inputs(dev, seed, batch=2):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((batch, 9, 64, 64), generator=gen).to(dev),
            torch.randn((batch, 77, 64), generator=gen).to(dev))


def _graph_counts():
    from comfystereo_tpu_torch.diffusion import sd_unet
    return sd_unet.UNET_GRAPH_CAPTURES, sd_unet.UNET_GRAPH_CALLS


def test_graphed_unet_matches_eager_bit_for_bit(dev):
    """`unet_apply` over the Fast path's 13 timesteps, each call with new
    latents and context: one capture, 13 calls served by replays, each eps
    bit-equal to the eager forward's. The flash kernel is in the graph:
    `LAUNCHES` counts host launches, so it moves by a forward's launches for
    each eager pass (the warm-up, the capture and the 13 eager references)
    and not for a replay."""
    from comfystereo_tpu_torch.diffusion import schedulers, sd_unet
    from comfystereo_tpu_torch.diffusion.attention import AttentionMode
    m = _graph_bundle(dev)
    ts = [int(t) for t in schedulers.pndm_skip_timesteps(schedulers.make_pndm(20), 0.6)]
    assert len(ts) == 13
    with torch.no_grad():
        lat, ctx = _graph_inputs(dev, 99)
        before = flash_attention.LAUNCHES
        m.unet_apply.eager(lat, 999, ctx, AttentionMode(), False)
        per_forward = flash_attention.LAUNCHES - before
        assert per_forward > 0
        counts, before = _graph_counts(), flash_attention.LAUNCHES
        for i, t in enumerate(ts):
            lat, ctx = _graph_inputs(dev, i)
            got = m.unet_apply(lat, t, ctx)
            want = m.unet_apply.eager(lat, t, ctx, AttentionMode(), False)
            assert got.dtype == torch.float32
            assert torch.equal(got, want), f"call {i} (t={t})"
    assert _graph_counts() == (counts[0] + 1, counts[1] + 13)
    passes = sd_unet.GRAPH_WARMUPS + 1 + 13
    assert flash_attention.LAUNCHES == before + passes * per_forward


@pytest.mark.parametrize("batch", [1, 2])
def test_graphed_unet_replays_channels_last_latents(dev, batch):
    """Latents in the channels-last layout the VAE's encode leaves (the
    Standard path's inversion and null-text steps) are replayed from a graph
    of their own layout, bit-equal to the eager forward on them."""
    from comfystereo_tpu_torch.diffusion.attention import AttentionMode
    m = _graph_bundle(dev)
    counts = _graph_counts()
    with torch.no_grad():
        for i in range(3):
            lat, ctx = _graph_inputs(dev, i, batch=batch)
            lat = lat.contiguous(memory_format=torch.channels_last)
            got = m.unet_apply(lat, 801 - 40 * i, ctx)
            want = m.unet_apply.eager(lat, 801 - 40 * i, ctx, AttentionMode(), False)
            assert torch.equal(got, want), f"call {i}"
    assert _graph_counts() == (counts[0] + 1, counts[1] + 3)


def test_graphed_unet_output_held_stays_after_the_next_call(dev):
    m = _graph_bundle(dev)
    with torch.no_grad():
        lat, ctx = _graph_inputs(dev, 0)
        held = m.unet_apply(lat, 601, ctx)
        kept = held.clone()
        lat, ctx = _graph_inputs(dev, 1)
        after = m.unet_apply(lat, 21, ctx)
    torch.cuda.synchronize()
    assert torch.equal(held, kept)
    assert not torch.equal(held, after)


def test_graphed_unet_serves_a_context_that_requires_grad_eagerly(dev):
    """Null-text optimisation's embedding requires grad: its call runs the
    forward eagerly, captures nothing, and the embedding gets its
    gradient."""
    from comfystereo_tpu_torch.diffusion.attention import AttentionMode
    m = _graph_bundle(dev)
    lat, ctx = _graph_inputs(dev, 0)
    counts = _graph_counts()
    u = ctx.clone().requires_grad_(True)
    with torch.enable_grad():
        eps = m.unet_apply(lat, 601, u)
        eps.square().mean().backward()
    assert _graph_counts() == counts and not m.unet_apply.graphs
    assert u.grad is not None and bool(torch.isfinite(u.grad).all())
    assert float(u.grad.abs().max()) > 0
    with torch.no_grad():
        assert torch.equal(eps.detach(), m.unet_apply.eager(lat, 601, ctx, AttentionMode(),
                                                            False))


@pytest.mark.parametrize("direction", ["uni", "bi"])
def test_graphed_unet_stereo_modes_capture_a_graph_each(dev, direction):
    """A stereo `AttentionMode` under CFG ([u_L, u_R, c_L, c_R]) before the
    stereo start and after it: two graphs, each bit-equal to the eager
    forward, and calls again on both keys capture nothing more."""
    from comfystereo_tpu_torch.diffusion.attention import AttentionMode
    m = _graph_bundle(dev)
    mode = AttentionMode(stereo=True, direction=direction, use_cfg=True)
    counts = _graph_counts()
    with torch.no_grad():
        for i, active in enumerate((False, True, False, True)):
            lat, ctx = _graph_inputs(dev, i, batch=4)
            got = m.unet_apply(lat, 401, ctx, mode=mode, stereo_active=active)
            want = m.unet_apply.eager(lat, 401, ctx, mode, active)
            assert torch.equal(got, want), f"call {i}, stereo_active {active}"
    assert _graph_counts() == (counts[0] + 2, counts[1] + 4)
    assert len(m.unet_apply.graphs) == 2


def _sdxl_graph_bundle(dev):
    """A tiny SDXL UNet (the SDXL driver's tiny settings: no attention on
    the first level, transformer depths 1 and 2, linear projections,
    text-time conditioning, 9 input channels) in bf16: at 64x64 latents its
    second level's self-attentions take the flash kernel."""
    from comfystereo_tpu_torch.diffusion import TINY_SD_VAE_CONFIG, SDUNetConfig, build_sd_model
    from stereo_bench.drivers.stereo_diffusion_node_xl import TINY_SETTINGS
    cfg = SDUNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in TINY_SETTINGS["unet"].items()})
    return build_sd_model(cfg, TINY_SD_VAE_CONFIG, dtype=torch.bfloat16, seed=0, device=dev)


def test_graphed_sdxl_unet_replays_new_conditioning_bit_for_bit(dev):
    """SDXL's `unet_apply` over the Fast path's 13 timesteps, each call with
    new latents, context, pooled embeddings and time ids: one capture, 13
    replays, each eps bit-equal to the eager forward's on that call's own
    conditioning (a replay that kept an earlier call's ids would differ),
    and the flash kernel in the graph."""
    from comfystereo_tpu_torch.diffusion import schedulers
    from comfystereo_tpu_torch.diffusion.attention import AttentionMode
    m = _sdxl_graph_bundle(dev)
    ts = [int(t) for t in schedulers.pndm_skip_timesteps(schedulers.make_pndm(20), 0.6)]
    counts, outs = _graph_counts(), []
    with torch.no_grad():
        before = flash_attention.LAUNCHES
        for i, t in enumerate(ts):
            gen = torch.Generator().manual_seed(100 + i)
            lat = torch.randn((2, 9, 64, 64), generator=gen).to(dev)
            ctx = torch.randn((2, 77, 32), generator=gen).to(dev)
            pooled = torch.randn((2, 16), generator=gen).to(dev)
            ids = torch.tensor([[64.0 * (i + 1), 96.0, 0.0, 0.0, 128.0, 128.0]] * 2, device=dev)
            got = m.unet_apply(lat, t, ctx, text_embeds=pooled, time_ids=ids)
            want = m.unet_apply.eager(lat, t, ctx, AttentionMode(), False, pooled, ids)
            assert torch.equal(got, want), f"call {i} (t={t})"
            outs.append(got)
    assert _graph_counts() == (counts[0] + 1, counts[1] + 13)
    assert flash_attention.LAUNCHES > before
    assert not torch.equal(outs[0], outs[1])


def test_graphed_sd_unet_keys_as_before_sdxl(dev, monkeypatch):
    """An SD 1.5-style bundle's calls carry no text-time conditioning: the
    graph key has the form it had before SDXL's fields (13 entries), the
    added embedding never runs, and the replay is the eager forward's bits.
    (Its launches a frame, `launches_per_frame.sd_fast`, are compared with
    the parent commit's in the benchmark's traced runs.)"""
    from comfystereo_tpu_torch.diffusion import sd_unet
    from comfystereo_tpu_torch.diffusion.attention import AttentionMode
    monkeypatch.setattr(sd_unet.SDUNet, "_text_time",
                        lambda *a: pytest.fail("text-time conditioning on an SD UNet"))
    m = _graph_bundle(dev)
    lat, ctx = _graph_inputs(dev, 5)
    key = sd_unet.graph_key(lat, 601, ctx, AttentionMode(), False)
    assert len(key) == 13
    with torch.no_grad():
        got = m.unet_apply(lat, 601, ctx)
        assert torch.equal(got, m.unet_apply.eager(lat, 601, ctx, AttentionMode(), False))
    assert list(m.unet_apply.graphs) == [key]


@pytest.mark.parametrize("shape", [(320, 1280), (640, 320, 3, 3)])
def test_w8_layer_on_card_matches_cpu(dev, shape):
    """A bf16 layer quantised on the card has the CPU's q and scale bit for
    bit (the division by 127 is a true division on both), the same
    dequantised weight, and an output within bf16 rounding of the CPU's."""
    from comfystereo_tpu_torch.diffusion import quantize
    gen = torch.Generator().manual_seed(1)
    w = torch.randn(shape, generator=gen) * torch.rand(
        (shape[0],) + (1,) * (len(shape) - 1), generator=gen)
    layer = torch.nn.Linear(shape[1], shape[0]) if len(shape) == 2 else \
        torch.nn.Conv2d(shape[1], shape[0], 3, padding=1)
    with torch.no_grad():
        layer.weight.copy_(w)
    layer = layer.bfloat16()
    kind = quantize.W8Linear if len(shape) == 2 else quantize.W8Conv2d
    cpu = kind(layer, torch.bfloat16)
    card = kind(copy.deepcopy(layer).to(dev), torch.bfloat16)
    assert torch.equal(card.q.cpu(), cpu.q)
    assert torch.equal(card.scale.cpu().view(torch.int32), cpu.scale.view(torch.int32))
    assert torch.equal(card.weight.cpu(), cpu.weight)
    x = torch.randn((4, shape[1]) if len(shape) == 2 else (1, shape[1], 16, 16),
                    generator=gen).bfloat16()
    with torch.no_grad():
        want = cpu(x).float()
        rel = float((card(x.to(dev)).float().cpu() - want).norm() / want.norm())
    assert rel <= 1e-2


@pytest.mark.parametrize("fill", ["gpu_warp", "naive", "hybrid_edge", "polylines_sharp"])
@pytest.mark.parametrize("mesh_shape", [(4,), (2, 2)])
def test_sharded_chunk_on_one_card_bit_equal(dev, fill, mesh_shape):
    """stereo_pipeline on a mesh of slots on cuda:0 (frames, or frames and
    rows with the blur's halos and the frames' extrema exchanged): every
    output bit-equal to the unsharded chunk, each kernel launched once per
    block as often as on the whole chunk."""
    from comfystereo_tpu_torch.parallel import make_mesh, shard_batch
    imgs, depths = fixtures.batch_fixture(4, H, W)
    img, dep = torch.from_numpy(imgs).to(dev), torch.from_numpy(depths).to(dev)
    cfg = StereoConfig(fill_technique=fill, modes=("top-bottom", "left-right"))
    mods = (distance, gather, polylines, polylines_exact, warp_kernel, box_blend)
    before = [m.LAUNCHES for m in mods]
    want = stereo_pipeline(img, dep, cfg)
    torch.cuda.synchronize()
    base = [m.LAUNCHES - b for m, b in zip(mods, before)]
    axes = ("data",) if len(mesh_shape) == 1 else ("data", "seq")
    mesh = make_mesh(4, axes=axes, shape=mesh_shape, device="cuda:0")
    s_img, s_dep = shard_batch(img, dep, mesh, rows=len(mesh_shape) == 2)
    before = [m.LAUNCHES for m in mods]
    got = stereo_pipeline(s_img, s_dep, cfg)
    torch.cuda.synchronize()
    assert [m.LAUNCHES - b for m, b in zip(mods, before)] == [4 * n for n in base]
    for g, w in zip(got["stereo"], want["stereo"]):
        assert torch.equal(g.gather(), w)
    for k in ("mask", "left_depth", "right_depth"):
        assert torch.equal(got[k].gather(), want[k]), k


@pytest.mark.parametrize("exponent", [1.0, 2.0])
def test_backward_warp_family_card_matches_cpu(dev, exponent):
    """The backward-warp family on the card against the CPU: masks
    bit-equal, colours within 1e-5."""
    from comfystereo_tpu_torch.ops import backward_warp as bw
    imgs, depths = fixtures.batch_fixture(2, H, W)
    image, depth = torch.from_numpy(imgs), torch.from_numpy(depths) * 255.0
    args = (6.0, 1.0, exponent, 0.5)

    def family(img, d):
        out = {"bw": bw.backward_warp(img, d, *args), "gap": bw.forward_gap_mask(d, *args)}
        for mode in ("border", "zeros", "reflection"):
            out[mode], out[mode + " valid"] = bw.backward_warp_padded(img, d, *args,
                                                                      fill_mode=mode)
        out["wf"], out["wf gap"] = bw.warp_and_fill(img, d, *args)
        out["interp"] = bw.interpolate_fill(img, out["gap"])
        return out

    cpu, card = family(image, depth), family(image.to(dev), depth.to(dev))
    for k, want in cpu.items():
        got = card[k].cpu()
        if want.dtype == torch.bool:
            assert torch.equal(got, want), k
        else:
            assert float((got - want).abs().max()) <= 1e-5, k


def test_kernels_on_a_card_other_than_the_current(dev):
    """Tensors on cuda:1 while cuda:0 is current: every kernel launches on
    their card (the wrappers set the current device around the C entry) and
    the sharded chunk over two cards is bit-equal to one card's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from comfystereo_tpu_torch.parallel import make_mesh, shard_batch
    imgs, depths = fixtures.batch_fixture(2, H, W)
    for fill in ("gpu_warp", "naive", "polylines_sharp"):
        cfg = StereoConfig(fill_technique=fill, modes=("left-right", "top-bottom"))
        want = stereo_pipeline(torch.from_numpy(imgs).to("cuda:0"),
                               torch.from_numpy(depths).to("cuda:0"), cfg)
        with torch.cuda.device(0):
            got = stereo_pipeline(torch.from_numpy(imgs).to("cuda:1"),
                                  torch.from_numpy(depths).to("cuda:1"), cfg)
        torch.cuda.synchronize(1)
        for g, w in zip(got["stereo"], want["stereo"]):
            assert torch.equal(g.cpu(), w.cpu()), fill
        mesh = make_mesh(2, axes=("data", "seq"), shape=(1, 2),
                         device=["cuda:0", "cuda:1"])
        s_img, s_dep = shard_batch(imgs, depths, mesh, rows=True)
        sharded = stereo_pipeline(s_img, s_dep, cfg)
        for g, w in zip(sharded["stereo"], want["stereo"]):
            assert torch.equal(g.gather(), w), fill


# --- the K ranges, any C and wide rows in the kernels ---------------------

def _k_rows(dev, kind, h=H, w=W):
    """Row arguments of both polylines kernels at divergence 4.5% of the
    width on fixture or uniform-noise depth (noise puts many breakpoints in
    a column, so the piece and candidate counts matter)."""
    if kind == "fixture":
        depth = fixtures.create_depth_map(h, w).astype(np.float32)
    else:
        depth = np.random.default_rng(1).uniform(0, 255, (h, w)).astype(np.float32)
    img = fixtures.create_test_image(h, w).astype(np.float32)
    nd = depth_ops.normalize_depth(torch.from_numpy(depth).to(dev)[None]) - 0.5
    coord = (depth_ops.signed_power(nd, 2.0)[0] * (0.045 * w)).contiguous()
    colors = torch.from_numpy(img).to(dev).contiguous()
    return coord, colors, int(np.ceil(0.045 * w)) + 4


@pytest.mark.parametrize("sharp", [True, False])
@pytest.mark.parametrize("kind", ["fixture", "noise"])
@pytest.mark.parametrize("k", list(range(1, 17)))
def test_exact_kernel_every_max_pieces(dev, k, kind, sharp):
    """max_pieces 1 to 16 in the kernel (slot templates 12 and 16), through
    both entries, bit-equal to the plain version, one launch each."""
    coord, colors, max_disp = _k_rows(dev, kind)
    x = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5 + coord).contiguous()
    before = polylines_exact.LAUNCHES
    got = polylines_exact.polylines_exact_rows_fused(coord, colors, 0.0, sharp=sharp,
                                                     max_pieces=k, max_disp=max_disp)
    got_x = polylines_exact.polylines_exact_rows(x, coord.abs(), colors, sharp=sharp,
                                                 max_pieces=k, max_disp=max_disp)
    torch.cuda.synchronize()
    assert polylines_exact.LAUNCHES == before + 2
    want = polylines_exact.polylines_exact_rows_plain(x, coord.abs(), colors, sharp, k,
                                                      max_disp)
    assert torch.equal(got, want) and torch.equal(got_x, want)


def test_exact_max_pieces_changes_the_output(dev):
    """On noise rows the piece cap matters: K = 1, 4 and 16 give three
    different images, so the tests above hold K itself."""
    coord, colors, max_disp = _k_rows(dev, "noise")
    outs = [polylines_exact.polylines_exact_rows_fused(coord, colors, 0.0, sharp=True,
                                                       max_pieces=k, max_disp=max_disp)
            for k in (1, 4, 16)]
    assert not torch.equal(outs[0], outs[1]) and not torch.equal(outs[1], outs[2])


@pytest.mark.parametrize("sharp", [True, False])
@pytest.mark.parametrize("kind", ["fixture", "noise"])
@pytest.mark.parametrize("k", list(range(1, 9)))
def test_supersampled_kernel_every_k_candidates(dev, k, kind, sharp):
    """k_candidates 1 to 8 in the kernel (a run-time bound of its loops),
    both entries bit-equal to the plain version."""
    coord, colors, max_disp = _k_rows(dev, kind)
    x = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5 + coord).contiguous()
    kw = dict(sharp=sharp, samples=8, k_candidates=k, max_disp=max_disp)
    before = polylines.LAUNCHES
    got = polylines.polylines_scanline(x, coord, colors, **kw)
    fused = polylines.polylines_scanline_fused(coord, colors, 0.0, **kw)
    torch.cuda.synchronize()
    assert polylines.LAUNCHES == before + 2
    want = polylines.polylines_scanline_plain(x, coord, colors, **kw)
    assert torch.equal(got, want)
    assert torch.equal(fused, torch.trunc(torch.clamp(want / 8 + 0.5, 0.0, 255.0)))


@pytest.mark.parametrize("channels", [4, 5, 7])
def test_other_channel_counts_run_in_the_kernels(dev, channels):
    """C over 3 through the warp and both polylines routes: one launch per
    eye's call, and the plain version's bits (the warp's gap masks, its
    colours within 1e-5)."""
    img, depths = fixtures.batch_fixture(2, H, W)
    img = np.concatenate([img, np.tile(img, 2)[..., :channels - 3]], -1).astype(np.float32)
    image = torch.from_numpy(img).to(dev)
    depth = torch.from_numpy(depths).to(dev)
    u8 = torch.trunc(image * 255.0)
    nd = depth_ops.normalize_depth(depth) - 0.5
    from comfystereo_tpu_torch.ops import polylines_exact as exact_ops
    from comfystereo_tpu_torch.ops import warp as warp_ops
    before = (warp_kernel.LAUNCHES, polylines_exact.LAUNCHES, polylines.LAUNCHES)
    a, gap_a = warp_ops.forward_warp(image, depth, 4.0, 0.5, 2.0)
    e = exact_ops.apply_polylines_exact(u8, nd, 4.0, 0.5, 2.0)
    s = polylines_ops.apply_polylines(u8, nd, 4.0, 0.5, 2.0)
    torch.cuda.synchronize()
    assert (warp_kernel.LAUNCHES, polylines_exact.LAUNCHES, polylines.LAUNCHES) == tuple(
        b + 1 for b in before)
    b, gap_b = warp_ops.forward_warp(image, depth, 4.0, 0.5, 2.0, impl="twin")
    assert torch.equal(gap_a, gap_b) and float((a - b).abs().max()) <= 1e-5
    assert torch.equal(e, exact_ops.apply_polylines_exact(u8, nd, 4.0, 0.5, 2.0, impl="twin"))
    coord = (depth_ops.signed_power(nd, 2.0) * 4.0).reshape(-1, W).contiguous()
    want = polylines.polylines_scanline_fused_plain(
        coord, u8.reshape(-1, W, channels).contiguous(), 0.5, sharp=True, samples=8,
        k_candidates=4, max_disp=9).reshape(s.shape)
    assert torch.equal(s, want)
    # each group of three channels is the three-channel image's render
    e3 = exact_ops.apply_polylines_exact(u8[..., :3].contiguous(), nd, 4.0, 0.5, 2.0)
    assert torch.equal(e[..., :3], e3)


def test_wide_rows_run_in_the_kernels(dev):
    """16,384-column rows (over every row kernel's shared memory but the
    distance kernel's) through the warp, the gather and both polylines
    kernels: one launch each and the plain version's bits (the warp's gap
    masks, its colours within 1e-5 on all but under 0.1% of the noise
    pixels)."""
    w = 16384
    rng = np.random.default_rng(2)
    depth = torch.from_numpy(rng.uniform(0, 255, (1, 6, w)).astype(np.float32)).to(dev)
    image = torch.from_numpy(rng.random((1, 6, w, 3)).astype(np.float32)).to(dev)
    from comfystereo_tpu_torch.ops import warp as warp_ops
    vals = image.movedim(-1, 1).contiguous()
    idx = torch.from_numpy(rng.integers(0, w, (1, 1, 6, w)).astype(np.int32)).to(dev)
    coord, colors, max_disp = _k_rows(dev, "noise", 6, w)
    mods = (warp_kernel, gather, polylines_exact, polylines)
    before = tuple(m.LAUNCHES for m in mods)
    a, gap_a = warp_ops.forward_warp(image, depth, 40.0, 0.0, 2.0)
    g = gather.bounded_take_along_w(vals, idx, w)
    e = polylines_exact.polylines_exact_rows_fused(coord, colors, 0.0, sharp=True,
                                                   max_pieces=12, max_disp=max_disp)
    skw = dict(sharp=True, samples=8, k_candidates=4, max_disp=max_disp)
    s = polylines.polylines_scanline_fused(coord, colors, 0.0, **skw)
    torch.cuda.synchronize()
    assert tuple(m.LAUNCHES for m in mods) == tuple(b + 1 for b in before)
    b, gap_b = warp_ops.forward_warp(image, depth, 40.0, 0.0, 2.0, impl="twin")
    _check_warp(a.reshape(6, w, 3), gap_a.reshape(6, w), b.reshape(6, w, 3),
                gap_b.reshape(6, w), ("noise",), 6)
    assert torch.equal(g, gather.bounded_take_along_w_plain(vals, idx))
    assert torch.equal(e, polylines_exact.polylines_exact_rows_fused_plain(
        coord, colors, 0.0, True, 12, max_disp))
    assert torch.equal(s, polylines.polylines_scanline_fused_plain(coord, colors, 0.0, **skw))


def test_polylines_kernels_take_their_widest_rows(dev):
    """The widest rows whose planes fit in shared memory and the next (the
    workspace instances) launch and are bit-equal."""
    for mod, w_max, kw in (
            (polylines_exact, polylines_exact.SHARED_WIDTH, dict(max_pieces=12)),
            (polylines, max(w for w in range(9000, 10000) if polylines.staged(w, 8)),
             dict(samples=8, k_candidates=4))):
        for w in (w_max, w_max + 1):
            coord, colors, max_disp = _k_rows(dev, "noise", 2, w)
            fused = (mod.polylines_exact_rows_fused if mod is polylines_exact
                     else mod.polylines_scanline_fused)
            plain = (mod.polylines_exact_rows_fused_plain if mod is polylines_exact
                     else mod.polylines_scanline_fused_plain)
            before = mod.LAUNCHES
            got = fused(coord, colors, 0.0, sharp=True, max_disp=max_disp, **kw)
            torch.cuda.synchronize()
            assert mod.LAUNCHES == before + 1, (mod.__name__, w)
            if mod is polylines_exact:
                want = plain(coord, colors, 0.0, True, kw["max_pieces"], max_disp)
            else:
                want = plain(coord, colors, 0.0, sharp=True, max_disp=max_disp, **kw)
            assert torch.equal(got, want), (mod.__name__, w)


def test_sqrt_card_bit_equal_to_cpu(dev):
    """`device.sqrt` rounds correctly on both devices, so the warp's gap
    interpolation and the schedulers take the same square roots."""
    from comfystereo_tpu_torch.device import sqrt
    x = torch.rand(1 << 20) * 1e3
    assert torch.equal(sqrt(x.to(dev)).cpu(), sqrt(x))


def test_scheduler_steps_card_bit_equal_to_cpu(dev):
    """The coefficients are host float32 scalars placed as 0-d tensors on
    the sample's device, so every DDIM, Euler and PNDM step gives the CPU's
    bits on the card (the card divides by a 0-d card tensor truly)."""
    from comfystereo_tpu_torch.diffusion import schedulers as s
    rng = np.random.default_rng(0)
    x, e = (torch.from_numpy(rng.standard_normal((2, 4, 64, 64)).astype(np.float32))
            for _ in range(2))
    ddim, euler = s.make_ddim(20), s.make_euler(20)
    for t in (1, 451, 951):
        for fn in (lambda a, b: s.ddim_step(ddim, b, t, a),
                   lambda a, b: s.ddim_next_step(ddim, b, t, a),
                   lambda a, b: s.add_noise(ddim, a, b, t),
                   lambda a, b: s.to_sigma_space(ddim, a, t),
                   lambda a, b: s.scale_model_input(euler, a, t),
                   lambda a, b: s.euler_step(euler, b, t, a)):
            assert torch.equal(fn(x.to(dev), e.to(dev)).cpu(), fn(x, e))
    pndm = s.make_pndm(20)
    ts = [int(v) for v in s.pndm_skip_timesteps(pndm, 0.6)]
    cpu = (x, torch.zeros((4,) + x.shape), torch.zeros(x.shape))
    card = tuple(v.to(dev) for v in cpu)
    for i in range(6):
        eps = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
        cpu = s.pndm_scan_step(pndm, i, ts[i], cpu[1], cpu[2], eps, cpu[0])
        card = s.pndm_scan_step(pndm, i, ts[i], card[1], card[2], eps.to(dev), card[0])
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b), i


def _chunk_u8(b=2, h=H, w=W):
    rng = np.random.default_rng(5)
    bgr = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    dep = np.repeat(fixtures.create_depth_map(h, w)[None, ..., None], b, 0).repeat(3, -1)
    return bgr, np.ascontiguousarray(dep.astype(np.uint8))


def test_device_chunk_counts_its_upload(dev):
    """Per chunk, `UPLOAD_BYTES` grows by both inputs' bytes, 2 * B * H * W * 3,
    `DOWNLOAD_BYTES` by the packed pair's, B * H * 2W * 3, and `STAGED_BYTES`
    by both."""
    from comfystereo_tpu_torch.utils import video
    bgr, dep = _chunk_u8()
    cfg = StereoConfig(batch_size=2)
    frames, up = video.FRAMES, video.UPLOAD_BYTES
    down, staged = video.DOWNLOAD_BYTES, video.STAGED_BYTES
    for k in (1, 2):
        video.device_chunk(bgr, dep, cfg, device=dev)
        assert video.FRAMES == frames + 2 * k
        assert video.UPLOAD_BYTES == up + k * 2 * 2 * H * W * 3
        assert video.DOWNLOAD_BYTES == down + k * 2 * H * 2 * W * 3
        assert video.STAGED_BYTES == staged + k * 4 * 2 * H * W * 3


def _chunk_on_card(bgr, dep, cfg, dev):
    """The chunk program written out on the card, brought over by `.cpu()`."""
    from comfystereo_tpu_torch.device import true_divide
    img = true_divide(torch.from_numpy(bgr).to(dev).flip(-1).float(), 255.0)
    d = torch.from_numpy(dep).to(dev).float()
    gray = true_divide(0.2989 * d[..., 2] + 0.5870 * d[..., 1] + 0.1140 * d[..., 0], 255.0)
    sbs = stereo_pipeline(img, gray, cfg)["stereo"][0]
    return torch.trunc(torch.clamp(sbs.float() * 255.0, 0.0, 255.0)).to(
        torch.uint8).flip(-1).cpu()


@pytest.mark.parametrize("fill", ["gpu_warp", "polylines_sharp"])
def test_device_chunk_returns_its_result_pinned_on_the_host(dev, fill):
    """The result is a page-locked host tensor, bit-equal to the chunk
    program computed on the card and brought over by `.cpu()`; for numpy
    inputs, host tensors and inputs already on the card alike."""
    from comfystereo_tpu_torch.utils import video
    bgr, dep = _chunk_u8()
    cfg = StereoConfig(fill_technique=fill, batch_size=2)
    want = _chunk_on_card(bgr, dep, cfg, dev)
    for args in ((bgr, dep), (torch.from_numpy(bgr), torch.from_numpy(dep)),
                 (torch.from_numpy(bgr).to(dev), torch.from_numpy(dep).to(dev))):
        out = video.device_chunk(*args, cfg, device=dev)
        assert out.device.type == "cpu" and out.is_pinned()
        assert out.dtype == torch.uint8 and torch.equal(out, want)


def test_device_chunk_stages_no_input_already_on_the_card(dev):
    """Inputs on the card go up neither counted nor staged; the result still
    comes down through page-locked memory."""
    from comfystereo_tpu_torch.utils import video
    bgr, dep = _chunk_u8()
    cfg = StereoConfig(batch_size=2)
    args = (torch.from_numpy(bgr).to(dev), torch.from_numpy(dep).to(dev))
    up, down, staged = video.UPLOAD_BYTES, video.DOWNLOAD_BYTES, video.STAGED_BYTES
    video.device_chunk(*args, cfg, device=dev)
    assert video.UPLOAD_BYTES == up
    assert video.DOWNLOAD_BYTES == down + 2 * H * 2 * W * 3
    assert video.STAGED_BYTES == staged + 2 * H * 2 * W * 3


@pytest.mark.parametrize("frames", [1, 5, 12])
def test_upload_stages_groups_of_frames_exactly(dev, frames):
    """1080p uint8 frames go up in groups (12 frames: three of four), a
    non-contiguous view too, and arrive as they were."""
    from comfystereo_tpu_torch.utils import video
    rng = np.random.default_rng(frames)
    x = torch.from_numpy(rng.integers(0, 256, (frames, 1080, 1920, 3), dtype=np.uint8))
    for src in (x, x.permute(0, 2, 1, 3)):
        up, staged = video.UPLOAD_BYTES, video.STAGED_BYTES
        groups = video._CardGroups(dev, (src,))
        got = torch.cat([groups.up(a, b)[0] for a, b in video._groups(frames, src.nbytes)])
        assert got.device.type == "cuda" and torch.equal(got.cpu(), src)
        assert video.UPLOAD_BYTES == up + src.nbytes
        assert video.STAGED_BYTES == staged + src.nbytes


@pytest.mark.parametrize("group_frames", [None, 3])
def test_device_chunk_results_held_at_once_stay_their_own(dev, group_frames, monkeypatch):
    """Four results of four different chunks, all held, each still equals
    its own chunk's output once the last is made: no buffer of a result is
    reused while the caller holds it; in one group, or in groups of three
    frames (3, 3, 2)."""
    from comfystereo_tpu_torch.utils import video
    if group_frames:
        monkeypatch.setattr(video, "_GROUP_BYTES", group_frames * H * W * 3)
    cfg = StereoConfig(batch_size=8)
    rng = np.random.default_rng(11)
    chunks = []
    for _ in range(4):
        bgr = rng.integers(0, 256, (8, H, W, 3), dtype=np.uint8)
        dep = np.repeat(rng.integers(0, 256, (8, H, W, 1), dtype=np.uint8), 3, axis=-1)
        chunks.append((bgr, dep))
    held = [video.device_chunk(bgr, dep, cfg, device=dev) for bgr, dep in chunks]
    assert len({t.data_ptr() for t in held}) == 4
    for out, (bgr, dep) in zip(held, chunks):
        assert torch.equal(out, _chunk_on_card(bgr, dep, cfg, dev))


@pytest.mark.parametrize("fill", ["gpu_warp", "polylines_sharp"])
def test_device_chunk_launches_the_box_blend_once(dev, fill):
    """Each chunk with the depth blur on launches the box-blend kernel once
    and the edge-distance kernel once."""
    from comfystereo_tpu_torch.utils import video
    bgr, dep = _chunk_u8()
    cfg = StereoConfig(fill_technique=fill, batch_size=2)
    for k in (1, 2):
        before = (box_blend.LAUNCHES, distance.LAUNCHES)
        video.device_chunk(bgr, dep, cfg, device=dev)
        assert (box_blend.LAUNCHES, distance.LAUNCHES) == (before[0] + 1, before[1] + 1), k


@pytest.mark.parametrize("n", [12, 7])
@pytest.mark.parametrize("fill", ["gpu_warp", "polylines_sharp"])
def test_device_chunk_in_groups_is_the_chunk_program(dev, fill, n):
    """At 1080p a chunk runs in groups of frames (12: three of four; 7: four
    and three), each group's staging overlapping the card's work on the
    one before; the result is the whole chunk program's on the card bit for
    bit, for host inputs and for inputs already on the card."""
    from comfystereo_tpu_torch.utils import video
    rng = np.random.default_rng(n)
    bgr = rng.integers(0, 256, (n, 1080, 1920, 3), dtype=np.uint8)
    dm = fixtures.create_depth_map(1080, 1920)
    dep = np.stack([np.roll(dm, 7 * i, axis=1) for i in range(n)])[..., None].repeat(3, -1)
    assert len(video._groups(n, bgr.nbytes)) > 1
    cfg = StereoConfig(fill_technique=fill, batch_size=n)
    want = _chunk_on_card(bgr, dep, cfg, dev)
    for args in ((bgr, dep), (torch.from_numpy(bgr).to(dev), torch.from_numpy(dep).to(dev))):
        out = video.device_chunk(*args, cfg, device=dev)
        assert out.device.type == "cpu" and out.is_pinned()
        assert out.dtype == torch.uint8 and torch.equal(out, want)


def test_device_chunk_counts_bytes_and_overlapped_frames_in_groups(dev, monkeypatch):
    """In groups the byte counters grow per chunk as in one group, and
    `OVERLAPPED_FRAMES` grows by the chunk's frames only where it ran in
    two or more groups."""
    from comfystereo_tpu_torch.utils import video
    bgr, dep = _chunk_u8(b=5)
    cfg = StereoConfig(batch_size=5)
    counters = ("FRAMES", "UPLOAD_BYTES", "DOWNLOAD_BYTES", "STAGED_BYTES", "OVERLAPPED_FRAMES")
    for group_frames, overlapped in ((None, 0), (2, 5)):
        if group_frames:
            monkeypatch.setattr(video, "_GROUP_BYTES", group_frames * H * W * 3)
        before = {c: getattr(video, c) for c in counters}
        video.device_chunk(bgr, dep, cfg, device=dev)
        grown = {c: getattr(video, c) - before[c] for c in counters}
        assert grown == {"FRAMES": 5, "UPLOAD_BYTES": 2 * 5 * H * W * 3,
                         "DOWNLOAD_BYTES": 5 * H * 2 * W * 3,
                         "STAGED_BYTES": 4 * 5 * H * W * 3,
                         "OVERLAPPED_FRAMES": overlapped}, group_frames


@pytest.mark.parametrize("fill", ["gpu_warp", "polylines_sharp"])
def test_device_chunk_launches_the_box_blend_once_a_group(dev, fill, monkeypatch):
    """A chunk of 5 frames in groups of two launches the box-blend kernel
    and the edge-distance kernel once for each of its three groups."""
    from comfystereo_tpu_torch.utils import video
    bgr, dep = _chunk_u8(b=5)
    cfg = StereoConfig(fill_technique=fill, batch_size=5)
    monkeypatch.setattr(video, "_GROUP_BYTES", 2 * H * W * 3)
    before = (box_blend.LAUNCHES, distance.LAUNCHES)
    video.device_chunk(bgr, dep, cfg, device=dev)
    assert (box_blend.LAUNCHES, distance.LAUNCHES) == (before[0] + 3, before[1] + 3)


@pytest.mark.parametrize("fill,homes", [
    ("gpu_warp", {"edge_distances_kernel": ("blur.edge_weights", 1),
                  "box_blend_kernel": ("blur.box_w", 1),
                  "warp_rows_kernel": ("pipeline.eye", 2)}),
    ("polylines_sharp", {"edge_distances_kernel": ("blur.edge_weights", 1),
                         "box_blend_kernel": ("blur.box_w", 1),
                         "polylines_exact_kernel": ("pipeline.eye", 2)})])
def test_traced_chunk_puts_named_kernels_under_their_spans(dev, fill, homes, tmp_path):
    """On a traced chunk each named kernel's launch call (paired by the
    trace's correlation id) lies inside its span, as often as the chunk
    launches it; the chunk makes as many launch calls as kernels, and no
    copy between host and card is pageable."""
    import json
    import re
    from torch.profiler import ProfilerActivity, profile
    from comfystereo_tpu_torch.utils import video
    bgr, dep = _chunk_u8()
    cfg = StereoConfig(fill_technique=fill, batch_size=2)
    video.device_chunk(bgr, dep, cfg, device=dev)  # the kernels built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        video.device_chunk(bgr, dep, cfg, device=dev)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
              if e.get("ph") == "X"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver") and "Launch" in e["name"]}
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    for kname, (home, count) in homes.items():
        found = [e for e in events if e.get("cat") == "kernel"
                 and re.search(rf"\b{kname}\b", e["name"])]
        assert len(found) == count, kname
        for k in found:
            call = launch[k["args"]["correlation"]]
            assert any(s["name"] == home and s["ts"] <= call["ts"] <= s["ts"] + s["dur"]
                       for s in spans), kname
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels and len(launch) == len(kernels)
    copies = [e["name"] for e in events if e.get("cat") == "gpu_memcpy"]
    assert copies and not [c for c in copies if "Pageable" in c], copies
