"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: these need an NVIDIA GPU and nvcc, and skip where CUDA is
absent. On the card run them with `python -m pytest tests/test_torch_port_cuda.py
-m cuda -q`. chip_smoke.py makes the same comparisons at the main path's
full 1080p shapes.
"""
import numpy as np
import pytest
import torch

from comfystereo_tpu_torch import FILL_TECHNIQUES, StereoConfig, stereo_pipeline
from comfystereo_tpu_torch.kernels import (distance, flash_attention, gather, polylines,
                                           polylines_exact, warp_kernel)
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


def test_warp_kernel_rejects_other_channel_counts(dev):
    off = torch.zeros(4, W, device=dev)
    with pytest.raises(ValueError):
        warp_kernel.warp_rows(off, off, torch.zeros(4, W, 2, device=dev),
                              gradient_threshold=1.5, max_stretch=8, max_disp=6)


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
    x, coord, colors, max_disp = _poly_rows(dev, _depth("fixture"), 3.0, 0.0, 3)
    with pytest.raises(ValueError):
        polylines.polylines_scanline(x, coord, colors, sharp=True, samples=8, k_candidates=3,
                                     max_disp=max_disp)
    with pytest.raises(ValueError):
        polylines.polylines_scanline(x, coord, torch.zeros(H, W, 4, device=dev), sharp=True,
                                     samples=8, k_candidates=4, max_disp=max_disp)


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
    (2, 1152, 1024, 20),    # d not a multiple of 8: the scalar loads
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
