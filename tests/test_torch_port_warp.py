"""Port's forward_warp (plain version on the CPU) vs the JAX package's XLA
path and its Pallas kernel run in interpret mode.

Stated tolerances: gap masks bit-equal; colours atol 1e-5 (bf16 colour:
within 2 LSB after x255). Measured: the port is bit-equal to the XLA path in
both gap and colour; it differs from the interpret-mode Pallas kernel by up
to 1.2e-6 in colour, as the XLA path does.

The CUDA kernel's design is checked here through its float32 models
(tests/torch_warp_model.py), bit for bit: the segment intervals and warp
windows drop no (column, segment) pair that the plain version accepts, the
model of the column loop gives the plain version's z-buffer, and the fused
entry's plain version is the composition normalize -> offsets ->
warp_rows_plain.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfystereo_tpu.ops import warp as jwarp
from comfystereo_tpu.utils import fixtures
from comfystereo_tpu_torch.kernels import _common
from comfystereo_tpu_torch.kernels import warp_kernel as twk
from comfystereo_tpu_torch.ops import depth as tdepth
from comfystereo_tpu_torch.ops import warp as twarp

import torch_warp_model as model

H, W = 48, 64


def _inputs():
    img = fixtures.create_test_image(H, W).astype(np.float32) / 255.0
    depth = fixtures.create_depth_map(H, W).astype(np.float32)
    return img, depth


def _port(img, depth, *args):
    out, gap = twarp.forward_warp(torch.from_numpy(img), torch.from_numpy(depth),
                                  *args)
    return out.float().numpy(), gap.numpy()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("div_px,sep_px", [(3.0, 0.0), (-3.0, 0.0), (5.0, 1.0)])
def test_forward_warp_matches_jax(impl, div_px, sep_px):
    img, depth = _inputs()
    a, gap_a = jwarp.forward_warp(jnp.asarray(img[None]), jnp.asarray(depth[None]),
                                  div_px, sep_px, 2.0, 0.5, impl=impl)
    b, gap_b = _port(img[None], depth[None], div_px, sep_px, 2.0, 0.5)
    np.testing.assert_array_equal(np.asarray(gap_a), gap_b)
    np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-5)
    if impl == "xla":
        np.testing.assert_array_equal(b, np.asarray(a))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_warp_batched(impl):
    img, depth = _inputs()
    imgs = np.ascontiguousarray(np.stack([img, img[:, ::-1]]))
    depths = np.ascontiguousarray(np.stack([depth, depth[:, ::-1]]))
    a, gap_a = jwarp.forward_warp(jnp.asarray(imgs), jnp.asarray(depths),
                                  3.0, 0.0, 2.0, 0.5, impl=impl)
    b, gap_b = _port(imgs, depths, 3.0, 0.0, 2.0, 0.5)
    np.testing.assert_array_equal(np.asarray(gap_a), gap_b)
    np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_warp_bf16_colour(impl):
    img, depth = _inputs()
    a, gap_a = jwarp.forward_warp(jnp.asarray(img[None]).astype(jnp.bfloat16),
                                  jnp.asarray(depth[None]), 5.0, 1.0, 2.0, 0.5,
                                  impl=impl)
    b, gap_b = twarp.forward_warp(torch.from_numpy(img[None]).to(torch.bfloat16),
                                  torch.from_numpy(depth[None]), 5.0, 1.0, 2.0, 0.5)
    assert b.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(gap_a), gap_b.numpy())
    qa = np.round(np.asarray(a.astype(jnp.float32)) * 255).astype(np.int32)
    qb = np.round(b.float().numpy() * 255).astype(np.int32)
    assert np.abs(qa - qb).max() <= 2


def test_forward_warp_noise_depth_window():
    """Noise depth gives every row a different, wide candidate window: the
    per-row window the kernel uses finds the XLA path's winners exactly."""
    rng = np.random.default_rng(1)
    img = fixtures.create_test_image(8, 128).astype(np.float32) / 255.0
    depth = rng.uniform(0, 255, (8, 128)).astype(np.float32)
    depth[:4] = np.linspace(0, 255, 128, dtype=np.float32)  # smooth rows
    a, gap_a = jwarp.forward_warp(jnp.asarray(img[None]), jnp.asarray(depth[None]),
                                  9.0, 0.0, 2.0, 0.5, impl="xla")
    b, gap_b = _port(img[None], depth[None], 9.0, 0.0, 2.0, 0.5)
    np.testing.assert_array_equal(np.asarray(gap_a), gap_b)
    np.testing.assert_array_equal(b, np.asarray(a))
    # the per-row windows really are narrower than the whole-batch one
    off = torch.from_numpy(np.array(jwarp.depth_ops.pixel_offsets(
        jnp.asarray(depth), 9.0, 0.0, 2.0, 0.5)))
    lo, hi = twk._window(off, 9)
    assert int((hi - lo).min()) < int(hi.max() - lo.min())


def test_forward_warp_single_channel():
    img, depth = _inputs()
    gray = np.ascontiguousarray(img[..., :1])
    a, gap_a = jwarp.forward_warp(jnp.asarray(gray[None]), jnp.asarray(depth[None]),
                                  3.0, 0.0, 2.0, 0.5, impl="xla")
    b, gap_b = _port(gray[None], depth[None], 3.0, 0.0, 2.0, 0.5)
    assert b.shape == (1, H, W, 1)
    np.testing.assert_array_equal(np.asarray(gap_a), gap_b)
    np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-5)


def test_warp_rows_checks_and_counter():
    off = torch.zeros(4, W)
    img = torch.zeros(4, W, 3)
    kw = dict(gradient_threshold=1.5, max_stretch=8, max_disp=6)
    with pytest.raises(TypeError):
        twk.warp_rows(off.double(), off, img, **kw)
    with pytest.raises(ValueError):
        twk.warp_rows(off, off, torch.zeros(4, W - 1, 3), **kw)
    with pytest.raises(TypeError):
        twk.warp_rows(off, off, img.half(), **kw)
    before = twk.LAUNCHES
    out, gap = twk.warp_rows(off, off, img, **kw)
    assert twk.LAUNCHES == before  # the plain version is not a launch
    assert out.shape == (4, W, 3) and gap.dtype == torch.bool
    # zero offsets: segment i covers [i, i+1), so only the last column is a gap
    assert not gap[:, :-1].any() and gap[:, -1].all()


def _rows(kind, w, div_px, sep_px, h=8, exponent=2.0):
    """(offset, nd, max_disp) of an [h, w] depth as ops/warp.forward_warp
    forms them."""
    if kind == "fixture":
        d = fixtures.create_depth_map(h, w).astype(np.float32)
    elif kind == "noise":
        d = np.random.default_rng(w).uniform(0, 255, (h, w)).astype(np.float32)
    else:
        d = np.full((h, w), 40.0, np.float32)
    nd = tdepth.normalize_depth(torch.from_numpy(d)[None])
    off = tdepth.pixel_offsets(nd, div_px, sep_px, exponent, 0.5, prenormalized=True)
    max_disp = int(np.ceil(0.5 ** exponent * abs(div_px) + abs(sep_px))) + 4
    return off[0].contiguous(), nd[0].contiguous(), max_disp


_PREFILTER_CASES = [(kind, w, sign * w * 0.045 * 10, sep_pct * w / 100.0)
                    for kind in ("fixture", "noise") for w in (64, 300, 7)
                    for sign in (1.0, -1.0) for sep_pct in (0.0, 1.0)]


@pytest.mark.parametrize("kind,w,div_px,sep_px", _PREFILTER_CASES)
def test_prefilter_drops_nothing(kind, w, div_px, sep_px):
    """Every (column, segment) pair that warp_rows_plain accepts lies in the
    segment's interval and in the window of the column's warp (divergence
    45% of the width, so windows are wide)."""
    off, nd, max_disp = _rows(kind, w, div_px, sep_px)
    lo, hi = model.segment_intervals(off, 1.5, 8)
    wlo, whi = model.warp_windows(off, lo, hi, max_disp)
    r = max_disp + 2
    segs, conn = twk._segments(off, nd, 1.5, r)
    d_lo, d_hi = twk._window(off, max_disp)
    cols = torch.arange(w)
    accepted = 0
    for d in range(-r, r + 1):
        ok = twk._candidate(segs, conn, d, r, 8)[0] & (d >= d_lo) & (d <= d_hi)
        i = (cols + d).clamp(0, w - 1)
        inside = ((lo[:, i] <= cols) & (cols <= hi[:, i])
                  & (wlo[:, cols // 32] <= d) & (d <= whi[:, cols // 32]))
        assert not bool((ok & ~inside).any()), d
        accepted += int(ok.sum())
    assert accepted > 0


def test_prefilter_interval_at_rounding_edges():
    """Segments starting on, just above and just below a column, and a
    denormal start at column 0 (where frac underflows to -0 and is
    accepted): the interval keeps every column the exact test accepts."""
    eps = np.float32(2.0 ** -23)
    base = np.array([0.0, 1.0, 1.0 + eps, 1.0 - eps / 2, 1e-45, -1e-45, 2.5, 3.0],
                    np.float32)
    off = torch.from_numpy(np.stack([base, -base, base * 0.5]))
    nd = torch.rand(off.shape, generator=torch.Generator().manual_seed(0))
    lo, hi = model.segment_intervals(off, 1.5, 8)
    r = 8
    segs, conn = twk._segments(off, nd, 1.5, r)
    cols = torch.arange(off.shape[-1])
    for d in range(-r, r + 1):
        ok = twk._candidate(segs, conn, d, r, 8)[0]
        i = (cols + d).clamp(0, off.shape[-1] - 1)
        assert not bool((ok & ~((lo[:, i] <= cols) & (cols <= hi[:, i]))).any()), d


@pytest.mark.parametrize("kind,w,div_px,sep_px", _PREFILTER_CASES[::2])
def test_walk_model_bit_equal_to_plain(kind, w, div_px, sep_px):
    """The float32 model of the kernel's column loop (warp window, interval
    test, exact tests inside the interval) gives warp_rows_plain's z-buffer
    bit for bit, and walks fewer candidates than the row window holds."""
    off, nd, max_disp = _rows(kind, w, div_px, sep_px)
    src, zbest = twk._zbuffer(off, nd, 1.5, 8, max_disp)
    m_src, m_z, walked, tested = model.walk_model(off, nd, 1.5, 8, max_disp)
    assert torch.equal(m_src, src) and torch.equal(m_z, zbest)
    lo, hi = twk._window(off, max_disp)
    assert bool((tested <= walked).all())
    assert float(walked.float().mean()) <= float((hi - lo + 1).float().mean())
    image = torch.rand(off.shape + (3,), generator=torch.Generator().manual_seed(1))
    out, gap = twk._finish(m_src, m_z, image, max_disp)
    want, want_gap = twk.warp_rows_plain(off, nd, image, 1.5, 8, max_disp)
    assert torch.equal(out, want) and torch.equal(gap, want_gap)


@pytest.mark.parametrize("exponent", [2.0, 1.7, 1.0])
@pytest.mark.parametrize("kind", ["fixture", "noise", "flat"])
def test_fused_plain_is_the_composition(kind, exponent):
    """warp_rows_fused (on the CPU, its plain version) equals normalize_depth
    -> pixel_offsets -> warp_rows_plain bit for bit, image by image."""
    h, w = 8, 64
    rows = []
    for k in ("fixture", kind):
        rows.append(fixtures.create_depth_map(h, w).astype(np.float32) if k == "fixture"
                    else _depth(k, h, w))
    depth = torch.from_numpy(np.concatenate(rows))
    dmin, dmax = torch.aminmax(depth.reshape(2, -1), dim=-1)
    image = torch.rand((2 * h, w, 3), generator=torch.Generator().manual_seed(2))
    kw = dict(gradient_threshold=1.5, max_stretch=8, max_disp=9)
    out, gap = twk.warp_rows_fused(depth, dmin, dmax, image, divergence_px=-6.0,
                                   separation_px=0.5, exponent=exponent,
                                   convergence_point=0.4, height=h, **kw)
    nd = tdepth.normalize_depth(depth.reshape(2, h, w))
    off = tdepth.pixel_offsets(nd, -6.0, 0.5, exponent, 0.4, prenormalized=True)
    want, want_gap = twk.warp_rows_plain(off.reshape(-1, w), nd.reshape(-1, w), image, **kw)
    assert torch.equal(out, want) and torch.equal(gap, want_gap)


def _depth(kind, h, w):
    if kind == "noise":
        return np.random.default_rng(3).uniform(0, 255, (h, w)).astype(np.float32)
    return np.full((h, w), 40.0, np.float32)


@pytest.mark.parametrize("kind,exponent,impl", [("flat", 2.0, "xla"), ("flat", 2.0, "pallas"),
                                                ("noise", 1.0, "xla")])
def test_forward_warp_fused_matches_jax(kind, exponent, impl):
    """forward_warp through the fused entry against JAX on flat depth (all
    offsets equal) and on noise depth with exponent 1 (PyTorch copies). On
    this noise depth JAX's own Pallas kernel and XLA path differ in colour
    (measured: 13 of 3072 pixels, up to 0.498); the port follows the XLA
    path, so noise is compared with it alone."""
    img, _ = _inputs()
    depth = _depth(kind, H, W)
    a, gap_a = jwarp.forward_warp(jnp.asarray(img[None]), jnp.asarray(depth[None]),
                                  4.0, 0.5, exponent, 0.5, impl=impl)
    b, gap_b = _port(img[None], depth[None], 4.0, 0.5, exponent, 0.5)
    np.testing.assert_array_equal(np.asarray(gap_a), gap_b)
    np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-5)


def test_shared_memory_rule():
    """20 B per column, one bit per column and 64 static bytes; the widest
    row whose planes fit in shared memory (wider ones take the workspace
    instances), and past the kernel's 65,536 columns a clear error before
    any launch (meta tensors stand for the card's: the check comes first)."""
    assert twk.smem_bytes(1920) == 20 * 1920 + 4 * 60 + 64 == 38704
    assert twk.SHARED_WIDTH == 11547
    assert (twk.smem_bytes(twk.SHARED_WIDTH) <= twk.SMEM_LIMIT
            < twk.smem_bytes(twk.SHARED_WIDTH + 1))
    assert twk.plane_words(16384) == 5 * 16384 + 512
    assert twk.MAX_WIDTH == 65536
    w = twk.MAX_WIDTH + 1
    rows = torch.empty((2, w), device="meta")
    image = torch.empty((2, w, 3), device="meta")
    lim = torch.empty((1,), device="meta")
    before = twk.LAUNCHES
    with pytest.raises(ValueError, match="65536 columns"):
        twk.warp_rows(rows, rows, image, gradient_threshold=1.5, max_stretch=8, max_disp=6)
    with pytest.raises(ValueError, match="65536 columns"):
        twk.warp_rows_fused(rows, lim, lim, image, divergence_px=3.0, separation_px=0.0,
                            exponent=2.0, convergence_point=0.5, gradient_threshold=1.5,
                            max_stretch=8, max_disp=6, height=2)
    assert twk.LAUNCHES == before


@pytest.mark.parametrize("exponent,mode", [(0.0, 0), (1.0, 1), (0.5, 2), (-0.5, 3), (-1.0, 4),
                                           (2.0, 5), (3.0, 6), (-2.0, 7), (1.7, 8),
                                           (2.0000000001, 5)])
def test_pow_mode(exponent, mode):
    """The fused kernels' pow takes ATen's CUDA branch for the exponent."""
    assert _common.pow_mode(exponent) == mode


def test_warp_rows_fused_checks_and_counter():
    depth = torch.zeros(4, W)
    lim = torch.zeros(2)
    image = torch.zeros(4, W, 3)
    kw = dict(divergence_px=3.0, separation_px=0.0, exponent=2.0, convergence_point=0.5,
              gradient_threshold=1.5, max_stretch=8, max_disp=6)
    with pytest.raises(ValueError, match="images of 3 rows"):
        twk.warp_rows_fused(depth, lim, lim, image, height=3, **kw)
    with pytest.raises(ValueError, match="dmin and dmax"):
        twk.warp_rows_fused(depth, torch.zeros(4)[::2], lim, image, height=2, **kw)
    with pytest.raises(ValueError, match="dmin and dmax"):
        twk.warp_rows_fused(depth, lim.double(), lim, image, height=2, **kw)
    with pytest.raises(TypeError):
        twk.warp_rows_fused(depth.double(), lim, lim, image, height=2, **kw)
    before = twk.LAUNCHES
    out, gap = twk.warp_rows_fused(depth, lim, lim, image, height=2, **kw)
    assert twk.LAUNCHES == before  # the plain version is not a launch
    # flat depth: every offset is -0.25 * 3 px, so only the last column is a gap
    assert out.shape == (4, W, 3) and not gap[:, :-1].any() and gap[:, -1].all()
