"""Port's supersampled polylines (`polylines_exact=False`) vs the JAX package.

Stated tolerances:
- `running_max` / `running_min`: bit-equal (max and min are exact).
- The twin, `apply_polylines(impl="twin")`, against JAX's
  `apply_polylines(impl="xla")`: uint8 bit-equal (measured: bit-equal in
  every case, samples 4, 6 and 8, widths 56 and 1100).
- The kernel's plain version, `polylines_scanline_plain`, against JAX's
  Pallas kernel `polylines_scanline(..., interpret=True)` on the same rows:
  the colour sums differ by at most 5e-4 and the uint8 finish is equal.
  Cause: XLA's CPU compiler fuses `a * (1 - ip) + b * ip` in the
  interpret-mode program into fma(a, 1 - ip, b * ip), one rounding fewer.
  With that contraction emulated in the plain version the sums are
  bit-equal (measured: 4 and 34 of 6720 sums differ by 1-2 ulp without it,
  none with it; at 8x1100, 24 without, none with).
- The kernel route against the twin, both in the port: the JAX package's
  own bound for its kernel against its twin (tests/test_polylines_kernel.py):
  mean |err| < 0.05 and < 0.1% of values off by more than 1 LSB. It does
  not hold on rows whose offsets lie on the sample grid, where JAX's kernel
  and twin themselves differ (test_kernel_and_twin_differ_on_sample_grid_ties).
- `apply_stereo_divergence` with `polylines_exact_mode=False`: polylines
  fills bit-equal in uint8 to JAX's jitted dispatcher; hybrid_edge_plus to
  the hybrid fills' bound (1 LSB on at most 1% of values: the hybrid base
  differs, test_torch_port_fills.py; its backfill is the twin, bit-equal
  above).

The Pallas kernel in interpret mode costs about 30 s per call at 40x56 (and
at 8x56) on a CPU, so this file makes three such calls, each once; the
blocked width (8x1100, over 80 s a call) is marked slow.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfystereo_tpu import pipeline as jpipe
from comfystereo_tpu.ops import depth as jdepth
from comfystereo_tpu.ops import polylines as jpoly
from comfystereo_tpu.ops import scan as jscan
from comfystereo_tpu.pallas.polylines_kernel import polylines_scanline as jax_scanline
from comfystereo_tpu.utils import fixtures
from comfystereo_tpu_torch import pipeline as tpipe
from comfystereo_tpu_torch.kernels import polylines as tkp
from comfystereo_tpu_torch.ops import depth as tdepth
from comfystereo_tpu_torch.ops import polylines as tpoly
from comfystereo_tpu_torch.ops import scan as tscan
from tests.oracle import stereo_oracle as oracle


def _depth(kind, h, w, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "fixture":
        return fixtures.create_depth_map(h, w).astype(np.float32)
    if kind == "fold":  # tests/test_polylines_exact_kernel.py's fold-heavy depth
        return (np.where(np.arange(w)[None, :] % 13 < 6, 255.0, 40.0) * np.ones((h, 1))
                + rng.uniform(0, 40, (h, w))).astype(np.float32)
    return rng.uniform(0, 255, (h, w)).astype(np.float32)


def _image(h, w):
    return fixtures.create_test_image(h, w).astype(np.float32)[None]


def _twin_and_jax(h, w, sharp, div, sep, samples, kind):
    img, depth = _image(h, w), _depth(kind, h, w)[None]
    div_px, sep_px = (div / 100.0) * w, (sep / 100.0) * w
    jnd = jdepth.normalize_depth(jnp.asarray(depth)) - 0.5
    want = np.asarray(jpoly.apply_polylines(jnp.asarray(img), jnd, div_px, sep_px, 2.0,
                                            sharp=sharp, samples=samples, impl="xla"))
    tnd = tdepth.normalize_depth(torch.from_numpy(depth)) - 0.5
    got = tpoly.apply_polylines(torch.from_numpy(img), tnd, div_px, sep_px, 2.0,
                                sharp=sharp, samples=samples, impl="twin")
    assert got.shape == (1, h, w, 3) and got.dtype == torch.float32
    return got.numpy().astype(np.uint8), want.astype(np.uint8)


def test_running_max_min_bit_equal():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 33)).astype(np.float32)
    x[..., ::4] = -1e30
    x[1, 2, 5:9] = 0.25  # ties
    for jf, tf in ((jscan.running_max, tscan.running_max),
                   (jscan.running_min, tscan.running_min)):
        np.testing.assert_array_equal(tf(torch.from_numpy(x)).numpy(),
                                      np.asarray(jf(jnp.asarray(x))))


@pytest.mark.parametrize("h,w,sharp,div,sep,samples,kind", [
    (24, 56, True, 4.5, 0.0, 8, "fixture"),
    (24, 56, True, -4.5, 0.0, 8, "fixture"),
    (24, 56, False, 4.5, 0.0, 8, "fixture"),
    (24, 56, False, -4.5, 0.0, 8, "fixture"),
    (24, 56, True, 7.0, 1.5, 8, "fold"),
    (24, 56, False, -7.0, 1.5, 8, "noise"),
    (24, 56, True, 4.5, 0.0, 4, "fixture"),
    (8, 1100, True, 4.5, 0.0, 8, "fixture"),
    (8, 1100, False, -4.5, 1.0, 8, "noise"),
])
def test_twin_bit_equal_to_xla(h, w, sharp, div, sep, samples, kind):
    got, want = _twin_and_jax(h, w, sharp, div, sep, samples, kind)
    np.testing.assert_array_equal(got, want)


def _rows(h, w, div, sep=0.0, kind="fixture"):
    """The kernel's row arguments as ops/polylines.py computes them."""
    depth = _depth(kind, h, w)[None]
    div_px, sep_px = (div / 100.0) * w, (sep / 100.0) * w
    nd = tdepth.normalize_depth(torch.from_numpy(depth)) - 0.5
    coord = (tdepth.signed_power(nd, 2.0) * div_px)[0]
    x = torch.arange(w, dtype=torch.float32) + 0.5 + coord + sep_px
    max_disp = int(np.ceil(abs(div_px) + abs(sep_px))) + 4
    return x, coord, torch.from_numpy(_image(h, w)[0]), max_disp


def _lerp_contracted(a, b, ip):
    """a * (1 - ip) + b * ip with the first product fused into the sum (one
    rounding), emulated in float64, where products of float32 are exact."""
    return (a.double() * (1.0 - ip).double() + (b * ip).double()).float()


def _plain_and_pallas(h, w, sharp, div, sep=0.0):
    x, coord, img, max_disp = _rows(h, w, div, sep)
    kw = dict(sharp=sharp, samples=8, k_candidates=4, max_disp=max_disp)
    want = jax_scanline(jnp.asarray(x.numpy()), jnp.asarray(coord.numpy()),
                        *(jnp.asarray(img[..., i].numpy()) for i in range(3)), w=w,
                        interpret=True, **kw)
    want = np.stack([np.asarray(v) for v in want], -1)
    got = tkp.polylines_scanline_plain(x, coord, img, **kw).numpy()
    orig = tkp._lerp
    tkp._lerp = _lerp_contracted
    try:
        contracted = tkp.polylines_scanline_plain(x, coord, img, **kw).numpy()
    finally:
        tkp._lerp = orig
    return got, contracted, want


@pytest.fixture(scope="module")
def pallas_40x56():
    """Plain version and Pallas kernel (interpret mode) at 40x56, sharp at
    +4.5% and soft at -4.5%: each interpret call once per module."""
    return {"sharp": _plain_and_pallas(40, 56, True, 4.5),
            "soft": _plain_and_pallas(40, 56, False, -4.5)}


def test_kernel_and_twin_differ_on_sample_grid_ties():
    """Rows of one offset on the 1/8 sample grid (-1.4375 px here; -8.4375
    px on the 1080p fixture at divergence 4.5%) put a sample exactly on a
    point, where neither group covers it. JAX's kernel then takes a found
    group's left colour (its `neither` fallback), JAX's twin the positive
    group's, black where that group found nothing: the twin's rows come out
    about 1/8 darker. The port reproduces each: its kernel route equals JAX's
    Pallas kernel (interpret mode) in uint8, its twin JAX's XLA path."""
    h, w = 8, 56
    img = _image(h, w)
    nd = np.full((1, h, w), -0.3125, np.float32)
    nd[:, 2:5, 20:30] = 0.5
    args = (14.72, 0.0, 2.0)  # 0.3125**2 * 14.72 = 1.4375
    want = {impl: np.asarray(jpoly.apply_polylines(jnp.asarray(img), jnp.asarray(nd), *args,
                                                   sharp=False, impl=impl))
            for impl in ("xla", "pallas")}
    got = {impl: tpoly.apply_polylines(torch.from_numpy(img), torch.from_numpy(nd), *args,
                                       sharp=False, impl=impl).numpy()
           for impl in ("twin", "kernel")}
    np.testing.assert_array_equal(got["twin"], want["xla"])
    np.testing.assert_array_equal(got["kernel"], want["pallas"])
    gap = (got["kernel"] - got["twin"]).mean()
    print(f"kernel route - twin on sample-grid ties: mean {gap:.4f} LSB")
    assert gap > 1.0


def _check_plain_vs_pallas(got, contracted, want):
    np.testing.assert_array_equal(contracted, want)
    assert np.abs(got - want).max() <= 5e-4
    np.testing.assert_array_equal(np.trunc(np.clip(got / 8 + 0.5, 0, 255)),
                                  np.trunc(np.clip(want / 8 + 0.5, 0, 255)))


def test_kernel_route_nearer_reference_on_sample_grid_ties():
    """Rows 600, 650 and 700 of the 1080p fixture, polylines_soft at 4.5%,
    against the reference's numpy renderer (tests/oracle). Row 650's flat
    depth puts its offset (-8.4375 px) on the sample grid: there the twin
    is about 1/8 darker than the reference and the kernel route is not; on
    the other rows both are close. The numbers are printed (pytest -s)."""
    h, w, rows = 1080, 1920, [600, 650, 700]
    full = fixtures.create_depth_map(h, w).astype(np.float32)
    depth = full[rows + [0]]
    depth[-1, :2] = full.min(), full.max()  # keep the frame's normalisation
    img = fixtures.create_test_image(h, w).astype(np.float32)[rows + [0]]
    ref = oracle.dispatch(img.astype(np.uint8), depth, 4.5, 0.0, 2.0, "polylines_soft",
                          0.5)[:3].astype(np.float64)
    nd = tdepth.normalize_depth(torch.from_numpy(depth[None])) - 0.5
    err = {}
    for impl in ("kernel", "twin"):
        out = tpoly.apply_polylines(torch.from_numpy(img[None]), nd, 0.045 * w, 0.0, 2.0,
                                    sharp=False, impl=impl).numpy()[0, :3]
        err[impl] = np.abs(out - ref).mean(axis=(1, 2))
        print(f"{impl} vs reference, mean |err| per row {dict(zip(rows, err[impl]))}")
    assert err["kernel"].max() < 0.1
    assert err["twin"][1] > 10.0 and max(err["twin"][0], err["twin"][2]) < 0.1


@pytest.mark.parametrize("mode", ["sharp", "soft"])
def test_plain_matches_pallas_kernel(pallas_40x56, mode):
    _check_plain_vs_pallas(*pallas_40x56[mode])


@pytest.mark.slow
@pytest.mark.parametrize("sharp,div,sep", [(True, 4.5, 0.0), (False, -4.5, 1.0)])
def test_plain_matches_pallas_kernel_blocked_width(sharp, div, sep):
    """At 1100 columns the Pallas kernel splits each row into column blocks
    with halos; the plain version's whole rows give the same sums."""
    _check_plain_vs_pallas(*_plain_and_pallas(8, 1100, sharp, div, sep))


@pytest.mark.parametrize("h,w", [(40, 56), (8, 1100)])
@pytest.mark.parametrize("sharp,div", [(True, 4.5), (False, -4.5), (True, -4.5)])
def test_kernel_route_near_twin(h, w, sharp, div):
    img, depth = _image(h, w), _depth("fixture", h, w)[None]
    nd = tdepth.normalize_depth(torch.from_numpy(depth)) - 0.5
    outs = [tpoly.apply_polylines(torch.from_numpy(img), nd, (div / 100.0) * w, 0.0, 2.0,
                                  sharp=sharp, impl=impl).numpy()
            for impl in ("twin", "kernel")]
    err = np.abs(outs[0] - outs[1])
    assert err.mean() < 0.05, err.mean()
    assert (err > 1).mean() < 0.001


def test_plain_channels_independent():
    """The sums of one channel do not depend on the others, so the kernel
    takes 1 to 3 channels without padding to three planes."""
    x, coord, img, max_disp = _rows(6, 64, 6.0, kind="noise")
    kw = dict(sharp=True, samples=8, k_candidates=4, max_disp=max_disp)
    full = tkp.polylines_scanline_plain(x, coord, img, **kw)
    one = tkp.polylines_scanline_plain(x, coord, img[..., 1:2].contiguous(), **kw)
    assert torch.equal(one[..., 0], full[..., 1])


def test_auto_dispatch_on_cpu_is_twin(monkeypatch):
    """On the CPU `auto` takes the twin (no call of the kernel's wrapper);
    `kernel` takes the wrapper, which runs the plain version and counts no
    launch; an unknown impl raises."""
    img, depth = _image(8, 48), _depth("fold", 8, 48)[None]
    nd = tdepth.normalize_depth(torch.from_numpy(depth)) - 0.5
    calls = []

    def spy(*args, **kw):
        calls.append(kw)
        return tkp.polylines_scanline(*args, **kw)

    monkeypatch.setattr(tpoly, "polylines_scanline", spy)
    args = (torch.from_numpy(img), nd, 3.0, 0.5, 2.0)
    auto = tpoly.apply_polylines(*args, impl="auto")
    assert calls == [] and torch.equal(auto, tpoly.apply_polylines(*args, impl="twin"))
    before = tkp.LAUNCHES
    tpoly.apply_polylines(*args, impl="kernel")
    assert len(calls) == 1 and calls[0]["samples"] == 8 and tkp.LAUNCHES == before
    with pytest.raises(ValueError, match="impl"):
        tpoly.apply_polylines(*args, impl="pallas")


@functools.lru_cache(maxsize=None)
def _jax_dispatch():
    return jax.jit(jpipe.apply_stereo_divergence, static_argnums=(2, 3, 4, 5, 6, 7, 8))


@pytest.mark.parametrize("fill,samples,div,sep", [
    ("polylines_sharp", 8, 4.5, 0.0), ("polylines_soft", 8, -4.5, 1.5),
    ("polylines_sharp", 4, 8.0, -1.0), ("hybrid_edge_plus", 8, 4.5, 0.0),
])
def test_apply_stereo_divergence_legacy_matches_jax(fill, samples, div, sep):
    h, w = 24, 56
    img, depth = _image(h, w), _depth("fixture", h, w)[None]
    args = (div, sep, 2.0, fill, 0.5, samples, False)
    want = np.asarray(_jax_dispatch()(jnp.asarray(img), jnp.asarray(depth), *args))
    got = tpipe.apply_stereo_divergence(torch.from_numpy(img), torch.from_numpy(depth),
                                        *args).numpy()
    if fill == "hybrid_edge_plus":
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    else:
        np.testing.assert_array_equal(got, want)


def test_wrapper_rejects_bad_arguments():
    x = torch.zeros(2, 8)
    kw = dict(sharp=True, samples=8, k_candidates=4, max_disp=4)
    with pytest.raises(ValueError):
        tkp.polylines_scanline(x, x, torch.zeros(2, 7, 3), **kw)
    with pytest.raises(TypeError):
        tkp.polylines_scanline(x, x, torch.zeros(2, 8, 3, dtype=torch.float64), **kw)
    with pytest.raises(TypeError):
        tkp.polylines_scanline(x.double(), x.double(), torch.zeros(2, 8, 3), **kw)
    with pytest.raises(ValueError):
        tkp.polylines_scanline(x, torch.zeros(2, 9), torch.zeros(2, 8, 3), **kw)
    with pytest.raises(ValueError):
        tkp.polylines_scanline(x, x, torch.zeros(2, 8, 3), **dict(kw, samples=0))
