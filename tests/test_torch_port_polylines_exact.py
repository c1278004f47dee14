"""Port's exact polylines (plain version on the CPU) vs the JAX package's XLA
path (`apply_polylines_exact(impl="xla")`), which the JAX package's own tests
hold bit-equal to its Pallas kernel.

Stated tolerance: uint8 bit-equal, sharp and soft, on fixture, fold-heavy
and uniform-noise depth (measured: bit-equal in every case).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfystereo_tpu.ops import depth as jdepth
from comfystereo_tpu.ops import polylines_exact as jpe
from comfystereo_tpu.utils import fixtures
from comfystereo_tpu_torch.kernels import polylines_exact as tkpe
from comfystereo_tpu_torch.ops import depth as tdepth
from comfystereo_tpu_torch.ops import polylines_exact as tpe


def _depth(kind, h, w, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "fixture":
        return fixtures.create_depth_map(h, w).astype(np.float32)
    if kind == "fold":  # tests/test_polylines_exact_kernel.py's fold-heavy depth
        return (np.where(np.arange(w)[None, :] % 13 < 6, 255.0, 40.0) * np.ones((h, 1))
                + rng.uniform(0, 40, (h, w))).astype(np.float32)
    return rng.uniform(0, 255, (h, w)).astype(np.float32)


def _run_both(h, w, sharp, div, sep, depth):
    img = fixtures.create_test_image(h, w).astype(np.float32)[None]
    div_px, sep_px = (div / 100.0) * w, (sep / 100.0) * w
    jnd = jdepth.normalize_depth(jnp.asarray(depth[None])) - 0.5
    want = np.asarray(jpe.apply_polylines_exact(jnp.asarray(img), jnd, div_px, sep_px,
                                                2.0, sharp=sharp, impl="xla"))
    tnd = tdepth.normalize_depth(torch.from_numpy(depth[None])) - 0.5
    got = tpe.apply_polylines_exact(torch.from_numpy(img), tnd, div_px, sep_px, 2.0,
                                    sharp=sharp)
    assert got.shape == (1, h, w, 3) and got.dtype == torch.float32
    return got.numpy().astype(np.uint8), want.astype(np.uint8)


@pytest.mark.parametrize("sharp", [True, False])
@pytest.mark.parametrize("div,sep,kind", [(4.5, 0.0, "fixture"), (-4.5, 0.0, "fixture"),
                                          (7.0, 1.5, "fold"), (-7.0, 1.5, "noise")])
def test_exact_bit_equal_to_xla_24x56(sharp, div, sep, kind):
    got, want = _run_both(24, 56, sharp, div, sep, _depth(kind, 24, 56))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sharp", [True, False])
def test_exact_bit_equal_to_xla_48x64(sharp):
    got, want = _run_both(48, 64, sharp, 4.5, 1.5, _depth("fold", 48, 64, seed=1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sharp", [True, False])
def test_row_windows_match_whole_window(sharp):
    """Rows of flat, fold-heavy and ramp depth in one frame: the per-row
    windows of the plain version (and the kernel) are narrower than the XLA
    path's 64-row window, and the output is the same."""
    h, w = 12, 64
    depth = _depth("fold", h, w, seed=3)
    depth[:4] = 128.0
    depth[8:] = np.linspace(0, 255, w, dtype=np.float32)[None]
    got, want = _run_both(h, w, sharp, 7.0, 0.0, depth)
    np.testing.assert_array_equal(got, want)
    nd = tdepth.normalize_depth(torch.from_numpy(depth[None])) - 0.5
    x = (torch.arange(w, dtype=torch.float32) + 0.5
         + tdepth.signed_power(nd, 2.0)[0] * (0.07 * w))
    lo, hi = tkpe.window(x, int(np.ceil(0.07 * w)) + 4)
    assert int((hi - lo).min()) < int(hi.max() - lo.min())


def test_plain_skips_no_piece_a_pixel_reaches():
    """Skipping pieces that no pixel reaches leaves the result unchanged:
    the same rows rendered with 12 and with 40 pieces agree."""
    depth = _depth("noise", 6, 48, seed=4)
    nd = tdepth.normalize_depth(torch.from_numpy(depth[None])) - 0.5
    img = torch.from_numpy(fixtures.create_test_image(6, 48).astype(np.float32)[None])
    a = tpe.apply_polylines_exact(img, nd, 3.0, 0.0, 2.0, sharp=True, max_pieces=12)
    b = tpe.apply_polylines_exact(img, nd, 3.0, 0.0, 2.0, sharp=True, max_pieces=40)
    assert torch.equal(a, b)


def test_wrapper_rejects_bad_arguments():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        tkpe.polylines_exact_rows(x, x, torch.zeros(2, 7, 3), sharp=True,
                                  max_pieces=12, max_disp=4)
    with pytest.raises(TypeError):
        tkpe.polylines_exact_rows(x, x, torch.zeros(2, 8, 3, dtype=torch.float64),
                                  sharp=True, max_pieces=12, max_disp=4)
