"""The port's backward-warp family (ops/backward_warp.py) and
fills.scatter_add_w against the JAX package's, on the same numpy inputs.

The JAX functions run eagerly (no caller jits them), as the port's do.
Stated tolerances: bit-equal, except where a stereo offset exponent other
than 1 is taken: eager XLA's `pow(x, 2.0)` is its approximate pow (1 ulp
off x*x on some values) where torch computes x*x, so offsets, and the
colours sampled at them, may differ by a few ulp (colours atol 1e-5, masks
on at most 0.5% of pixels, which a 1-ulp offset can move across a
threshold).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfystereo_tpu.ops import backward_warp as jbw
from comfystereo_tpu.ops import fills as jfills
from comfystereo_tpu.utils import fixtures
from comfystereo_tpu_torch.ops import backward_warp as bw
from comfystereo_tpu_torch.ops import fills

H, W = 40, 64


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = fixtures.create_test_image(H, W).astype(np.float32)[None] / 255.0
    depth = fixtures.create_depth_map(H, W).astype(np.float32)[None]
    img = np.concatenate([img, rng.random(img.shape, dtype=np.float32)])
    depth = np.concatenate([depth, 255.0 * rng.random(depth.shape, dtype=np.float32)])
    return img, depth


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, exact: bool, atol=1e-5):
    got = got.numpy()
    want = np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want)
    elif got.dtype == bool:
        assert (got != want).mean() <= 0.005
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


ARGS = [(5.0, 0.0, 1.0, 0.5), (-7.5, 2.0, 1.0, 0.3), (6.0, 1.0, 2.0, 0.5)]


@pytest.mark.parametrize("args", ARGS)
def test_backward_warp(args):
    img, depth = _inputs()
    got = bw.backward_warp(_t(img), _t(depth), *args)
    _close(got, jbw.backward_warp(jnp.asarray(img), jnp.asarray(depth), *args),
           exact=args[2] == 1.0)


@pytest.mark.parametrize("mode", ["border", "zeros", "reflection"])
@pytest.mark.parametrize("args", ARGS + [(0.0, 200.0, 1.0, 0.5), (-30.0, -90.0, 1.0, 0.7)])
def test_backward_warp_padded(mode, args):
    img, depth = _inputs()
    got, valid = bw.backward_warp_padded(_t(img), _t(depth), *args, fill_mode=mode)
    jgot, jvalid = jbw.backward_warp_padded(jnp.asarray(img), jnp.asarray(depth), *args,
                                            fill_mode=mode)
    exact = args[2] == 1.0
    _close(got, jgot, exact)
    _close(valid, jvalid, exact)


@pytest.mark.parametrize("args", ARGS)
@pytest.mark.parametrize("dilate", [1.5, 0.2])
def test_forward_gap_mask(args, dilate):
    _, depth = _inputs()
    got = bw.forward_gap_mask(_t(depth), *args, dilate_threshold=dilate)
    want = jbw.forward_gap_mask(jnp.asarray(depth), *args, dilate_threshold=dilate)
    assert got.any()
    _close(got, want, exact=args[2] == 1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_detect_disocclusions(seed):
    rng = np.random.default_rng(seed)
    depth01 = rng.random((2, 8, 48), dtype=np.float32)
    src = np.tile(np.arange(48, dtype=np.float32), (2, 8, 1))
    src = src + rng.normal(0, 2.0, src.shape).astype(np.float32)
    src[..., 20:] += 6.5
    src[0, 0, 5] = 7.5  # a tie at .5: both round half to even
    got = bw.detect_disocclusions(_t(depth01), _t(src), 0.05)
    want = jbw.detect_disocclusions(jnp.asarray(depth01), jnp.asarray(src), 0.05)
    assert got.any() and not got.all()
    _close(got, want, exact=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_interpolate_fill(seed):
    rng = np.random.default_rng(seed)
    img = rng.random((2, 6, 40, 3), dtype=np.float32)
    mask = rng.random((2, 6, 40)) < 0.4
    mask[0, 0, :5] = True      # masked up to the left border
    mask[0, 1, -7:] = True     # masked up to the right border
    mask[1, 2] = True          # a whole row masked
    got = bw.interpolate_fill(_t(img), _t(mask))
    _close(got, jbw.interpolate_fill(jnp.asarray(img), jnp.asarray(mask)), exact=True)


@pytest.mark.parametrize("args", ARGS)
@pytest.mark.parametrize("stretch", [3, 0])
def test_warp_and_fill(args, stretch):
    img, depth = _inputs()
    got, gap = bw.warp_and_fill(_t(img), _t(depth), *args, stretch_pixels=stretch)
    jgot, jgap = jbw.warp_and_fill(jnp.asarray(img), jnp.asarray(depth), *args,
                                   stretch_pixels=stretch)
    exact = args[2] == 1.0
    _close(gap, jgap, exact)
    if exact:
        _close(got, jgot, True)
    else:  # a gap pixel that moved samples another column
        assert (np.abs(got.numpy() - np.asarray(jgot)) > 1e-5).mean() <= 0.005


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_add_w(seed):
    rng = np.random.default_rng(seed)
    dest = rng.integers(-5, 45, (3, 4, 40)).astype(np.int32)
    valid = (dest >= 0) & (dest < 40) & (rng.random(dest.shape) < 0.9)
    values = valid.astype(np.float32)
    got = fills.scatter_add_w(_t(dest), _t(values), _t(valid), 40)
    want = jfills.scatter_add_w(jnp.asarray(dest), jnp.asarray(values), jnp.asarray(valid), 40)
    _close(got, want, exact=True)
    assert float(got.sum()) == float(valid.sum())
