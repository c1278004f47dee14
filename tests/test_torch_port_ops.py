"""Port's depth, scan and pack ops vs the JAX package: bit-equal.

The depth functions are compared with their jitted JAX form, as
stereo_pipeline runs them: under jit a constant exponent of 2 (the default)
folds to x*x, which is what torch.pow computes; eager JAX evaluates XLA's
approximate pow instead, 1 ulp off x*x in about 0.07% of values. Other
exponents (0.5, 1.7) go through XLA's pow on one side and torch's sqrt or
pow on the other, and are held to 1 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfystereo_tpu.ops import depth as jdepth
from comfystereo_tpu.ops import pack as jpack
from comfystereo_tpu.ops import scan as jscan
from comfystereo_tpu.utils import fixtures
from comfystereo_tpu_torch.config import MODES
from comfystereo_tpu_torch.ops import depth as tdepth
from comfystereo_tpu_torch.ops import pack as tpack
from comfystereo_tpu_torch.ops import scan as tscan

B, H, W = 2, 48, 64


def _depths():
    _, d = fixtures.batch_fixture(B, H, W, seed=3)
    d = d * 255.0
    d[1, :4] = 0.0  # a few extreme values
    flat = np.full((1, H, W), 7.0, np.float32)  # flat map -> all zeros
    return np.concatenate([d, flat]).astype(np.float32)


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


def test_normalize_depth_bit_equal():
    d = _depths()
    _eq(jdepth.normalize_depth(jnp.asarray(d)),
        tdepth.normalize_depth(torch.from_numpy(d)))


@pytest.mark.parametrize("exponent", [2.0, 1.0, 0.5, 1.7])
def test_signed_power_and_offsets_bit_equal(exponent):
    nd = np.array(jdepth.normalize_depth(jnp.asarray(_depths())))
    x = nd - 0.5
    pairs = [
        (jax.jit(lambda v: jdepth.signed_power(v, exponent))(jnp.asarray(x)),
         tdepth.signed_power(torch.from_numpy(x), exponent)),
        (jax.jit(lambda v: jdepth.depth_offsets(v, 0.4, exponent))(jnp.asarray(nd)),
         tdepth.depth_offsets(torch.from_numpy(nd), 0.4, exponent)),
    ]
    for want, got in pairs:
        if exponent in (0.5, 1.7):
            np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), 1)
        else:
            _eq(want, got)


@pytest.mark.parametrize("div_px,sep_px", [(2.88, 0.0), (-2.88, 0.64), (5.0, -1.0)])
def test_pixel_offsets_bit_equal(div_px, sep_px):
    d = _depths()
    fn = jax.jit(lambda v: jdepth.pixel_offsets(v, div_px, sep_px, 2.0, 0.5))
    _eq(fn(jnp.asarray(d)),
        tdepth.pixel_offsets(torch.from_numpy(d), div_px, sep_px, 2.0, 0.5))
    nd = jdepth.normalize_depth(jnp.asarray(d))
    fn = jax.jit(lambda v: jdepth.pixel_offsets(v, div_px, sep_px, 2.0, 0.5,
                                                prenormalized=True))
    _eq(fn(nd), tdepth.pixel_offsets(torch.from_numpy(np.array(nd)), div_px,
                                     sep_px, 2.0, 0.5, prenormalized=True))


def test_percent_to_px_equal():
    assert tdepth.percent_to_px(4.5, 1.0, 1920) == jdepth.percent_to_px(4.5, 1.0, 1920)


def _masks():
    rng = np.random.default_rng(7)
    m = rng.random((6, W)) < 0.1
    m[0] = False          # row without any True
    m[1] = True           # all True
    m[2, :] = False
    m[2, -1] = True       # only the last column
    m[3, :] = False
    m[3, 0] = True        # only the first column
    return m


def test_nearest_true_left_right_bit_equal():
    m = _masks()
    _eq(jscan.nearest_true_left(jnp.asarray(m)),
        tscan.nearest_true_left(torch.from_numpy(m)))
    _eq(jscan.nearest_true_right(jnp.asarray(m)),
        tscan.nearest_true_right(torch.from_numpy(m)))


def test_forward_fill_bit_equal():
    """Including the positions before a row's first valid entry, which take
    the row's first value in both packages."""
    m = _masks()
    rng = np.random.default_rng(8)
    a = rng.normal(size=m.shape).astype(np.float32)
    b = rng.normal(size=m.shape).astype(np.float32)
    (ja, jb), jh = jscan.forward_fill((jnp.asarray(a), jnp.asarray(b)), jnp.asarray(m))
    (ta, tb), th = tscan.forward_fill((torch.from_numpy(a), torch.from_numpy(b)),
                                      torch.from_numpy(m))
    _eq(ja, ta)
    _eq(jb, tb)
    _eq(jh, th)


def test_backward_fill_bit_equal():
    """Including the positions after a row's last valid entry, which take
    the row's last value in both packages."""
    m = _masks()
    a = np.random.default_rng(10).normal(size=m.shape).astype(np.float32)
    (ja,), jh = jscan.backward_fill((jnp.asarray(a),), jnp.asarray(m))
    (ta,), th = tscan.backward_fill((torch.from_numpy(a),), torch.from_numpy(m))
    _eq(ja, ta)
    _eq(jh, th)


@pytest.mark.parametrize("mode", MODES)
def test_pack_mode_bit_equal(mode):
    rng = np.random.default_rng(9)
    left = rng.random((B, H, W, 3)).astype(np.float32)
    right = rng.random((B, H, W, 3)).astype(np.float32)
    _eq(jpack.pack_mode(jnp.asarray(left), jnp.asarray(right), mode),
        tpack.pack_mode(torch.from_numpy(left), torch.from_numpy(right), mode))


def test_pack_mode_unknown_raises():
    x = torch.zeros(1, 2, 2, 3)
    with pytest.raises(ValueError):
        tpack.pack_mode(x, x, "diagonal")
