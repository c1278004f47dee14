"""Port's edge-distance plain version and depth blur vs the JAX package.

Stated tolerances: the distance transform, Sobel, the edge masks and the
box blurs are bit-equal. The distance weights are not: XLA's CPU `pow`
with a traced exponent is an approximation, not `x*x` (measured: up to 6e-8
absolute, 12 ulp on small weights), so the weights in [0, 1] are held to
atol 1e-6 and the directional blur to atol 1e-4 in the 0-255 domain, the
bound of tests/test_blur.py (measured: 3.1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfystereo_tpu.ops import blur as jblur
from comfystereo_tpu.pallas.distance import edge_distances as jax_edge_distances
from comfystereo_tpu.utils import fixtures
from comfystereo_tpu_torch.kernels import distance as tdist
from comfystereo_tpu_torch.ops import blur as tblur

H, W = 48, 64


def _depth255(b=2, h=H, w=W, seed=0):
    _, d = fixtures.batch_fixture(b, h, w, seed=seed)
    return (d * 255.0).astype(np.float32)


def _edge_masks(d):
    grad = jblur.sobel_x(jnp.asarray(d))
    edge_str = jnp.clip(jnp.abs(grad) / (10.0 * jnp.float32(20.0)), 0.0, 1.0)
    return (np.asarray((grad > 0) & (edge_str > 0.5)),
            np.asarray((grad < 0) & (edge_str > 0.5)))


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_distances_plain_bit_equal_to_pallas(seed):
    rng = np.random.default_rng(seed)
    ml = rng.random((20, W)) < 0.05
    mr = rng.random((20, W)) < 0.02
    ml[3] = False                 # rows with no edge in one mask ...
    mr[5:7] = False
    ml[8], mr[8] = False, False   # ... and in both
    ml[9, :] = True
    dl, dr = jax_edge_distances(jnp.asarray(ml), jnp.asarray(mr), w=W,
                                interpret=True)
    tl, tr = tdist.edge_distances(_t(ml), _t(mr))  # CPU -> plain version
    np.testing.assert_array_equal(np.asarray(dl), tl.numpy())
    np.testing.assert_array_equal(np.asarray(dr), tr.numpy())


def test_edge_distances_plain_on_real_edges():
    ml, mr = _edge_masks(_depth255())
    ml, mr = ml.reshape(-1, W), mr.reshape(-1, W)
    dl, dr = jax_edge_distances(jnp.asarray(ml), jnp.asarray(mr), w=W,
                                interpret=True)
    tl, tr = tdist.edge_distances_plain(_t(ml), _t(mr))
    np.testing.assert_array_equal(np.asarray(dl), tl.numpy())
    np.testing.assert_array_equal(np.asarray(dr), tr.numpy())


def test_edge_distances_wrapper_checks():
    m = torch.zeros(4, W, dtype=torch.bool)
    with pytest.raises(TypeError):
        tdist.edge_distances(m.float(), m.float())
    with pytest.raises(ValueError):
        tdist.edge_distances(m, torch.zeros(4, W + 1, dtype=torch.bool))
    with pytest.raises(ValueError):
        tdist.edge_distances(m[:, ::2], m[:, ::2])
    before = tdist.LAUNCHES
    tdist.edge_distances(m, m)
    assert tdist.LAUNCHES == before  # the plain version is not a launch


def test_sobel_and_edge_masks_bit_equal():
    d = _depth255()
    np.testing.assert_array_equal(np.asarray(jblur.sobel_x(jnp.asarray(d))),
                                  tblur.sobel_x(_t(d)).numpy())
    jl, jr = _edge_masks(d)
    grad = tblur.sobel_x(_t(d))
    edge_str = torch.clamp(grad.abs() / 200.0, 0.0, 1.0)
    np.testing.assert_array_equal(jl, ((grad > 0) & (edge_str > 0.5)).numpy())
    np.testing.assert_array_equal(jr, ((grad < 0) & (edge_str > 0.5)).numpy())


@pytest.mark.parametrize("n", [2, 3, 5, 20])
def test_box_blur_w_bit_equal(n):
    d = _depth255()
    np.testing.assert_array_equal(np.asarray(jblur.box_blur_w(jnp.asarray(d), n)),
                                  tblur.box_blur_w(_t(d), n).numpy())


@pytest.mark.parametrize("radius", [1, 6])
def test_box_blur_h_bit_equal(radius):
    d = _depth255()
    np.testing.assert_array_equal(np.asarray(jblur.box_blur_h(jnp.asarray(d), radius)),
                                  tblur.box_blur_h(_t(d), radius).numpy())


def test_edge_weights_match():
    """edge_distance_weight (mask_radius+1 convention) and the weights from
    the distance transform (1e9 convention) agree with JAX and each other."""
    ml, mr = _edge_masks(_depth255())
    jfn = jax.jit(lambda m, f: jblur.edge_distance_weight(m, 20, f))
    want = np.asarray(jfn(jnp.asarray(ml), jnp.float32(2.0)))
    got = tblur.edge_distance_weight(_t(ml), 20, 2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    pair_l, pair_r = tblur._edge_weights_pair(_t(ml), _t(mr), 20, 2.0)
    np.testing.assert_array_equal(pair_l.numpy(), got)
    np.testing.assert_array_equal(
        pair_r.numpy(), tblur.edge_distance_weight(_t(mr), 20, 2.0).numpy())


@pytest.mark.parametrize("kwargs", [
    dict(blur_strength=20, edge_threshold=20, blur_mask_width=20,
         falloff_exponent=2.0, vert_smooth_px=6),
    dict(blur_strength=5, edge_threshold=6, blur_mask_width=5,
         falloff_exponent=1.0, vert_smooth_px=0),
])
def test_directional_motion_blur_matches(kwargs):
    d = _depth255()
    jl, jr = jblur.directional_motion_blur(jnp.asarray(d), **kwargs)
    tl, tr = tblur.directional_motion_blur(_t(d), **kwargs)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-4)


def test_blur_zero_strength_identity():
    d = _t(_depth255())
    gl, gr = tblur.directional_motion_blur(d, 0.0, 20.0)
    assert gl is d and gr is d
