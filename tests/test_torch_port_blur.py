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
    w = ml.shape[-1]
    dl, dr = tdist.edge_distances(_t(ml).reshape(-1, w), _t(mr).reshape(-1, w))
    pair_l = tblur.distance_weight(dl.reshape(ml.shape), 20, 2.0)
    pair_r = tblur.distance_weight(dr.reshape(mr.shape), 20, 2.0)
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


def _ballot_distances(mask):
    """A model of csrc/distance.cu's search on [N, W] bool: 32-column words
    of mask bits, the last set column up to each word and the first from
    each word on (the scans), then per column its own word or one lookup."""
    n, w = mask.shape
    g = (w + 31) // 32
    bits = np.zeros((n, g * 32), bool)
    bits[:, :w] = mask
    words = bits.reshape(n, g, 32)
    lane = np.arange(32)
    last_in = np.where(words.any(-1), np.where(words, lane, -1).max(-1), -1)
    first_in = np.where(words.any(-1), np.where(words, lane, 99).min(-1), 99)
    base = np.arange(g) * 32
    last = np.maximum.accumulate(np.where(last_in >= 0, base + last_in, -1), axis=1)
    first = np.minimum.accumulate(np.where(first_in < 99, base + first_in, 2 ** 31 - 1)[:, ::-1],
                                  axis=1)[:, ::-1]
    cols = np.arange(w)
    gi, li = cols // 32, cols % 32
    own = words[:, gi, :]                                        # [n, w, 32]
    left_own = np.where(own & (lane <= li[:, None]), lane, -1).max(-1)
    right_own = np.where(own & (lane >= li[:, None]), lane, 99).min(-1)
    prev = np.where(gi > 0, last[:, np.maximum(gi - 1, 0)], -1)
    nxt = np.where(gi + 1 < g, first[:, np.minimum(gi + 1, g - 1)], 2 ** 31 - 1)
    l_col = np.where(left_own >= 0, gi * 32 + left_own, prev)
    r_col = np.where(right_own < 99, gi * 32 + right_own, nxt)
    lf = np.where(l_col >= 0, l_col, -1e9).astype(np.float32)
    rf = np.where(r_col < 2 ** 31 - 1, r_col, 1e9).astype(np.float32)
    colf = cols.astype(np.float32)
    return np.minimum(colf - lf, rf - colf)


@pytest.mark.parametrize("w", [7, 32, 33, 64, 100, 300])
def test_ballot_model_bit_equal_to_plain(w):
    """The kernel's word search, modelled in numpy, equals
    edge_distances_plain bit for bit: rows with no edge, edges only in the
    first or the last word, single edges, sparse and dense rows."""
    rng = np.random.default_rng(w)
    m = rng.random((10, w)) < np.array([0, 0, 0, 0, 0, 0.02, 0.1, 0.5, 0.9, 1.0])[:, None]
    m[1, 0] = True                      # only the first column
    m[2, w - 1] = True                  # only the last column
    m[3, : min(w, 32)] = rng.random(min(w, 32)) < 0.3   # first word only
    m[4, max(0, w - 32):] = rng.random(min(w, 32)) < 0.3  # last word only
    want = tdist.edge_distances_plain(_t(m), _t(m))[0].numpy()
    np.testing.assert_array_equal(_ballot_distances(m), want)


@pytest.mark.parametrize("falloff,threshold,radius", [(2.0, 20.0, 20), (1.0, 6.0, 5),
                                                      (1.7, 12.5, 9), (0.5, 20.0, 3)])
def test_edge_weights_plain_is_the_composition(falloff, threshold, radius):
    """edge_weights_fused (on the CPU, its plain version) equals the blur's
    former composition bit for bit: Sobel-x, the masks, the distance
    transform's distances and clip(1 - d / r, 0, 1) ** falloff, image by
    image (the Sobel pads each image's top and bottom on its own)."""
    d = _depth255(b=3, seed=2)
    b, h, w = d.shape
    wl, wr = tdist.edge_weights_fused(_t(d).reshape(-1, w), edge_threshold=threshold,
                                      mask_radius=radius, falloff=falloff, height=h)
    grad = tblur.sobel_x(_t(d))
    thr = float(np.float32(np.float32(10.0) * np.float32(threshold)))
    strong = torch.clamp(grad.abs() / thr, 0.0, 1.0) > 0.5
    for got, mask in ((wl, (grad > 0) & strong), (wr, (grad < 0) & strong)):
        dist = tdist.edge_distances_plain(mask.reshape(-1, w), mask.reshape(-1, w))[0]
        want = torch.pow(torch.clamp(1.0 - dist / radius, 0.0, 1.0), falloff)
        assert torch.equal(got, want)


def test_directional_blur_noise_depth_matches():
    """directional_motion_blur through the fused entry against JAX on noise
    depth, where edges are everywhere (atol 1e-4, as above)."""
    d = np.random.default_rng(4).uniform(0, 255, (2, H, W)).astype(np.float32)
    kw = dict(blur_strength=20, edge_threshold=20, blur_mask_width=20,
              falloff_exponent=2.0, vert_smooth_px=6)
    jl, jr = jblur.directional_motion_blur(jnp.asarray(d), **kw)
    tl, tr = tblur.directional_motion_blur(_t(d), **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-4)


def test_distance_shared_memory_rule():
    """24 B per 32 columns; the widest row whose words fit in shared memory
    (wider ones take the workspace instances), and past 2^24 columns a clear
    error before any launch, through either entry (meta tensors stand for
    the card's)."""
    assert tdist.smem_bytes(1920) == 24 * 60
    assert tdist.SHARED_WIDTH == 309920
    assert tdist.smem_bytes(tdist.SHARED_WIDTH) <= tdist.SMEM_LIMIT
    assert tdist.smem_bytes(tdist.SHARED_WIDTH + 1) > tdist.SMEM_LIMIT
    assert tdist.MAX_WIDTH == 1 << 24
    w = tdist.MAX_WIDTH + 1
    m = torch.empty((1, w), dtype=torch.bool, device="meta")
    before = tdist.LAUNCHES
    with pytest.raises(ValueError, match="16777216 columns"):
        tdist.edge_distances(m, m)
    with pytest.raises(ValueError, match="16777216 columns"):
        tdist.edge_weights_fused(torch.empty((1, w), device="meta"), edge_threshold=20.0,
                                 mask_radius=20, falloff=2.0, height=1)
    assert tdist.LAUNCHES == before
