"""Port's CPU-parity fills (plain versions on the CPU) vs the JAX package's
`apply_stereo_divergence`, jitted as `stereo_pipeline` runs it, and the
port's gather wrapper vs `torch.gather`.

Stated tolerances:
- none, naive, naive_interpolating, inverse, none_post, inverse_post:
  bit-equal (measured: bit-equal in all four cases of tests/test_fills.py);
- hybrid_edge, hybrid_edge_plus at 48x64: within 1 LSB of JAX on at most 1%
  of values, and to the JAX tests' own bounds against the numpy oracle (max 1
  LSB, mean under 0.5). Measured: 1 LSB on 0.10-0.47% of values. The fill
  is the JAX function's arithmetic; the difference comes from the prefix sums
  (torch.cumsum rounds in another order than XLA's) and from the last bit of
  exp: with XLA's cumsum and exp swapped in, the port is bit-equal.
- hybrid_edge at 270x480, where the +1e-3 nudge no longer covers the
  cancelling prefix-sum differences: within 1 LSB of JAX on at most 35% of
  values, and no farther from the oracle than JAX is (max 2 LSB, mean under
  0.5). Measured over three runs of this file's test: 1 LSB from JAX on
  29.05-29.07% of values; against the oracle the port max 2 LSB on
  34.31-34.35% (mean 0.3431-0.3436), JAX max 2 LSB on 34.31% (mean 0.3432).
  The shares move in the fourth digit from one process to the next.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfystereo_tpu import pipeline as jpipe
from comfystereo_tpu.ops import fills as jfills
from comfystereo_tpu.ops import scan as jscan
from comfystereo_tpu.utils import fixtures
from comfystereo_tpu_torch import pipeline as tpipe
from comfystereo_tpu_torch.kernels import gather as tgather
from comfystereo_tpu_torch.ops import fills as tfills
from comfystereo_tpu_torch.ops import scan as tscan
from tests.oracle import stereo_oracle as oracle

H, W = 48, 64

# tests/test_fills.py's cases: (divergence %, separation %, exponent, convergence)
CASES = [
    (4.5, 0.0, 2.0, 0.5),
    (-3.0, 0.0, 1.0, 0.5),
    (4.5, 1.5, 2.0, 0.3),
    (8.0, -1.0, 0.7, 0.8),
]


@functools.lru_cache(maxsize=None)
def _jax_dispatch():
    return jax.jit(jpipe.apply_stereo_divergence, static_argnums=(2, 3, 4, 5, 6))


def _inputs():
    img = fixtures.create_test_image(H, W).astype(np.float32)
    depth = fixtures.create_depth_map(H, W).astype(np.float32)
    return img, depth


def _both(fill, div, sep, exp, conv):
    img, depth = _inputs()
    want = np.asarray(_jax_dispatch()(jnp.asarray(img[None]), jnp.asarray(depth[None]),
                                      div, sep, exp, fill, conv))[0]
    got = tpipe.apply_stereo_divergence(torch.from_numpy(img[None]),
                                        torch.from_numpy(depth[None]),
                                        div, sep, exp, fill, conv)
    assert got.dtype == torch.float32 and got.shape == (1, H, W, 3)
    return got[0].numpy(), want


@pytest.mark.parametrize("div,sep,exp,conv", CASES)
@pytest.mark.parametrize("fill", ["none", "naive", "naive_interpolating", "inverse",
                                  "none_post", "inverse_post"])
def test_fill_bit_equal_to_jax(fill, div, sep, exp, conv):
    got, want = _both(fill, div, sep, exp, conv)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("div,sep,exp,conv", [CASES[0], CASES[3]])
@pytest.mark.parametrize("fill", ["hybrid_edge", "hybrid_edge_plus"])
def test_hybrid_fills_within_bounds(fill, div, sep, exp, conv):
    got, want = _both(fill, div, sep, exp, conv)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    img, depth = _inputs()
    ref = oracle.dispatch(img.astype(np.uint8), depth, div, sep, exp, fill,
                          conv).astype(np.int32)
    d_ref = np.abs(got.astype(np.int32) - ref)
    assert d_ref.max() <= 1 and d_ref.mean() < 0.5


def test_hybrid_fill_at_real_width_vs_oracle():
    """hybrid_edge at 270x480 against JAX and the numpy oracle; the numbers
    are printed (pytest -s)."""
    h, w = 270, 480
    img = fixtures.create_test_image(h, w).astype(np.float32)
    depth = fixtures.create_depth_map(h, w).astype(np.float32)
    args = (4.5, 0.0, 2.0, "hybrid_edge", 0.5)
    got = tpipe.apply_stereo_divergence(torch.from_numpy(img[None]),
                                        torch.from_numpy(depth[None]), *args)
    got = got[0].numpy().astype(np.int32)
    want = np.asarray(_jax_dispatch()(jnp.asarray(img[None]), jnp.asarray(depth[None]),
                                      *args))[0].astype(np.int32)
    ref = oracle.dispatch(img.astype(np.uint8), depth, *args).astype(np.int32)
    d_jax, d_port, d_jax_ref = np.abs(got - want), np.abs(got - ref), np.abs(want - ref)
    for name, d in (("port-jax", d_jax), ("port-oracle", d_port), ("jax-oracle", d_jax_ref)):
        print(f"{name}: max {d.max()} LSB, share {(d > 0).mean():.4f}, mean {d.mean():.4f}")
    assert d_jax.max() <= 1 and (d_jax > 0).mean() <= 0.35
    assert d_port.max() <= max(2, d_jax_ref.max()) and d_port.mean() < 0.5


def test_batched_fill_rows_independent():
    """Two different frames in one batch give each frame's own result."""
    imgs, depths = fixtures.batch_fixture(2, H, W, seed=3)
    imgs = np.trunc(imgs * 255.0).astype(np.float32)
    got = tpipe.apply_stereo_divergence(torch.from_numpy(imgs),
                                        torch.from_numpy(depths), 4.5, 0.0, 2.0,
                                        "inverse_post")
    for i in range(2):
        one = tpipe.apply_stereo_divergence(torch.from_numpy(imgs[i:i + 1]),
                                            torch.from_numpy(depths[i:i + 1]),
                                            4.5, 0.0, 2.0, "inverse_post")
        np.testing.assert_array_equal(got[i:i + 1].numpy(), one.numpy())


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("m,n", [(64, 64), (80, 64), (64, 48)])
def test_bounded_take_along_w_is_gather(dtype, m, n):
    rng = np.random.default_rng(m + n)
    values = torch.from_numpy(rng.integers(-1000, 1000, (2, 5, m))).to(dtype)
    cols = np.arange(n)
    idx = np.clip(cols + rng.integers(-6, 7, (2, 5, n)), 0, m - 1).astype(np.int32)
    got = tgather.bounded_take_along_w(values, torch.from_numpy(idx), 8)
    want = torch.gather(values, -1, torch.from_numpy(idx).long())
    assert got.dtype == dtype and torch.equal(got, want)
    # and what JAX's non-TPU path computes
    jax_out = np.asarray(jnp.take_along_axis(jnp.asarray(values.numpy()),
                                             jnp.asarray(idx), axis=-1))
    np.testing.assert_array_equal(got.numpy(), jax_out)


def _kernel_row_map(values, idx):
    """What csrc/gather.cu reads for each output element: value row r, index
    row (r // (rep*inner)) * inner + r % inner, flattened to rows."""
    lead = tuple(values.shape[:-1])
    rep, inner = tgather._broadcast_rows(lead, tuple(idx.shape[:-1]))
    v2 = values.reshape(-1, values.shape[-1])
    i2 = idx.reshape(-1, idx.shape[-1]).long()
    r = torch.arange(v2.shape[0])
    irow = (r // (rep * inner)) * inner + r % inner
    return torch.gather(v2, 1, i2[irow]).reshape(lead + (idx.shape[-1],))


@pytest.mark.parametrize("idx_shape", [(2, 1, 7), (2, 3, 7), (1, 3, 7)])
def test_gather_broadcast_row_map(idx_shape):
    """A size-1 index axis broadcasts over the values' axis, as the fills'
    [B, 1, H, W] index planes do over [B, C, H, W] images; the kernel's row
    map gives torch.gather's broadcast result."""
    rng = np.random.default_rng(1)
    values = torch.from_numpy(rng.standard_normal((2, 3, 7, 40)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, idx_shape + (40,)).astype(np.int32))
    got = tgather.bounded_take_along_w(values, idx, 40)
    want = torch.gather(values, -1, idx.long().expand(2, 3, 7, 40))
    assert torch.equal(got, want)
    assert torch.equal(_kernel_row_map(values, idx), want)


def test_gather_wrapper_rejects_bad_arguments():
    v = torch.zeros(2, 8)
    with pytest.raises(TypeError):
        tgather.bounded_take_along_w(v, torch.zeros(2, 8, dtype=torch.int64), 2)
    with pytest.raises(TypeError):
        tgather.bounded_take_along_w(v.double(), torch.zeros(2, 8, dtype=torch.int32), 2)
    with pytest.raises(ValueError):  # two broadcast axes
        tgather.bounded_take_along_w(torch.zeros(2, 3, 8),
                                     torch.zeros(1, 1, 8, dtype=torch.int32), 2)
    with pytest.raises(ValueError):  # rank differs
        tgather.bounded_take_along_w(v, torch.zeros(8, dtype=torch.int32), 2)


@pytest.mark.parametrize("bad", [-1, 8])
def test_gather_out_of_range_index_raises_on_cpu(bad):
    """An index outside [0, M-1] raises (the kernel asserts on the card)."""
    idx = torch.zeros(2, 8, dtype=torch.int32)
    idx[1, 3] = bad
    with pytest.raises(RuntimeError):
        tgather.bounded_take_along_w(torch.zeros(2, 8), idx, 8)


def test_segmented_running_min_bit_equal():
    rng = np.random.default_rng(2)
    vals = rng.integers(0, 64, (3, 5, 64)).astype(np.int32)
    vals[rng.random(vals.shape) < 0.3] = 2 ** 30
    reset = rng.random(vals.shape) < 0.2
    want = np.asarray(jax.jit(jscan.segmented_running_min)(jnp.asarray(vals),
                                                           jnp.asarray(reset)))
    got = tscan.segmented_running_min(torch.from_numpy(vals), torch.from_numpy(reset))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_disp", [3, 12])
def test_first_at_least_bit_equal(max_disp):
    """The windowed binary search, including its unfrozen fixed rounds."""
    rng = np.random.default_rng(max_disp)
    keys = np.sort(np.clip(np.arange(64) + rng.integers(-max_disp // 2, max_disp // 2 + 1,
                                                        (4, 64)), 0, 80),
                   axis=-1).astype(np.int32)
    q = np.broadcast_to(np.arange(64, dtype=np.int32), (4, 64)) + rng.integers(
        -1, 2, (4, 64)).astype(np.int32)
    want = np.asarray(jfills._first_at_least(jnp.asarray(keys), jnp.asarray(q), max_disp))
    got = tfills._first_at_least(torch.from_numpy(keys), torch.from_numpy(q), max_disp)
    np.testing.assert_array_equal(got.numpy(), want)
