"""Port's forward_warp (plain version on the CPU) vs the JAX package's XLA
path and its Pallas kernel run in interpret mode.

Stated tolerances: gap masks bit-equal; colours atol 1e-5 (bf16 colour:
within 2 LSB after x255). Measured: the port is bit-equal to the XLA path in
both gap and colour; it differs from the interpret-mode Pallas kernel by up
to 1.2e-6 in colour, as the XLA path does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfystereo_tpu.ops import warp as jwarp
from comfystereo_tpu.utils import fixtures
from comfystereo_tpu_torch.kernels import warp_kernel as twk
from comfystereo_tpu_torch.ops import warp as twarp

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
