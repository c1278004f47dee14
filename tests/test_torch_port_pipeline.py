"""Port's stereo_pipeline (plain versions on the CPU) vs the JAX package's
stereo_pipeline, for gpu_warp and for the ten CPU-parity fills.

Stated tolerances, gpu_warp:
- blur off: mask bit-equal, colours atol 1e-5 (measured: bit-equal);
- blur on: depth outputs atol 1e-5 (0-1 domain), mask mismatch <= 0.1% of
  pixels, trunc(x*255) within 1 LSB on >= 99.9% of values (measured: mask
  bit-equal, colours within 1.3e-6).
The fills (blur on): see test_fill_pipeline_matches_jax.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comfystereo_tpu as cs
from comfystereo_tpu.utils import fixtures
import comfystereo_tpu_torch as ct
from comfystereo_tpu_torch import pipeline as tpipe

B, H, W = 2, 48, 64
MODES3 = ("left-right", "top-bottom", "red-cyan-anaglyph")


def _inputs(seed=0):
    return fixtures.batch_fixture(B, H, W, seed=seed)


def _run_both(jcfg, imgs, depths):
    jo = cs.stereo_pipeline(jnp.asarray(imgs), jnp.asarray(depths), jcfg)
    to = ct.stereo_pipeline(torch.from_numpy(imgs), torch.from_numpy(depths),
                            ct.config_from_fields(jcfg))
    return jo, to


@pytest.mark.parametrize("color_dtype", ["float32", "bfloat16"])
def test_pipeline_blur_off_matches(color_dtype):
    imgs, depths = _inputs()
    jcfg = cs.StereoConfig(modes=MODES3, depth_map_blur=False,
                           color_dtype=color_dtype)
    jo, to = _run_both(jcfg, imgs, depths)
    np.testing.assert_array_equal(np.asarray(jo["mask"]), to["mask"].numpy())
    for a, b in zip(jo["stereo"], to["stereo"]):
        assert b.shape == a.shape
        assert (b.dtype == torch.bfloat16) == (color_dtype == "bfloat16")
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a.astype(jnp.float32)),
                                   rtol=0, atol=1e-5)
    for k in ("left_depth", "right_depth"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("seed", [0, 5])
def test_pipeline_default_config_matches(seed):
    imgs, depths = _inputs(seed)
    jcfg = cs.StereoConfig(modes=MODES3)
    assert jcfg.depth_map_blur
    jo, to = _run_both(jcfg, imgs, depths)
    for k in ("left_depth", "right_depth"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), rtol=0,
                                   atol=1e-5)
    assert (np.asarray(jo["mask"]) != to["mask"].numpy()).mean() <= 0.001
    for a, b in zip(jo["stereo"], to["stereo"]):
        qa = np.trunc(np.asarray(a) * 255.0)
        qb = np.trunc(b.numpy() * 255.0)
        assert (np.abs(qa - qb) <= 1).mean() >= 0.999


def test_pipeline_0_255_depth_and_outputs():
    imgs, depths = _inputs()
    cfg = ct.StereoConfig(modes=MODES3)
    out = ct.stereo_pipeline(torch.from_numpy(imgs),
                             torch.from_numpy(depths * 255.0), cfg)
    ref = ct.stereo_pipeline(torch.from_numpy(imgs), torch.from_numpy(depths), cfg)
    # 0-1 depth is scaled to 0-255 first, so both scales give one result
    np.testing.assert_allclose(out["stereo"][0].numpy(), ref["stereo"][0].numpy(),
                               atol=1e-5)
    assert out["stereo"][0].shape == (B, H, 2 * W, 3)
    assert out["stereo"][1].shape == (B, 2 * H, W, 3)
    assert out["stereo"][2].shape == (B, H, W, 3)
    assert out["mask"].shape == (B, H, W) and out["mask"].dtype == torch.float32
    for o in out["stereo"]:
        assert float(o.min()) >= 0.0 and float(o.max()) <= 1.0
    assert not torch.allclose(out["left_depth"], out["right_depth"])


def test_balance_extremes_passthrough():
    imgs, depths = _inputs()
    cfg = ct.StereoConfig(stereo_balance=1.0, modes=("only-right",),
                          depth_map_blur=False)
    out = ct.stereo_pipeline(torch.from_numpy(imgs), torch.from_numpy(depths), cfg)
    np.testing.assert_array_equal(out["stereo"][0].numpy(), imgs)
    # the passed-through eye contributes no gaps; the warped eye does
    jcfg = dataclasses.replace(cs.StereoConfig(), stereo_balance=1.0,
                               modes=("only-right",), depth_map_blur=False)
    jo = cs.stereo_pipeline(jnp.asarray(imgs), jnp.asarray(depths), jcfg)
    np.testing.assert_array_equal(np.asarray(jo["mask"]), out["mask"].numpy())


FILLS = [f for f in ct.FILL_TECHNIQUES if f != "gpu_warp"]


@pytest.mark.parametrize("fill", FILLS)
def test_unported_fill_raises(fill):
    """With polylines_exact=False only the fills that reach the supersampled
    polylines renderer raise, naming its ROADMAP item; the others run."""
    imgs, depths = _inputs()
    cfg = ct.StereoConfig(fill_technique=fill, polylines_exact=False)
    args = (torch.from_numpy(imgs), torch.from_numpy(depths), cfg)
    if fill in ("polylines_soft", "polylines_sharp", "hybrid_edge_plus"):
        assert fill in tpipe.UNPORTED_FILLS
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
            ct.stereo_pipeline(*args)
    else:
        assert fill not in tpipe.UNPORTED_FILLS
        out = ct.stereo_pipeline(*args)
        assert out["stereo"][0].shape == (B, H, 2 * W, 3)


# Bounds for the fills that are not bit-equal (test_torch_port_fills.py):
# 1 LSB on at most 1% of values, measured 0.1-0.5%.
_HYBRID = ("hybrid_edge", "hybrid_edge_plus")


@pytest.mark.parametrize("fill", FILLS)
def test_fill_pipeline_matches_jax(fill):
    """The uint8 branch with the depth blur on: stereo outputs bit-equal in
    uint8 (x255) and the black-pixel mask bit-equal to JAX (measured), the
    hybrid fills within 1 LSB on at most 1% of values and their masks on at
    most 0.1% of pixels. The final /255 is a true division here; jitted XLA
    multiplies by 1/255 instead, 1 ulp apart in half the values."""
    imgs, depths = _inputs(seed=1)
    jcfg = cs.StereoConfig(modes=MODES3, fill_technique=fill)
    assert jcfg.depth_map_blur and jcfg.polylines_exact
    jo, to = _run_both(jcfg, imgs, depths)
    jmask, tmask = np.asarray(jo["mask"]), to["mask"].numpy()
    assert tmask.shape == jmask.shape == (B, H, 2 * W)
    for a, b in zip(jo["stereo"], to["stereo"]):
        assert b.dtype == torch.float32 and b.shape == a.shape
        qa = np.round(np.asarray(a) * 255.0)
        qb = np.round(b.numpy() * 255.0)
        np.testing.assert_allclose(b.numpy() * 255.0, qb, rtol=0, atol=1e-4)
        if fill in _HYBRID:
            diff = np.abs(qa - qb)
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
        else:
            np.testing.assert_array_equal(qb, qa)
    if fill in _HYBRID:
        assert (jmask != tmask).mean() <= 0.001
    else:
        np.testing.assert_array_equal(tmask, jmask)
    for k in ("left_depth", "right_depth"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), rtol=0,
                                   atol=1e-5)


def test_color_dtype_is_for_gpu_warp_only():
    """color_dtype applies to the gpu_warp branch only: a fill gives the
    same float32 output under both colour dtypes."""
    imgs, depths = _inputs()
    outs = [ct.stereo_pipeline(torch.from_numpy(imgs), torch.from_numpy(depths),
                               ct.StereoConfig(fill_technique="inverse_post",
                                               color_dtype=cdt))
            for cdt in ("float32", "bfloat16")]
    assert outs[1]["stereo"][0].dtype == torch.float32
    assert torch.equal(outs[0]["stereo"][0], outs[1]["stereo"][0])
    assert torch.equal(outs[0]["mask"], outs[1]["mask"])
