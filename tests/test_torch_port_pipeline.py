"""Port's stereo_pipeline (plain versions on the CPU) vs the JAX package's
stereo_pipeline, for gpu_warp and for the ten CPU-parity fills, and for
each configuration of BASELINE lines 1-4 as chip_smoke.py's phase 6 runs
them, against the CPU oracle too.

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

import bench as jbench
import chip_smoke as smoke
import comfystereo_tpu as cs
from comfystereo_tpu.utils import fixtures
import comfystereo_tpu_torch as ct
from tests.oracle import stereo_oracle as oracle

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


@pytest.mark.parametrize("seed, balance", [(0, 0.0), (5, 0.0), (0, 0.5)])
def test_pipeline_default_config_matches(seed, balance):
    imgs, depths = _inputs(seed)
    jcfg = cs.StereoConfig(modes=MODES3, stereo_balance=balance)
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


# Bounds for the fills that are not bit-equal (test_torch_port_fills.py):
# 1 LSB on at most 1% of values, measured 0.1-0.5%.
_HYBRID = ("hybrid_edge", "hybrid_edge_plus")


# Fills that take the supersampled renderer when polylines_exact=False.
_SUPERSAMPLED = ("polylines_soft", "polylines_sharp", "hybrid_edge_plus")


def _check_fill_matches_jax(fill, polylines_exact, blur=True, balance=0.0):
    imgs, depths = _inputs(seed=1)
    jcfg = cs.StereoConfig(modes=MODES3, fill_technique=fill,
                           polylines_exact=polylines_exact, depth_map_blur=blur,
                           stereo_balance=balance)
    jo, to = _run_both(jcfg, imgs, depths)
    # The supersampled renderer's sample tests can flip on the blurred
    # depth's last-bit differences from JAX (depth outputs within 1e-5
    # above): 1 LSB on at most 0.1% of values (measured 0-2 of 92160 over
    # three seeds; bit-equal with the blur off).
    near = blur and not polylines_exact and fill in _SUPERSAMPLED
    jmask, tmask = np.asarray(jo["mask"]), to["mask"].numpy()
    assert tmask.shape == jmask.shape == (B, H, 2 * W)
    for a, b in zip(jo["stereo"], to["stereo"]):
        assert b.dtype == torch.float32 and b.shape == a.shape
        qa = np.round(np.asarray(a) * 255.0)
        qb = np.round(b.numpy() * 255.0)
        np.testing.assert_allclose(b.numpy() * 255.0, qb, rtol=0, atol=1e-4)
        diff = np.abs(qa - qb)
        if fill in _HYBRID:
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
        elif near:
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.001
        else:
            np.testing.assert_array_equal(qb, qa)
    if fill in _HYBRID or near:
        assert (jmask != tmask).mean() <= 0.001
    else:
        np.testing.assert_array_equal(tmask, jmask)
    for k in ("left_depth", "right_depth"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("fill", FILLS)
def test_unported_fill_raises(fill):
    """With polylines_exact=False every fill runs, none raising
    NotImplementedError, and matches JAX: polylines_soft, polylines_sharp
    and the hybrid_edge_plus backfill take the supersampled renderer (the
    twin on the CPU, as JAX takes its XLA path there), bit-equal in uint8
    with the blur off (the hybrid fills to their bound) and to the bound
    above with it on; the other fills ignore the flag."""
    _check_fill_matches_jax(fill, polylines_exact=False, blur=False)
    if fill in _SUPERSAMPLED:
        _check_fill_matches_jax(fill, polylines_exact=False)


@pytest.mark.parametrize("balance", [0.0, 0.5])
@pytest.mark.parametrize("fill", FILLS)
def test_fill_pipeline_matches_jax(fill, balance):
    """The uint8 branch with the depth blur on, at both of BASELINE config
    5's balances: stereo outputs bit-equal in uint8 (x255) and the
    black-pixel mask bit-equal to JAX (measured), the hybrid fills within 1
    LSB on at most 1% of values and their masks on at most 0.1% of pixels.
    The final /255 is a true division here; jitted XLA multiplies by 1/255
    instead, 1 ulp apart in half the values."""
    _check_fill_matches_jax(fill, polylines_exact=True, balance=balance)


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


# Each configuration of BASELINE lines 1-4 in chip_smoke.py's phase 6, and
# config 4's mask check.
BASELINE_CASES = [(name, i) for name, (_, fields) in smoke.BASELINE_LINES.items()
                  if name[0] in "1234" for i in range(len(fields))]
BASELINE_CASES.append(("4_4k_warp_anaglyph_mask", "mask_check"))
ORACLE_WIDTH = 64


@pytest.mark.parametrize("name, i", BASELINE_CASES,
                         ids=[f"config{name[0]}-{i}" for name, i in BASELINE_CASES])
def test_baseline_config_matches_jax(name, i):
    """A 96x160 frame of the line's input at the oracle's width 64, through
    phase 6's own oracle checks (on the CPU) and through the JAX package
    with bench.py's downscale and oracle pair. The fills' pairs equal JAX's
    in uint8 (hybrid_edge within 1 LSB) and differ from the oracle's in as
    many uint8 values as JAX's (hybrid_edge give or take its values off
    JAX's); gpu_warp's, truncated to uint8, are within
    1 LSB of JAX's on under 5% of values (`test_video_fixture.py`). The mask
    check's gap mask equals JAX's, and so agrees with the oracle's gaps in
    as many pixels."""
    img, dm = (a[0] for a in smoke.baseline_inputs(name, 96, 160, 1))
    simg, sdm = jbench._scaled_inputs(img, dm, ORACLE_WIDTH)
    x, d = jnp.asarray(simg[None]), jnp.asarray(sdm[None])
    cpu = torch.device("cpu")
    if i == "mask_check":
        mask, gaps = smoke.mask_gaps(img, dm, ORACLE_WIDTH, cpu, oracle)
        jcfg = cs.StereoConfig(**smoke.MASK_CHECK)
        jmask = np.asarray(cs.stereo_pipeline(x, d, jcfg)["mask"][0]) > 0.5
        divl = jcfg.eye_divergences()[0] / 100.0 * simg.shape[1]
        _, jgaps = oracle.forward_warp(simg, sdm, +divl, 0.0, jcfg.stereo_offset_exponent,
                                       jcfg.convergence_point)
        np.testing.assert_array_equal(mask, jmask)
        assert (mask == gaps).mean() == (jmask == jgaps).mean()
        return
    fields = smoke.BASELINE_LINES[name][1][i]
    jcfg = cs.StereoConfig(**fields)
    j = np.asarray(cs.stereo_pipeline(x, d, jcfg)["stereo"][0][0])
    if jcfg.fill_technique == "gpu_warp":
        t = ct.stereo_pipeline(torch.tensor(simg[None]), torch.tensor(sdm[None]),
                               ct.StereoConfig(**fields))["stereo"][0][0].numpy()
        diff = np.abs(np.trunc(np.clip(j * 255, 0, 255)) - np.trunc(np.clip(t * 255, 0, 255)))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.05
        return
    t, off = smoke.oracle_off(ct.StereoConfig(**fields), img, dm, ORACLE_WIDTH, cpu, oracle)
    lsb = np.abs(np.round(j * 255) - np.round(t * 255))
    assert lsb.max() <= (1 if jcfg.fill_technique == "hybrid_edge" else 0)
    want = np.round(jbench._oracle_sbs(simg, sdm, jcfg, oracle) * 255)
    # Equal counts where the pairs are bit-equal; each value hybrid_edge
    # has 1 LSB off JAX's may move the count by one.
    assert abs(off - int((np.round(j * 255) != want).sum())) <= int((lsb > 0).sum())
