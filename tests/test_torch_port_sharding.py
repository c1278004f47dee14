"""The port's sharded stereo_pipeline (parallel/) on one process's CPU
meshes, against the port's unsharded run and the JAX package's sharded run.

An 8-slot "data" mesh and a (4, 2) ("data", "seq") mesh on the CPU stand in
for the JAX tests' eight virtual CPU devices (tests/conftest.py). Stated
tolerances:
- port sharded vs port unsharded: bit-equal, every output, every fill,
  both meshes (the halos and the extrema are exchanged exactly);
- port sharded vs JAX sharded (gpu_warp, blur on): the pipeline's port-vs-
  JAX bounds (tests/test_torch_port_pipeline.py): depth outputs atol 1e-5,
  mask mismatch <= 0.1% of pixels, trunc(x*255) within 1 LSB on >= 99.9%
  of values; the naive fill: bit-equal in uint8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comfystereo_tpu as cs
from comfystereo_tpu.parallel import sharding as jsharding
from comfystereo_tpu.utils import fixtures
import comfystereo_tpu_torch as ct
from comfystereo_tpu_torch.parallel import sharding

B, H, W = 8, 48, 64
MODES = ("left-right", "top-bottom")
MESHES = {"frames8": ((8,), ("data",)), "rows4x2": ((4, 2), ("data", "seq"))}


def _batch():
    img = fixtures.create_test_image(H, W).astype(np.float32) / 255.0
    dm = fixtures.create_depth_map(H, W).astype(np.float32)
    imgs = np.stack([np.roll(img, 2 * i, axis=1) for i in range(B)])
    dms = np.stack([np.roll(dm, 2 * i, axis=1) for i in range(B)])
    return imgs, dms


def _port_sharded(imgs, dms, cfg, mesh_name):
    shape, axes = MESHES[mesh_name]
    mesh = sharding.make_mesh(8, axes=axes, shape=shape, device="cpu")
    s_img, s_dep = sharding.shard_batch(torch.from_numpy(imgs), torch.from_numpy(dms),
                                        mesh, rows=len(shape) == 2)
    return ct.stereo_pipeline(s_img, s_dep, cfg)


def _assert_bit_equal(got, want):
    assert len(got["stereo"]) == len(want["stereo"])
    for g, w in zip(got["stereo"], want["stereo"]):
        assert tuple(g.shape) == tuple(w.shape)
        assert torch.equal(g.gather(), w)
    for k in ("mask", "left_depth", "right_depth"):
        assert torch.equal(got[k].gather(), want[k]), k


def test_mesh_layout():
    mesh = sharding.make_mesh(8, axes=("data", "seq"), shape=(4, 2), device="cpu")
    assert mesh.shape == {"data": 4, "seq": 2}
    assert mesh.block_slots(True) == [(d, s) for d in range(4) for s in range(2)]
    assert mesh.block_slots(False) == [(d, 0) for d in range(4)]
    imgs, dms = _batch()
    s_img, s_dep = sharding.shard_batch(imgs, dms, mesh, rows=True)
    assert s_img.sharding.is_equivalent_to(sharding.frame_row_sharding(mesh), 4)
    assert tuple(s_dep.blocks[(1, 1)].shape) == (2, H // 2, W)
    np.testing.assert_array_equal(s_dep.blocks[(1, 1)].numpy(), dms[2:4, H // 2:])
    np.testing.assert_array_equal(s_img.gather().numpy(), imgs)
    with pytest.raises(ValueError):
        sharding.make_mesh(8, axes=("data", "seq"), shape=(4, 4), device="cpu")
    with pytest.raises(ValueError):
        sharding.frame_row_sharding(sharding.make_mesh(2, device="cpu"))


def test_mesh_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharding.make_mesh(2)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("vert_smooth", [0, 6])
def test_gpu_warp_sharded_bit_equal_and_matches_jax(mesh_name, vert_smooth):
    imgs, dms = _batch()
    jcfg = cs.StereoConfig(fill_technique="gpu_warp", modes=MODES,
                           depth_blur_vert_smooth=vert_smooth)
    cfg = ct.config_from_fields(jcfg)
    got = _port_sharded(imgs, dms, cfg, mesh_name)
    want = ct.stereo_pipeline(torch.from_numpy(imgs), torch.from_numpy(dms), cfg)
    _assert_bit_equal(got, want)

    shape, axes = MESHES[mesh_name]
    jmesh = jsharding.make_mesh(8, axes=axes, shape=shape)
    j_img, j_dep = jsharding.shard_batch(jnp.asarray(imgs), jnp.asarray(dms), jmesh,
                                         rows=len(shape) == 2)
    jo = cs.stereo_pipeline(j_img, j_dep, jcfg)
    for k in ("left_depth", "right_depth"):
        np.testing.assert_allclose(got[k].gather().numpy(), np.asarray(jo[k]), rtol=0,
                                   atol=1e-5)
    assert (np.asarray(jo["mask"]) != got["mask"].gather().numpy()).mean() <= 0.001
    for a, b in zip(jo["stereo"], got["stereo"]):
        qa = np.trunc(np.asarray(a) * 255.0)
        qb = np.trunc(b.gather().numpy() * 255.0)
        assert (np.abs(qa - qb) <= 1).mean() >= 0.999


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_naive_fill_sharded_bit_equal_and_matches_jax(mesh_name):
    imgs, dms = _batch()
    jcfg = cs.StereoConfig(fill_technique="naive", modes=MODES)
    cfg = ct.config_from_fields(jcfg)
    got = _port_sharded(imgs, dms, cfg, mesh_name)
    _assert_bit_equal(got, ct.stereo_pipeline(torch.from_numpy(imgs),
                                              torch.from_numpy(dms), cfg))
    shape, axes = MESHES[mesh_name]
    jmesh = jsharding.make_mesh(8, axes=axes, shape=shape)
    j_img, j_dep = jsharding.shard_batch(jnp.asarray(imgs), jnp.asarray(dms), jmesh,
                                         rows=len(shape) == 2)
    jo = cs.stereo_pipeline(j_img, j_dep, jcfg)
    for a, b in zip(jo["stereo"], got["stereo"]):
        np.testing.assert_array_equal(np.round(b.gather().numpy() * 255.0),
                                      np.round(np.asarray(a) * 255.0))


@pytest.mark.parametrize("fill", [f for f in ct.FILL_TECHNIQUES
                                  if f not in ("gpu_warp", "naive")])
def test_every_fill_row_sharded_bit_equal(fill):
    imgs, dms = _batch()
    cfg = ct.StereoConfig(fill_technique=fill, modes=("top-bottom", "left-right"))
    mesh = sharding.make_mesh(4, axes=("data", "seq"), shape=(2, 2), device="cpu")
    s_img, s_dep = sharding.shard_batch(imgs[:4], dms[:4], mesh, rows=True)
    got = ct.stereo_pipeline(s_img, s_dep, cfg)
    _assert_bit_equal(got, ct.stereo_pipeline(torch.from_numpy(imgs[:4]),
                                              torch.from_numpy(dms[:4]), cfg))
    assert got["mask"].row_groups == 2  # the first mode is top-bottom


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_shards_that_disagree_on_the_0_1_test(mesh_name):
    """The chunk-wide max decides whether depth is scaled by 255: here the
    first frames (and the top rows) lie in 0-1 and the rest does not, so a
    per-shard test would scale only some shards."""
    imgs, dms = _batch()
    dms = dms / 255.0
    dms[4:] *= 255.0
    dms[:, H // 2:] *= 3.0
    cfg = ct.StereoConfig(modes=MODES)
    got = _port_sharded(imgs, dms, cfg, mesh_name)
    _assert_bit_equal(got, ct.stereo_pipeline(torch.from_numpy(imgs),
                                              torch.from_numpy(dms), cfg))


def test_small_row_blocks_take_halos_from_several_neighbours():
    """Row blocks of 6 rows with vert_smooth 6: a block's 7 halo rows come
    from two neighbours on each side."""
    imgs, dms = _batch()
    mesh = sharding.make_mesh(8, axes=("data", "seq"), shape=(1, 8), device="cpu")
    s_img, s_dep = sharding.shard_batch(imgs[:2], dms[:2], mesh, rows=True)
    cfg = ct.StereoConfig(modes=MODES, fill_technique="hybrid_edge")
    _assert_bit_equal(ct.stereo_pipeline(s_img, s_dep, cfg),
                      ct.stereo_pipeline(torch.from_numpy(imgs[:2]),
                                         torch.from_numpy(dms[:2]), cfg))


def test_mismatched_inputs_raise():
    imgs, dms = _batch()
    mesh = sharding.make_mesh(8, device="cpu")
    s_img, s_dep = sharding.shard_batch(imgs, dms, mesh)
    with pytest.raises(TypeError):
        ct.stereo_pipeline(s_img, torch.from_numpy(dms), ct.StereoConfig())
    with pytest.raises(ValueError):
        sharding.shard_batch(imgs[:6], dms[:6], mesh)
