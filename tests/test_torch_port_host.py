"""The port's host side against the JAX package's, on the same inputs:
utils/profiling.py, utils/tensors.py, native/ (the g++-built hostops and
their numpy path), the scan search and gather, the side blurs, and the
graft entry's dry run on a 4-slot CPU mesh.

Stated tolerances: tensors, native, scan: bit-equal to JAX (native luma
within 3e-7 of numpy, as tests/test_native.py holds it: summation order);
`_central_diff_w` and `direction_aware_blur`'s weights bit-equal; the
Gaussian blurs within 1e-4 (0-255 depth): the kernel taps come from float32
`exp` and a sum, which XLA and torch may round 1 ulp apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfystereo_tpu import native as jnative
from comfystereo_tpu.ops import blur as jblur
from comfystereo_tpu.ops import scan as jscan
from comfystereo_tpu.utils import fixtures
from comfystereo_tpu.utils import tensors as jtensors
from comfystereo_tpu_torch import graft_entry, native
from comfystereo_tpu_torch.ops import blur, scan
from comfystereo_tpu_torch.utils import profiling, tensors

H, W = 40, 64


# --- profiling ----------------------------------------------------------------

def test_stage_timer_records(capsys):
    results = {}
    with profiling.stage_timer("x", results, verbose=True, device=torch.zeros(2)):
        torch.ones(1000).sum()
    assert results["x"] >= 0
    assert "[timing] x:" in capsys.readouterr().out


def test_sync_walks_trees_and_skips_the_cpu():
    from comfystereo_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(2, device="cpu")
    st = sharding.shard_tensor(torch.zeros(4, 3), sharding.frame_sharding(mesh))
    tree = {"a": [torch.zeros(1), (torch.ones(2), 3)], "b": st, "c": None}
    assert profiling._devices(tree, set()) == {torch.device("cpu")}
    profiling.sync(tree)  # no CUDA tensor: nothing to wait for


def test_memory_stats_keys(monkeypatch):
    stats = profiling.memory_stats()
    assert stats["host_rss_mb"] > 0
    assert not any(k.startswith("cuda") for k in stats)  # no CUDA initialised here
    fake = {"allocated_bytes.all.current": 3 * 2 ** 20,
            "allocated_bytes.all.peak": 5 * 2 ** 20}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: fake)
    stats = profiling.memory_stats()
    assert stats["cuda1_in_use_mb"] == 3.0 and stats["cuda1_peak_mb"] == 5.0


def test_log_memory_gated(monkeypatch, capsys):
    monkeypatch.setattr(profiling, "DEBUG_MEMORY", False)
    profiling.log_memory("x")
    assert capsys.readouterr().out == ""
    monkeypatch.setattr(profiling, "DEBUG_MEMORY", True)
    profiling.log_memory("here")
    assert "[MEM] here: host_rss_mb=" in capsys.readouterr().out


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert d == str(tmp_path)
    assert (tmp_path / "trace.json").stat().st_size > 0


# --- tensors --------------------------------------------------------------------

def test_tensors_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.1, 1.1, (2, 6, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tensors.tensor2np(torch.from_numpy(x)),
                                  jtensors.tensor2np(x))
    chw = rng.uniform(0, 1, (3, 6, 5)).astype(np.float32)
    np.testing.assert_array_equal(tensors.tensor2np(chw), jtensors.tensor2np(chw))
    u8 = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tensors.np2tensor([u8, u8]), jtensors.np2tensor([u8, u8]))
    np.testing.assert_array_equal(tensors.gray_to_rgb(x[..., 0]), jtensors.gray_to_rgb(x[..., 0]))
    chans = [torch.from_numpy(x[..., i:i + 1]) for i in range(3)]
    np.testing.assert_array_equal(tensors.merge_channels(*chans),
                                  jtensors.merge_channels(*[c.numpy() for c in chans]))
    pil = tensors.tensor2pil(torch.from_numpy(x))
    np.testing.assert_array_equal(tensors.pil2tensor(pil), jtensors.pil2tensor(pil))


# --- native -----------------------------------------------------------------------

def _bgr(h=37, w=53, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def test_native_builds_under_build_dir():
    assert native.available()  # g++ is present here
    assert native.BUILD_DIR.parts[-2:] == ("build", "hostops")
    assert any(native.BUILD_DIR.glob("hostops_*.so"))


def test_native_matches_jax_and_numpy():
    bgr = np.stack([_bgr(seed=s) for s in range(3)])
    got = native.bgr_u8_to_rgb_f32(bgr)
    np.testing.assert_array_equal(got, jnative.bgr_u8_to_rgb_f32(bgr))
    np.testing.assert_array_equal(got, bgr[..., ::-1].astype(np.float32) / 255.0)
    gray = native.bgr_u8_to_gray_f32(bgr)
    np.testing.assert_array_equal(gray, jnative.bgr_u8_to_gray_f32(bgr))
    b = bgr.astype(np.float32)
    np.testing.assert_allclose(gray, (0.2989 * b[..., 2] + 0.5870 * b[..., 1]
                                      + 0.1140 * b[..., 0]) / 255.0, atol=3e-7)
    rgb = np.random.default_rng(1).uniform(-0.1, 1.1, (41, 29, 3)).astype(np.float32)
    back = native.rgb_f32_to_bgr_u8(rgb)
    np.testing.assert_array_equal(back, jnative.rgb_f32_to_bgr_u8(rgb))
    np.testing.assert_array_equal(back, np.clip(rgb * 255.0, 0, 255).astype(np.uint8)[..., ::-1])
    np.testing.assert_array_equal(native.rgb_f32_to_bgr_u8(got), bgr)


def test_native_numpy_path_without_a_compiler(monkeypatch):
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    assert not native.available()
    bgr = _bgr()
    np.testing.assert_array_equal(native.bgr_u8_to_rgb_f32(bgr),
                                  bgr[..., ::-1].astype(np.float32) / 255.0)
    rgb = native.bgr_u8_to_rgb_f32(bgr)
    np.testing.assert_array_equal(native.rgb_f32_to_bgr_u8(rgb), bgr)


# --- scan ---------------------------------------------------------------------

@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("n", [1, 2, 37])
def test_searchsorted_rows_equal_jax(side, n):
    rng = np.random.default_rng(n)
    rows = np.sort(rng.integers(0, 20, (3, 4, n)).astype(np.float32), axis=-1)
    queries = rng.integers(-2, 23, (3, 4, 11)).astype(np.float32)
    got = scan.searchsorted_rows(torch.from_numpy(rows), torch.from_numpy(queries), side)
    want = np.asarray(jscan.searchsorted_rows(jnp.asarray(rows), jnp.asarray(queries), side))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # The JAX search does not freeze converged lanes, so a query past a row's
    # last value ends at N + 1 where its docstring says N (ROADMAP section 3);
    # the port keeps the code's result. Elsewhere it is numpy's searchsorted.
    ref = np.stack([np.searchsorted(r, q, side) for r, q in
                    zip(rows.reshape(-1, n), queries.reshape(-1, 11))])
    flat = got.numpy().reshape(-1, 11)
    np.testing.assert_array_equal(np.where(ref < n, flat, ref), ref)
    assert set(np.unique(flat[ref == n])) <= {n, n + 1}
    idx = np.clip(want, 0, n - 1)
    np.testing.assert_array_equal(scan.gather_rows(torch.from_numpy(rows), torch.from_numpy(idx)),
                                  np.asarray(jscan.gather_rows(jnp.asarray(rows), jnp.asarray(idx))))


# --- side blurs -----------------------------------------------------------------

def _depth():
    return fixtures.create_depth_map(H, W).astype(np.float32)[None]


def test_central_diff_equal_jax():
    d = _depth()
    np.testing.assert_array_equal(blur._central_diff_w(torch.from_numpy(d)).numpy(),
                                  np.asarray(jblur._central_diff_w(jnp.asarray(d))))


@pytest.mark.parametrize("sigma", [0.0, 1.0, 2.0])
def test_gaussian_blur_close_to_jax(sigma):
    d = _depth()
    got = blur.gaussian_blur(torch.from_numpy(d), sigma).numpy()
    np.testing.assert_allclose(got, np.asarray(jblur.gaussian_blur(jnp.asarray(d), sigma)),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("eye", ["left", "right"])
def test_direction_aware_blur_close_to_jax(eye):
    d = _depth()
    got = blur.direction_aware_blur(torch.from_numpy(d), 2.0, 10.0, eye).numpy()
    want = np.asarray(jblur.direction_aware_blur(jnp.asarray(d), 2.0, 10.0, eye))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    flat = torch.full((1, 16, 16), 7.0)
    np.testing.assert_allclose(blur.direction_aware_blur(flat, 2.0, 10.0, eye).numpy(),
                               7.0, atol=1e-4)


def test_edge_selective_blur_close_to_jax():
    d = _depth()
    got = blur.edge_selective_blur(torch.from_numpy(d), 2.0, 20.0).numpy()
    want = np.asarray(jblur.edge_selective_blur(jnp.asarray(d), 2.0, 20.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# --- graft entry ----------------------------------------------------------------

def test_entry_runs_on_the_cpu():
    fn, (imgs, depths) = graft_entry.entry("cpu")
    assert isinstance(imgs, np.ndarray)
    out = fn(imgs, depths)
    assert tuple(out["stereo"][0].shape) == (2, 96, 256, 3)


def test_dryrun_multichip_on_a_cpu_mesh():
    report = graft_entry.dryrun_multichip(4, device="cpu")
    assert report["gpu_warp_max_abs_err"] == 0.0 and report["naive_max_abs_err"] == 0.0
    assert report["null_text_u_rel"] <= 1e-2 and report["null_text_latent_rel"] <= 1e-3
    assert report["unet_rel"] <= 1e-4


def test_dryrun_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(2)
