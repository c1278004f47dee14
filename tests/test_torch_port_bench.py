"""The port's benchmark entry (`comfystereo_tpu_torch/bench.py`) against the
repository's `bench.py`, on the CPU at small sizes.

* the copies of bench.py's numpy and scipy helpers (the CPU baseline's twin,
  SSIM, the oracle's stereo pair, the validation downscale) give bench.py's
  own results bit for bit on seeded inputs;
* the port's `_validate` gives bench.py's `_validate` (JAX on the CPU) within
  1e-6 on configs 1-3's fills, with as many uint8 values off the oracle's as
  JAX's pair has, and config 4's mask parity is equal;
* each config's cases take its frames per call; the lines print the
  accuracy rounded as bench.py does, the functions return it unrounded;
* every run function runs with device="cpu" at toy sizes (TINY diffusion
  configs) and prints bench.py's JSON keys; the default device is CUDA.
"""
import hashlib
import importlib
import importlib.util
import inspect
import json
import os
import pkgutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
import comfystereo_tpu as cs
from comfystereo_tpu_torch import bench as tbench
from comfystereo_tpu_torch.config import StereoConfig
from comfystereo_tpu_torch.diffusion import TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG
from comfystereo_tpu_torch.kernels import KERNELS
from comfystereo_tpu_torch.utils import fixtures
from tests.oracle import stereo_oracle as oracle

H, W = 48, 64

# bench.py's keys, line by line.
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_frame", "baseline_fps",
                 "baseline_kind", "vs_baseline_8core_class", "baseline_host"}
FULL_KEYS = {
    "1_512_naive_sbs": {"config", "fps_per_chip", "fill_region_ssim"},
    "2_1080p_polylines_sweep": {"config", "fps_per_chip", "fps_supersampled", "sweep_points",
                                "fill_region_ssim", "exact_mode_ssim"},
    "3_720p_video_hybrid_edge_tb": {"config", "fps_per_chip", "batch", "fill_region_ssim"},
    "4_4k_warp_anaglyph_mask": {"config", "fps_per_chip", "mask_exact_parity"},
    "5_video2stereo_4k_all_fills": {"config", "fps_per_chip", "fill_techniques",
                                    "balance_sweep"},
}
SD_METRICS = [f"sd15_{m}_{tag}" for tag in ("f32", "bf16") for m in (
    "unet_cfg_step_512px", "unet_step_512px_batch8_per_sample", "vae_decode_512px",
    "ddim_50step_estimate", "nulltext_inner_step", "nulltext_worst_case_estimate")]
SD_DELTA_METRICS = ["sd15_bf16_unet_eps_rel_err", "sd15_w8_unet_eps_rel_err",
                    "sd15_bf16_vae_decode_u8_delta"]
TOY_SHAPES = {1: (H, W, 1), 2: (H, W, 1), 3: (H, W, 2), 4: (54, 96, 1), 5: (54, 96, 2)}


def _frame(h=H, w=W):
    return (fixtures.create_test_image(h, w).astype(np.float32) / 255.0,
            fixtures.create_depth_map(h, w).astype(np.float32))


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _both(**fields):
    """The same config in bench.py's (JAX) and the port's dataclass."""
    return cs.StereoConfig(**fields), StereoConfig(**fields)


def test_cpu_baseline_twins_bit_equal():
    rng = np.random.default_rng(0)
    img_u8 = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    depth = rng.uniform(0, 255, (H, W)).astype(np.float32)
    depth[: H // 2] = fixtures.create_depth_map(H // 2, W)
    for args in ((), (7.0, 1.7, 0.25)):
        want = jbench._cpu_blur_and_offsets(img_u8, depth, *args)
        got = tbench._cpu_blur_and_offsets(img_u8, depth, *args)
        assert len(got) == len(want) == 2
        for (gd, gs), (wd, ws) in zip(got, want):
            assert gs == ws
            np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(tbench._cpu_reference_naive(img_u8, depth, *args),
                                      jbench._cpu_reference_naive(img_u8, depth, *args))
    assert tbench._cpu_model_slug() == jbench._cpu_model_slug()


def test_ssim_helpers_bit_equal():
    rng = np.random.default_rng(1)
    a = rng.random((H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_array_equal(tbench._ssim_map(a[..., 0].astype(np.float64),
                                                   b[..., 0].astype(np.float64)),
                                  jbench._ssim_map(a[..., 0].astype(np.float64),
                                                   b[..., 0].astype(np.float64)))
    for mask in (np.zeros((H, W)), (rng.random((H, W)) > 0.97).astype(np.float32)):
        assert (tbench._fill_region_ssim(a, b, mask)
                == jbench._fill_region_ssim(a, b, mask))


@pytest.mark.parametrize("fields", [
    dict(fill_technique="naive", modes=("left-right",), depth_map_blur=False),
    dict(fill_technique="polylines_sharp", modes=("left-right",), depth_map_blur=True),
    dict(fill_technique="hybrid_edge", modes=("top-bottom",), depth_map_blur=True),
    dict(fill_technique="naive", stereo_balance=1.0, modes=("left-right",)),
])
def test_oracle_sbs_bit_equal(fields):
    img, dm = _frame(32, 40)
    jcfg, tcfg = _both(**fields)
    np.testing.assert_array_equal(tbench._oracle_sbs(img, dm, tcfg, tbench.load_oracle()),
                                  jbench._oracle_sbs(img, dm, jcfg, oracle))


def test_scaled_inputs_bit_equal():
    img, dm = _frame(96, 128)
    for width in (64, 100):
        for got, want in zip(tbench._scaled_inputs(img, dm, width),
                             jbench._scaled_inputs(img, dm, width)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fields,width,tol", [
    (dict(fill_technique="naive", modes=("left-right",), depth_map_blur=False), 96, 1e-6),
    (dict(fill_technique="polylines_sharp", modes=("left-right",), depth_map_blur=True), 64,
     1e-6),
    (dict(fill_technique="polylines_sharp", modes=("left-right",), depth_map_blur=True,
          polylines_exact=False), 96, 1e-6),
    (dict(fill_technique="hybrid_edge", modes=("top-bottom",), depth_map_blur=True), 96, 5e-5),
])
def test_validate_matches_jax_bench(fields, width, tol):
    """Configs 1-3's fills at an oracle width of 64-96, from a 96x160 frame.

    The naive and both polylines fills are bit-equal to JAX in uint8, so the
    SSIM agrees within 1e-6. hybrid_edge is within 1 LSB of JAX
    (`test_torch_port_fills.py`: torch.cumsum rounds its prefix sums in
    another order than XLA's), on about 2% of the values at this size, which
    moves the fill-region SSIM by 1.6e-6 to 1.6e-5 at widths 64-128; it is
    held to its 1 LSB and to 5e-5."""
    img, dm = _frame(96, 160)
    jcfg, tcfg = _both(**fields)
    want, _ = jbench._validate(jcfg, img, dm, width)
    got, off = tbench._validate(tcfg, img, dm, width, device="cpu")
    assert abs(got - want) <= tol, (got, want)
    simg, sdm = jbench._scaled_inputs(img, dm, width)
    j = np.asarray(cs.stereo_pipeline(jnp.asarray(simg[None]), jnp.asarray(sdm[None]),
                                      jcfg)["stereo"][0][0])
    t, _ = tbench._run_scaled(tcfg, simg, sdm, torch.device("cpu"))
    lsb = np.abs(np.round(j * 255) - np.round(t * 255))
    assert lsb.max() <= (0 if tol == 1e-6 else 1)
    oracle_u8 = np.round(jbench._oracle_sbs(simg, sdm, jcfg, oracle) * 255)
    assert off == int((np.round(t * 255) != oracle_u8).sum())
    if tol == 1e-6:  # bit-equal in uint8: as many values off the oracle as JAX's
        assert off == int((np.round(j * 255) != oracle_u8).sum())


def test_mask_parity_matches_jax_bench():
    """Config 4's check as bench.py's run_full makes it: the gap mask of the
    left eye (balance 1) with the blur off against the oracle's."""
    img, dm = _frame(108, 192)
    width = 96
    cfg_nb = cs.StereoConfig(fill_technique="gpu_warp", modes=("left-only",),
                             depth_map_blur=False, stereo_balance=1.0)
    simg, sdm = jbench._scaled_inputs(img, dm, width)
    out_v = cs.stereo_pipeline(jnp.asarray(simg[None]), jnp.asarray(sdm[None]), cfg_nb)
    divl = cfg_nb.eye_divergences()[0] / 100.0 * simg.shape[1]
    _, want_gap = oracle.forward_warp(simg, sdm, +divl, 0.0, cfg_nb.stereo_offset_exponent,
                                      cfg_nb.convergence_point)
    want = float(((np.asarray(out_v["mask"][0]) > 0.5) == want_gap).mean())
    got, launches = tbench._mask_parity(img, dm, width, device="cpu")
    assert got == want
    assert set(launches) == set(KERNELS) and not any(launches.values())


@pytest.mark.parametrize("n", sorted(tbench.CONFIGS))
def test_config_cases_take_the_batch(n):
    """A config's input holds its frames per call, frame i the fixture
    rolled along W; one pass runs every configuration of the line."""
    want_cfgs = {1: 1, 2: 2 * len(tbench.SWEEP), 3: 1, 4: 1,
                 5: len(tbench.FILL_TECHNIQUES) * len(tbench.BALANCES)}[n]
    img, dm = _frame(32, 48)
    for batch in (1, 3):
        cfgs, imgs, dms = tbench.config_cases(n, 32, 48, batch)
        assert len(cfgs) == want_cfgs
        assert imgs.shape == (batch, 32, 48, 3) and dms.shape == (batch, 32, 48)
        shift = 16 if n == 5 else 8
        for i in range(batch):
            np.testing.assert_array_equal(imgs[i], np.roll(img, shift * i, axis=1))
            np.testing.assert_array_equal(dms[i], np.roll(dm, shift * i, axis=1))


def test_printed_rounds_only_the_accuracy():
    r = {"config": "x", "fill_region_ssim": 0.9999999999992818, "exact_mode_ssim": 0.123456789,
         "mask_exact_parity": 0.99999949, "u8_off_oracle": 3, "fps_per_chip": 1.23}
    assert tbench.printed(r) == {"config": "x", "fill_region_ssim": 1.0,
                                 "exact_mode_ssim": 0.12346, "mask_exact_parity": 0.999999,
                                 "u8_off_oracle": 3, "fps_per_chip": 1.23}


def test_run_full_prints_bench_keys(capsys):
    results = tbench.run_full(oracle_width=64, device="cpu", shapes=TOY_SHAPES)
    lines = _json_lines(capsys.readouterr().out)
    assert lines == [tbench.printed(r) for r in results]
    assert [r["config"] for r in lines] == list(FULL_KEYS)
    for r in lines:
        assert FULL_KEYS[r["config"]] <= set(r), r
        assert r["card"] == "cpu"
        assert r["fps_per_chip"] > 0 and r["ms_per_frame"] > 0
        # The counters move only where a kernel launches: on the card.
        assert set(r["launches"]) == set(KERNELS) and not any(r["launches"].values())
    by = {r["config"]: r for r in lines}
    assert 0.5 < by["1_512_naive_sbs"]["fill_region_ssim"] <= 1.0
    assert 0.5 < by["2_1080p_polylines_sweep"]["exact_mode_ssim"] <= 1.0
    assert by["1_512_naive_sbs"]["u8_off_oracle"] >= 0
    assert by["2_1080p_polylines_sweep"]["exact_mode_u8_off_oracle"] >= 0
    assert by["3_720p_video_hybrid_edge_tb"]["batch"] == 2
    assert by["4_4k_warp_anaglyph_mask"]["mask_exact_parity"] > 0.9
    assert by["5_video2stereo_4k_all_fills"]["fill_techniques"] == 11


def _digests():
    out = {}
    for path in (tbench.BASELINE_PATH, tbench.PORT_BASELINE_PATH):
        with open(path, "rb") as f:
            out[path] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_run_headline_keys_and_frozen_baseline(tmp_path, capsys):
    before = _digests()
    record = str(tmp_path / "bench" / "BASELINE_CPU.json")
    r = tbench.run_headline(device="cpu", h=H, w=W, batch=2, iters=2, record_path=record)
    assert HEADLINE_KEYS <= set(r)
    assert _json_lines(capsys.readouterr().out) == [r]
    assert r["metric"] == f"{H}p depth->SBS stereo frames/sec/chip"
    assert r["value"] > 0 and r["card"] == "cpu"
    assert r["baseline_kind"] == "numpy-1thread-standin" or "numba" in r["baseline_kind"]
    assert _digests() == before
    listed = any(r["baseline_host"] in json.load(open(p)) for p in before)
    assert os.path.exists(record) != listed
    if not listed:  # measured once, then read back
        assert r["baseline_host"] in json.load(open(record))
        again = tbench.run_headline(device="cpu", h=H, w=W, batch=2, iters=1,
                                    record_path=record)
        assert again["baseline_fps"] == r["baseline_fps"]


def test_port_baseline_is_read_for_its_host(tmp_path, monkeypatch):
    """Each host of the port's committed BASELINE_CPU.json (the card's) is
    read from it, never measured, and no file is written."""
    hosts = json.load(open(tbench.PORT_BASELINE_PATH))
    assert hosts
    before = _digests()
    record = str(tmp_path / "bench" / "BASELINE_CPU.json")
    for host, rec in hosts.items():
        cores, machine, slug = host.split("-", 2)
        monkeypatch.setattr(os, "cpu_count", lambda: int(cores[:-len("vcpu")]))
        monkeypatch.setattr(tbench.platform, "machine", lambda: machine)
        monkeypatch.setattr(tbench, "_cpu_model_slug", lambda: slug)
        monkeypatch.setattr(tbench, "_cpu_reference_naive", None)  # never measured
        got = tbench._frozen_cpu_baseline(None, None, record)
        assert got == (rec["cpu_fps"], rec["numba_fps"], rec["cores"], host)
    assert not os.path.exists(record) and _digests() == before


def test_run_sd_prints_bench_metrics(capsys):
    results = tbench.run_sd(device="cpu", unet_cfg=TINY_SD_UNET_CONFIG,
                            vae_cfg=TINY_SD_VAE_CONFIG, latent=8, iters=1)
    lines = _json_lines(capsys.readouterr().out)
    assert lines == results
    assert [r["metric"] for r in lines] == SD_METRICS
    for r in lines:
        assert {"metric", "value", "unit"} <= set(r) and r["value"] >= 0


def test_run_sd_delta_prints_bench_metrics(capsys):
    results = tbench.run_sd_delta(device="cpu", unet_cfg=TINY_SD_UNET_CONFIG,
                                  vae_cfg=TINY_SD_VAE_CONFIG, latent=8)
    lines = _json_lines(capsys.readouterr().out)
    assert lines == results
    assert [r["metric"] for r in lines] == SD_DELTA_METRICS
    eps, w8, vae = lines
    assert 0 < eps["value"] < 0.1 and 0 < w8["value"] < 0.2
    assert 0 <= vae["value"] <= vae["max_lsb"] <= 255


def test_run_video_ffv1(capsys):
    r = tbench.run_video(h=H, w=W, n_frames=6, device="cpu", fourcc="FFV1", batch_size=4)
    assert _json_lines(capsys.readouterr().out) == [r]
    assert r["frames"] == 6 and r["value"] > 0
    assert {"metric", "value", "unit", "frames"} <= set(r)


def test_main_dispatches_flags(monkeypatch):
    calls = []
    for name in ("run_headline", "run_full", "run_sd", "run_sd_delta", "run_video"):
        monkeypatch.setattr(tbench, name,
                            lambda *a, _n=name, **k: calls.append((_n, a, k)))
    tbench.main(["--device", "cpu"])
    tbench.main(["--full", "--oracle-width", "128", "--device", "cpu"])
    tbench.main(["--sd"])
    tbench.main(["--sd-delta"])
    tbench.main(["--video"])
    assert calls == [("run_headline", ("cpu",), {}),
                     ("run_headline", ("cpu",), {}), ("run_full", (128, "cpu"), {}),
                     ("run_sd", ("cuda",), {}), ("run_sd_delta", (), {"device": "cuda"}),
                     ("run_video", (), {"device": "cuda"})]


def test_runs_on_the_card_by_default(monkeypatch):
    """No device asked for means CUDA: on a host without one, each entry
    raises before it measures anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (tbench.run_headline, tbench.run_full, tbench.run_sd, tbench.run_sd_delta,
               tbench.run_video):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(tbench.ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _launching(fn) -> bool:
    names = fn.__code__.co_names
    return "LAUNCHES" in names or "_launch" in names


def test_chip_smoke_plain_pass_covers_every_kernel_call_site():
    """chip_smoke.py's plain pass of a bench line swaps in a plain version
    at every place where the pipeline's ops hold a kernel wrapper."""
    import comfystereo_tpu_torch.ops as ops
    smoke = _chip_smoke()
    held = set()
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"comfystereo_tpu_torch.ops.{info.name}")
        for name, obj in vars(mod).items():
            if (inspect.isfunction(obj) and obj.__module__.startswith(
                    "comfystereo_tpu_torch.kernels.") and _launching(obj)):
                held.add((mod.__name__, name))
    sites = {(mod.__name__, name) for mod, name, _ in smoke.plain_call_sites()}
    assert held and held == sites
    wrappers = {(mod, name): getattr(mod, name) for mod, name, _ in smoke.plain_call_sites()}
    with smoke.plain_kernels():
        assert not any(_launching(getattr(mod, name)) for mod, name in wrappers)
    assert all(getattr(mod, name) is fn for (mod, name), fn in wrappers.items())


@pytest.mark.parametrize("n", [4, 5])
def test_chip_smoke_plain_pass_on_the_cpu(n, monkeypatch):
    """The plain pass of configs 4 and 5 at a toy size: on the CPU both
    passes run the plain versions, so every output agrees exactly."""
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "sync", lambda: None)
    cfgs, imgs, dms = tbench.config_cases(n, 36, 64, 2)
    assert smoke.check_bench_plain(f"config {n}", cfgs, imgs, dms,
                                   torch.device("cpu")) == 0.0
