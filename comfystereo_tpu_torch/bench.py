"""Benchmarks of the port for the five BASELINE.md configs, on the card.

    python -m comfystereo_tpu_torch.bench [--full | --sd | --sd-delta | --video]
                                          [--oracle-width N] [--device cuda]

The port's counterpart of the repository's `bench.py`, with its flags and its
JSON keys. The default run prints the headline: 1080p depth->SBS conversion
(gpu_warp with the edge-aware depth blur, the Stereo Image node's defaults)
in frames per second per card, against the frozen CPU baseline. `--full`
then prints one line per BASELINE.json config:

  1. 512x512 synthetic + gradient depth, naive fill, left-right SBS
  2. 1080p single image, polylines fill + depth blur, div/convergence sweep
  3. 720p batched video frames, hybrid-edge fill, top-bottom output
  4. 4K image, gpu_warp fill + red-cyan anaglyph, no_fill mask validation
  5. Video2Stereo workflow: batched 4K, all fill techniques, balance sweep

Accuracy: fill-region SSIM (and exact mask parity for config 4) against the
sequential CPU oracle `tests/oracle/stereo_oracle.py`, loaded by path (it
imports numpy and scipy only), at the reduced `--oracle-width` (the oracle
is interpreted Python); the port's side of it runs on the benchmark's
device. Configs 1-3 also carry the count of uint8 values of the port's
stereo pair that differ from the oracle's. The functions return these
unrounded; the printed lines round them as bench.py's do (`printed`).
Speed is always measured at the config's full size.

Every timed region ends in `utils.profiling.sync` of its output, and each
line gives ms per frame beside fps, the kernel launches of one pass of the
config (the `LAUNCHES` counters of `kernels/`; they move only on the card),
and the card's name and power limit as `nvidia-smi` reports them.

CPU baseline: the vectorised-numpy twin of the reference's naive CPU path
(and its numba twin), frozen per host. `BASELINE_CPU.json` at the repository
root holds the JAX package's hosts, `comfystereo_tpu_torch/BASELINE_CPU.json`
the port's (the card's host); a host either lists is read and never
re-measured. Any other host is measured once and kept in
`build/bench/BASELINE_CPU.json`; neither committed file is ever written.

Runs on the card (`--device cuda`, the default; without a GPU it raises).
`--device cpu` exists for the tests, which run every function at toy sizes.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import platform
import subprocess
import tempfile
import time
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from . import kernels
from .config import FILL_TECHNIQUES, StereoConfig
from .device import DeviceLike, resolve_device
from .pipeline import stereo_pipeline
from .utils import fixtures
from .utils.profiling import sync

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE_PATH = os.path.join(ROOT, "tests", "oracle", "stereo_oracle.py")
BASELINE_PATH = os.path.join(ROOT, "BASELINE_CPU.json")
PORT_BASELINE_PATH = os.path.join(ROOT, "comfystereo_tpu_torch", "BASELINE_CPU.json")
HOST_BASELINE_PATH = os.path.join(ROOT, "build", "bench", "BASELINE_CPU.json")

# (height, width, frames per call) of each BASELINE config at full size.
FULL_SHAPES = {1: (512, 512, 1), 2: (1080, 1920, 1), 3: (720, 1280, 12),
               4: (2160, 3840, 1), 5: (2160, 3840, 2)}
# (height, width, frames per call) of the headline.
HEADLINE_SHAPE = (1080, 1920, 4)
# Config 2's (divergence, convergence) sweep and config 5's balances.
SWEEP = ((2.0, 0.5), (4.5, 0.5), (4.5, 0.0), (7.0, 1.0))
BALANCES = (0.0, 0.5)
# Decimals of the accuracy keys in the printed lines (bench.py's).
ACCURACY_DECIMALS = {"fill_region_ssim": 5, "exact_mode_ssim": 5, "mask_exact_parity": 6}


# ---------------------------------------------------------------------------
# CPU baseline (numpy and scipy only)
# ---------------------------------------------------------------------------

def _cpu_blur_and_offsets(img_u8, depth, divergence=4.5, exponent=2.0,
                          convergence=0.5):
    """Shared preamble of the CPU baseline: directional blur (reference
    :1346-1419, scipy-vectorised there too) + per-eye integer scatter
    destinations. Both the numpy twin and the numba twin consume this, so
    their only difference is the scatter kernel itself."""
    from scipy.ndimage import convolve1d, sobel

    h, w, _ = img_u8.shape
    d = depth.astype(np.float32)

    # directional blur defaults of the node
    n = 20
    grad = sobel(d, axis=1)
    edge = np.clip(np.abs(grad) / (10 * 20.0), 0, 1)
    masks = [(grad > 0) & (edge > 0.5), (grad < 0) & (edge > 0.5)]
    cols = np.arange(w, dtype=np.float32)
    blurred = convolve1d(d, np.ones(n) / n, axis=1, mode="nearest")
    dests = []
    for m, sign in zip(masks, (+1.0, -1.0)):
        cl = np.where(m, cols, -1.0)
        ll = np.maximum.accumulate(cl, axis=1)
        dist_l = np.where(ll >= 0, cols - ll, 21.0)
        cr = np.where(m[:, ::-1], cols, -1.0)
        lr = np.maximum.accumulate(cr, axis=1)
        dist_r = np.where(lr >= 0, cols - lr, 21.0)[:, ::-1]
        wgt = np.clip(1.0 - np.minimum(dist_l, dist_r) / 20.0, 0, 1) ** 2.0
        wgt = np.clip(convolve1d(wgt, np.ones(13) / 13, axis=0,
                                 mode="nearest"), 0, 1)
        dd = wgt * blurred + (1 - wgt) * d
        nd = (dd - dd.min()) / max(dd.max() - dd.min(), 1e-6) - convergence
        off = np.sign(nd) * np.abs(nd) ** exponent * (
            sign * divergence / 100.0 * w)
        dest = (np.arange(w)[None, :] + np.trunc(off)).astype(np.int64)
        np.clip(dest, 0, w - 1, out=dest)
        dests.append((dest, sign))
    return dests


def _cpu_reference_naive(img_u8, depth, divergence=4.5, exponent=2.0,
                         convergence=0.5):
    """Vectorised numpy twin of the reference CPU naive path (both eyes + SBS
    pack + directional blur), used as the baseline denominator."""
    h = img_u8.shape[0]
    out = []
    for dest, sign in _cpu_blur_and_offsets(img_u8, depth, divergence,
                                            exponent, convergence):
        rowi = np.arange(h)[:, None]
        derived = np.zeros_like(img_u8)
        order = slice(None, None, -1) if sign > 0 else slice(None)
        derived[rowi, dest[:, order]] = img_u8[:, order]
        out.append(derived)
    return np.concatenate(out, axis=1)


def _cpu_model_slug() -> str:
    """Short CPU model identifier, so a frozen baseline is reused only on a
    comparable host."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    return "".join(c if c.isalnum() else "-"
                                   for c in name).strip("-")[:48]
    except OSError:
        pass
    return "unknown-cpu"


def _numba_baseline_fps(img_u8, dm255) -> Optional[float]:
    """The reference's kernel family is numba `@njit(parallel=True)` with
    `prange` over rows. Where numba imports, this measures a prange twin of
    the naive scatter behind the shared numpy blur preamble; else None."""
    try:
        import numba
    except ImportError:
        return None

    @numba.njit(parallel=True, cache=False)
    def scatter(img, dest, reverse):
        h, w, c = img.shape
        out = np.zeros_like(img)
        for y in numba.prange(h):
            if reverse:
                for x in range(w - 1, -1, -1):
                    d = dest[y, x]
                    for k in range(c):
                        out[y, d, k] = img[y, x, k]
            else:
                for x in range(w):
                    d = dest[y, x]
                    for k in range(c):
                        out[y, d, k] = img[y, x, k]
        return out

    def one_frame():
        outs = [scatter(img_u8, dest, sign > 0)
                for dest, sign in _cpu_blur_and_offsets(img_u8, dm255)]
        return np.concatenate(outs, axis=1)

    one_frame()  # JIT warm-up, excluded as the reference caches its JIT
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(3):
            one_frame()
        best = min(best, (time.perf_counter() - t0) / 3)
    return 1.0 / best


def _read_record(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def _frozen_cpu_baseline(img_u8, dm255, record_path: str = HOST_BASELINE_PATH
                         ) -> Tuple[float, Optional[float], int, str]:
    """(cpu_fps, numba_fps or None, cores, host label) of this host: from
    the repository's or the port's `BASELINE_CPU.json` where one lists the
    host, else from `record_path`, else measured (best of 3 x 3 frames) and
    written to `record_path`."""
    host = f"{os.cpu_count()}vcpu-{platform.machine()}-{_cpu_model_slug()}"
    for path in (BASELINE_PATH, PORT_BASELINE_PATH, record_path):
        r = _read_record(path).get(host)
        if r is not None:
            return (float(r["cpu_fps"]), r.get("numba_fps"),
                    int(r.get("cores", os.cpu_count() or 1)), host)

    _cpu_reference_naive(img_u8, dm255)  # warm caches
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(3):
            _cpu_reference_naive(img_u8, dm255)
        best = min(best, (time.perf_counter() - t0) / 3)
    cpu_fps = 1.0 / best
    numba_fps = _numba_baseline_fps(img_u8, dm255)
    record = _read_record(record_path)
    record[host] = {"cpu_fps": round(cpu_fps, 4),
                    "numba_fps": round(numba_fps, 4) if numba_fps else None,
                    "cores": os.cpu_count() or 1,
                    "measured": time.strftime("%Y-%m-%d"),
                    "frame": list(img_u8.shape[:2]),
                    "what": "cpu_fps: vectorized-numpy twin of the reference CPU "
                            "naive path, single frame, best-of-3x3; numba_fps: "
                            "prange scatter twin (null when numba is not installed)"}
    os.makedirs(os.path.dirname(record_path), exist_ok=True)
    with open(record_path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    return cpu_fps, numba_fps, os.cpu_count() or 1, host


# ---------------------------------------------------------------------------
# Accuracy against the CPU oracle
# ---------------------------------------------------------------------------

def load_oracle(path: str = ORACLE_PATH):
    """`tests/oracle/stereo_oracle.py`, loaded by path."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"the CPU oracle is not at {path}")
    spec = importlib.util.spec_from_file_location("stereo_oracle", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ssim_map(a, b):
    """SSIM map on [H,W] grayscale float 0-1, 7x7 uniform window."""
    from scipy.ndimage import uniform_filter

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_a = uniform_filter(a, 7)
    mu_b = uniform_filter(b, 7)
    va = uniform_filter(a * a, 7) - mu_a ** 2
    vb = uniform_filter(b * b, 7) - mu_b ** 2
    cov = uniform_filter(a * b, 7) - mu_a * mu_b
    return ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
            / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)))


def _fill_region_ssim(mine01, oracle01, mask):
    """Mean SSIM over the fill-imperfection region (BASELINE acceptance
    metric); the full frame when the mask is empty."""
    ga = mine01.mean(axis=-1)
    gb = oracle01.mean(axis=-1)
    smap = _ssim_map(ga.astype(np.float64), gb.astype(np.float64))
    region = mask > 0.5
    if not region.any():
        return float(smap.mean())
    from scipy.ndimage import binary_dilation

    region = binary_dilation(region, iterations=3)  # include fill borders
    return float(smap[region].mean())


def _oracle_sbs(img01, depth255, cfg, oracle):
    """CPU-oracle stereo pair (first mode) for a single frame, uint8/255."""
    d = depth255
    if cfg.depth_map_blur and cfg.depth_blur_strength > 0:
        ld, rd = oracle.directional_motion_blur(
            d, cfg.depth_blur_strength, cfg.depth_blur_edge_threshold,
            cfg.depth_blur_strength, cfg.depth_blur_falloff,
            cfg.depth_blur_vert_smooth)
    else:
        ld = rd = d
    img_u8 = np.trunc(np.clip(img01 * 255.0, 0, 255)).astype(np.float32)
    divl, divr = cfg.eye_divergences()
    left = img_u8 if divl < 0.001 else oracle.dispatch(
        img_u8, ld, +divl, -cfg.separation, cfg.stereo_offset_exponent,
        cfg.fill_technique, cfg.convergence_point)
    right = img_u8 if divr < 0.001 else oracle.dispatch(
        img_u8, rd, -divr, +cfg.separation, cfg.stereo_offset_exponent,
        cfg.fill_technique, cfg.convergence_point)
    mode = cfg.modes[0]
    if mode == "top-bottom":
        return np.concatenate([left, right], axis=0) / 255.0
    return np.concatenate([left, right], axis=1) / 255.0


def _scaled_inputs(img01, depth, width):
    """Downscale a frame pair for the oracle-validation pass."""
    from PIL import Image

    h, w = depth.shape
    nh = max(32, int(round(h * width / w)))
    im = Image.fromarray((img01 * 255).astype(np.uint8)).resize(
        (width, nh), Image.BILINEAR)
    dm = Image.fromarray(depth.astype(np.float32), mode="F").resize(
        (width, nh), Image.BILINEAR)
    return np.asarray(im, np.float32) / 255.0, np.asarray(dm, np.float32)


def _run_scaled(cfg, simg, sdepth, dev):
    x, d = _on(dev, simg[None], sdepth[None])
    out = stereo_pipeline(x, d, cfg)
    return (out["stereo"][0][0].float().cpu().numpy(),
            out["mask"][0].float().cpu().numpy())


def _u8(x01):
    return np.round(x01 * 255.0).astype(np.int32)


def _validate(cfg, img01, depth, oracle_width, device: DeviceLike = None, oracle=None):
    """(fill-region SSIM, uint8 values that differ) of the port on `device`
    against the CPU oracle at the validation width. bench.py's `_validate`
    returns the SSIM and None."""
    dev = resolve_device(device)
    oracle = oracle or load_oracle()
    simg, sdepth = _scaled_inputs(img01, depth, oracle_width)
    mine, mask = _run_scaled(cfg, simg, sdepth, dev)
    want = _oracle_sbs(simg, sdepth, cfg, oracle)
    if mine.shape != want.shape:  # anaglyph and friends: crop to first mode
        want = want[:mine.shape[0], :mine.shape[1]]
    if mask.shape != mine.shape[:2]:  # gpu_warp mask is per-eye [H,W]
        axis = 0 if cfg.modes[0] == "top-bottom" else 1
        mask = np.concatenate([mask, mask], axis=axis)
        if mask.shape != mine.shape[:2]:
            mask = np.ones(mine.shape[:2])
    return _fill_region_ssim(mine, want, mask), int((_u8(mine) != _u8(want)).sum())


def _mask_parity(img01, depth, oracle_width, device: DeviceLike = None, oracle=None):
    """Config 4's check: the gpu_warp gap mask with the blur off and all the
    divergence on the left eye (balance 1, so the right eye is the copied
    source) against the sequential z-buffer oracle's, at the validation
    width. Returns (share of equal pixels, the launches of that call)."""
    dev = resolve_device(device)
    oracle = oracle or load_oracle()
    cfg = StereoConfig(fill_technique="gpu_warp", modes=("left-only",),
                       depth_map_blur=False, stereo_balance=1.0)
    simg, sdm = _scaled_inputs(img01, depth, oracle_width)
    (_, mask), launches = _launches(lambda: _run_scaled(cfg, simg, sdm, dev))
    divl = cfg.eye_divergences()[0] / 100.0 * simg.shape[1]
    _, want_gap = oracle.forward_warp(simg, sdm, +divl, 0.0,
                                      cfg.stereo_offset_exponent,
                                      cfg.convergence_point)
    return float(((mask > 0.5) == want_gap).mean()), launches


# ---------------------------------------------------------------------------
# Timing and launch counts
# ---------------------------------------------------------------------------

def _launches(fn):
    """(fn(), the launches of each kernel during it)."""
    before = kernels.launch_counts()
    out = fn()
    after = kernels.launch_counts()
    return out, {k: after[k] - before[k] for k in kernels.KERNELS}


def _ms(fn, iters):
    """Mean ms per call of `fn` over `iters` calls after one warm-up call;
    the clock stops once the last call's output is complete."""
    sync(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    sync(out)
    return (time.perf_counter() - t0) / iters * 1e3


def _time_fps(fn, frames_per_call, iters=10):
    return frames_per_call * 1e3 / _ms(fn, iters)


def card(device: DeviceLike = None) -> str:
    """The card's name and power limit (`nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`); "cpu" for a CPU run."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _frame(h, w):
    return (fixtures.create_test_image(h, w).astype(np.float32) / 255.0,
            fixtures.create_depth_map(h, w).astype(np.float32))


def _on(dev, *arrays):
    return tuple(torch.tensor(np.ascontiguousarray(a), device=dev) for a in arrays)


def _rate(fps: float) -> dict:
    return {"fps_per_chip": round(fps, 2), "ms_per_frame": round(1e3 / fps, 4)}


def printed(result: dict) -> dict:
    """A result as its line prints it: the accuracy keys rounded as bench.py
    rounds them (the functions return them unrounded)."""
    return {k: round(v, ACCURACY_DECIMALS[k]) if k in ACCURACY_DECIMALS else v
            for k, v in result.items()}


# ---------------------------------------------------------------------------
# Full mode: the five BASELINE configs
# ---------------------------------------------------------------------------

def config_cases(n: int, h: int, w: int, batch: int):
    """BASELINE config `n`'s pipeline configurations in the order of one
    pass, and the input of each call: `batch` frames [B, H, W, 3] in 0-1 and
    depths [B, H, W] in 0-255, frame i the fixture rolled by 8 i columns
    (16 i in config 5)."""
    img, dm = _frame(h, w)
    shift = 16 if n == 5 else 8
    imgs = np.stack([np.roll(img, shift * i, axis=1) for i in range(batch)])
    dms = np.stack([np.roll(dm, shift * i, axis=1) for i in range(batch)])
    if n == 1:
        cfgs = [StereoConfig(fill_technique="naive", modes=("left-right",),
                             depth_map_blur=False)]
    elif n == 2:  # the sweep in exact mode, then supersampled
        exact = [StereoConfig(fill_technique="polylines_sharp", divergence=dv,
                              convergence_point=cv, modes=("left-right",),
                              depth_map_blur=True) for dv, cv in SWEEP]
        cfgs = exact + [dataclasses.replace(c, polylines_exact=False) for c in exact]
    elif n == 3:
        cfgs = [StereoConfig(fill_technique="hybrid_edge", modes=("top-bottom",),
                             depth_map_blur=True)]
    elif n == 4:
        cfgs = [StereoConfig(fill_technique="gpu_warp", modes=("red-cyan-anaglyph",),
                             depth_map_blur=True)]
    elif n == 5:
        cfgs = [StereoConfig(fill_technique=t, stereo_balance=b, modes=("left-right",),
                             depth_map_blur=True)
                for t in FILL_TECHNIQUES for b in BALANCES]
    else:
        raise ValueError(f"no BASELINE config {n}")
    return cfgs, imgs, dms


def headline_case(h: int, w: int, batch: int):
    """As `config_cases`, for the headline: its one configuration (the
    Stereo Image node's defaults) and `batch` copies of the fixture, depth
    in 0-1."""
    img, dm = _frame(h, w)
    return ([StereoConfig(modes=("left-right",), fill_technique="gpu_warp")],
            np.stack([img] * batch), np.stack([dm / 255.0] * batch))


def _sweep_fps(cfgs, x, d, iters=3):
    """fps over `iters` passes of the configs, and the launches of one pass."""
    def one_pass():
        return [stereo_pipeline(x, d, c) for c in cfgs]
    _, launches = _launches(one_pass)
    return _time_fps(one_pass, len(cfgs) * x.shape[0], iters), launches


def config_1(dev, oracle, oracle_width, h=512, w=512, batch=1):
    """512x512 synthetic, naive fill, SBS."""
    cfgs, imgs, dms = config_cases(1, h, w, batch)
    fps, launches = _sweep_fps(cfgs, *_on(dev, imgs, dms), iters=10)
    ssim, off = _validate(cfgs[0], imgs[0], dms[0], oracle_width, dev, oracle)
    return {"config": "1_512_naive_sbs", **_rate(fps), "fill_region_ssim": ssim,
            "u8_off_oracle": off, "launches": launches}


def config_2(dev, oracle, oracle_width, h=1080, w=1920, batch=1):
    """1080p polylines + blur, divergence/convergence sweep: the exact
    integration (the default, uint8 bit-parity with the CPU oracle) and
    the supersampled mode."""
    cfgs, imgs, dms = config_cases(2, h, w, batch)
    x, d = _on(dev, imgs, dms)
    exact, ss = cfgs[:len(SWEEP)], cfgs[len(SWEEP):]
    fps, launches = _sweep_fps(exact, x, d)
    fps_ss, launches_ss = _sweep_fps(ss, x, d)
    ssim_exact, off_exact = _validate(exact[1], imgs[0], dms[0], min(oracle_width, 256), dev,
                                      oracle)
    ssim_ss, off_ss = _validate(ss[1], imgs[0], dms[0], oracle_width, dev, oracle)
    return {"config": "2_1080p_polylines_sweep", **_rate(fps),
            "fps_supersampled": round(fps_ss, 2),
            "ms_per_frame_supersampled": round(1e3 / fps_ss, 4),
            "sweep_points": len(exact),
            "fill_region_ssim": ssim_ss, "u8_off_oracle": off_ss,
            "exact_mode_ssim": ssim_exact, "exact_mode_u8_off_oracle": off_exact,
            "launches": launches, "launches_supersampled": launches_ss}


def config_3(dev, oracle, oracle_width, h=720, w=1280, batch=12):
    """720p batched video frames, hybrid_edge, top-bottom."""
    cfgs, imgs, dms = config_cases(3, h, w, batch)
    fps, launches = _sweep_fps(cfgs, *_on(dev, imgs, dms))
    ssim, off = _validate(cfgs[0], imgs[0], dms[0], oracle_width, dev, oracle)
    return {"config": "3_720p_video_hybrid_edge_tb", **_rate(fps), "batch": batch,
            "fill_region_ssim": ssim, "u8_off_oracle": off, "launches": launches}


def config_4(dev, oracle, oracle_width, h=2160, w=3840, batch=1):
    """4K gpu_warp + anaglyph; mask validation against the oracle."""
    cfgs, imgs, dms = config_cases(4, h, w, batch)
    fps, launches = _sweep_fps(cfgs, *_on(dev, imgs, dms))
    parity, mask_launches = _mask_parity(imgs[0], dms[0], oracle_width, dev, oracle)
    return {"config": "4_4k_warp_anaglyph_mask", **_rate(fps),
            "mask_exact_parity": parity, "launches": launches,
            "mask_check_launches": mask_launches}


def config_5(dev, oracle, oracle_width, h=2160, w=3840, batch=2):
    """Video2Stereo workflow: batched 4K, every fill, balance sweep."""
    del oracle, oracle_width
    cfgs, imgs, dms = config_cases(5, h, w, batch)
    fps, launches = _sweep_fps(cfgs, *_on(dev, imgs, dms), iters=1)
    return {"config": "5_video2stereo_4k_all_fills", **_rate(fps),
            "fill_techniques": len(FILL_TECHNIQUES),
            "balance_sweep": len(BALANCES), "launches": launches}


CONFIGS = {1: config_1, 2: config_2, 3: config_3, 4: config_4, 5: config_5}


def run_full(oracle_width=512, device: DeviceLike = "cuda",
             shapes: Mapping[int, Tuple[int, int, int]] = FULL_SHAPES):
    """The five configs at `shapes` ((height, width, frames per call) by
    config; the full sizes by default), one JSON line each. Returns the
    results unrounded."""
    dev = resolve_device(device)
    oracle = load_oracle()
    label = card(dev)
    results = []
    for n, fn in CONFIGS.items():
        h, w, batch = shapes[n]
        r = dict(fn(dev, oracle, oracle_width, h, w, batch), card=label)
        print(json.dumps(printed(r)), flush=True)
        results.append(r)
    return results


# ---------------------------------------------------------------------------
# Headline
# ---------------------------------------------------------------------------

def run_headline(device: DeviceLike = "cuda", h=HEADLINE_SHAPE[0], w=HEADLINE_SHAPE[1],
                 batch=HEADLINE_SHAPE[2], iters=10, record_path: str = HOST_BASELINE_PATH):
    """1080p depth->SBS frames/sec/chip with the node's defaults, against
    the frozen CPU baseline of this host."""
    dev = resolve_device(device)
    cfgs, imgs, depths = headline_case(h, w, batch)
    fps, launches = _sweep_fps(cfgs, *_on(dev, imgs, depths), iters)

    img_u8 = (imgs[0] * 255).astype(np.uint8)
    dm255 = (depths[0] * 255).astype(np.float32)
    cpu_fps, numba_fps, cores, base_host = _frozen_cpu_baseline(img_u8, dm255,
                                                                record_path)
    # With numba the denominator is the measured multicore twin; without
    # it, the single-thread numpy twin, with a linear 8-core projection.
    if numba_fps:
        den, den_kind = float(numba_fps), f"numba-{cores}core-measured"
        per_core = den / max(cores, 1)
    else:
        den, den_kind = cpu_fps, "numpy-1thread-standin"
        per_core = cpu_fps
    result = {
        "metric": f"{h}p depth->SBS stereo frames/sec/chip",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps / den, 2),
        "ms_per_frame": round(1e3 / fps, 4),
        "baseline_fps": round(den, 3),
        "baseline_kind": den_kind,
        "vs_baseline_8core_class": round(fps / (per_core * 8.0), 2),
        "baseline_host": base_host,
        "batch": batch,
        "launches": launches,
        "card": card(dev),
    }
    print(json.dumps(result), flush=True)
    return result


# ---------------------------------------------------------------------------
# StereoDiffusion
# ---------------------------------------------------------------------------

def _measure_sd_stack(dtype, tag, device: DeviceLike = "cuda", unet_cfg=None,
                      vae_cfg=None, latent=64, iters=10):
    """CFG UNet step, batch-8 UNet step, VAE decode and one null-text inner
    step at the reference's operating point (512x512, CFG) in one compute
    dtype. Weights are zeros (the same operations; built at once)."""
    from .diffusion import porting

    dev = resolve_device(device)
    model = porting.build_sd_model(unet_cfg, vae_cfg, dtype=dtype, device=dev,
                                   init_mode="zeros")
    ch, ctx_dim = model.unet_in_channels, model.context_dim

    def zeros(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=dev)

    with torch.no_grad():
        lat, ctx = zeros(2, ch, latent, latent), zeros(2, 77, ctx_dim)
        step_ms = _ms(lambda: model.unet_apply(lat, 500, ctx), iters)
        # Per-sample cost at batch 8, the batched Fast video path's.
        lat8, ctx8 = zeros(8, ch, latent, latent), zeros(8, 77, ctx_dim)
        b8_ms = _ms(lambda: model.unet_apply(lat8, 500, ctx8), iters)
        z = zeros(1, model.latent_channels, latent, latent)
        dec_ms = _ms(lambda: model.vae_decode(z), max(iters // 2, 1))

    # Null-text inner step: UNet forward and backward with respect to the
    # unconditional embedding, which stays float32 while the model computes
    # in `dtype`.
    lat1 = zeros(1, ch, latent, latent, dt=dtype)
    target = lat1.float()
    u0 = zeros(1, 77, ctx_dim)

    def nt_inner():
        u = u0.clone().requires_grad_(True)
        eps = model.unet_apply(lat1, 500, u)
        loss = torch.mean((eps - target) ** 2)
        (grad,) = torch.autograd.grad(loss, u)
        return grad

    nt_ms = _ms(nt_inner, max(iters // 2, 1))
    return [
        {"metric": f"sd15_unet_cfg_step_512px_{tag}",
         "value": round(step_ms, 2), "unit": "ms"},
        {"metric": f"sd15_unet_step_512px_batch8_per_sample_{tag}",
         "value": round(b8_ms / 8, 2), "unit": "ms/sample"},
        {"metric": f"sd15_vae_decode_512px_{tag}",
         "value": round(dec_ms, 2), "unit": "ms"},
        {"metric": f"sd15_ddim_50step_estimate_{tag}",
         "value": round(50 * step_ms / 1e3 + dec_ms / 1e3, 2), "unit": "s"},
        {"metric": f"sd15_nulltext_inner_step_{tag}",
         "value": round(nt_ms, 2), "unit": "ms"},
        {"metric": f"sd15_nulltext_worst_case_estimate_{tag}",
         "value": round(500 * nt_ms / 1e3, 1), "unit": "s",
         "reference": "~2-3 min on a modern GPU (README.md:263)"},
    ]


def run_sd(device: DeviceLike = "cuda", unet_cfg=None, vae_cfg=None, latent=64,
           iters=10):
    """StereoDiffusion compute times, float32 and bf16, full width by
    default."""
    dev = resolve_device(device)
    label = card(dev)
    results = []
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        results += _measure_sd_stack(dtype, tag, dev, unet_cfg, vae_cfg, latent,
                                     iters)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for r in results:
        r["card"] = label
        print(json.dumps(r), flush=True)
    return results


def run_sd_delta(seed=0, device: DeviceLike = "cuda", unet_cfg=None, vae_cfg=None,
                 latent=64):
    """bf16 and w8 against float32 on the same seeded random weights: the
    UNet eps error relative to its mean size, and the VAE decode's uint8
    delta."""
    from .diffusion import porting

    dev = resolve_device(device)
    m32 = porting.build_sd_model(unet_cfg, vae_cfg, dtype=torch.float32, seed=seed,
                                 device=dev)
    states = dict(unet_state=m32.unet.state_dict(), vae_state=m32.vae.state_dict())
    m16 = porting.build_sd_model(unet_cfg, vae_cfg, dtype=torch.bfloat16, device=dev,
                                 **states)
    mw8 = porting.build_sd_model(unet_cfg, vae_cfg, dtype=torch.bfloat16, device=dev,
                                 weight_quant=True, **states)
    gen = torch.Generator().manual_seed(seed + 1)
    ch = m32.unet_in_channels
    lat = torch.randn((2, ch, latent, latent), generator=gen).to(dev)
    ctx = (torch.randn((2, 77, m32.context_dim), generator=gen) * 0.4).to(dev)

    with torch.no_grad():
        e32 = m32.unet_apply(lat, 500, ctx)
        scale = max(float(e32.abs().mean()), 1e-9)
        eps_err = float((e32 - m16.unet_apply(lat, 500, ctx)).abs().mean()) / scale
        w8_err = float((e32 - mw8.unet_apply(lat, 500, ctx)).abs().mean()) / scale
        z = lat[:1, :m32.latent_channels]
        d32, d16 = m32.vae_decode(z), m16.vae_decode(z)

    def to_u8(x):
        return torch.trunc(torch.clamp(x / 2 + 0.5, 0, 1) * 255).to(torch.int32)

    du = (to_u8(d32) - to_u8(d16)).abs()
    label = card(dev)
    results = [
        {"metric": "sd15_bf16_unet_eps_rel_err", "value": round(eps_err, 5),
         "unit": "mean_abs/scale"},
        {"metric": "sd15_w8_unet_eps_rel_err", "value": round(w8_err, 5),
         "unit": "mean_abs/scale"},
        {"metric": "sd15_bf16_vae_decode_u8_delta",
         "value": float(du.float().mean()), "unit": "mean_lsb",
         "max_lsb": int(du.max())},
    ]
    for r in results:
        r["card"] = label
        print(json.dumps(r), flush=True)
    return results


# ---------------------------------------------------------------------------
# Video
# ---------------------------------------------------------------------------

def run_video(h=720, w=1280, n_frames=48, device: DeviceLike = "cuda",
              fourcc: str = "mp4v", batch_size: int = 12):
    """End-to-end Video2Stereo throughput: cv2 decode -> uint8 upload ->
    the chunk program on the device -> uint8 download -> cv2 encode, with
    `convert_video`'s producer and consumer threads (BASELINE config 5's
    workflow shape, examples/Video2Stereo.json). The two input videos are
    written first, with `fourcc` (mp4v to .mp4, FFV1 to .avi)."""
    from .utils import video

    dev = resolve_device(device)
    if not video.CV2_AVAILABLE:
        raise RuntimeError("--video needs cv2 (opencv-python), which is not installed")
    cv2 = video.cv2
    ext = ".avi" if fourcc == "FFV1" else ".mp4"
    base_img = fixtures.create_test_image(h, w).astype(np.uint8)
    base_dm = np.stack([fixtures.create_depth_map(h, w)] * 3, -1).astype(np.uint8)
    cfg = StereoConfig(modes=("left-right",), fill_technique="gpu_warp",
                       batch_size=batch_size)
    with tempfile.TemporaryDirectory(prefix="bench_video_") as tmp:
        src, dep, out = (os.path.join(tmp, f + ext) for f in ("src", "dep", "out"))
        for path, base in ((src, base_img), (dep, base_dm)):
            wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), 30, (w, h))
            for i in range(n_frames):
                wr.write(cv2.cvtColor(np.roll(base, 4 * i, axis=1),
                                      cv2.COLOR_RGB2BGR))
            wr.release()
        video.convert_video(src, dep, out, cfg, progress=False, device=dev)  # warm
        t0 = time.perf_counter()
        total = video.convert_video(src, dep, out, cfg, progress=False, device=dev)
        dt = time.perf_counter() - t0
    result = {"metric": f"video2stereo_{h}p_end_to_end",
              "value": round(total / dt, 2), "unit": "frames/sec",
              "frames": total, "ms_per_frame": round(dt / total * 1e3, 4),
              "card": card(dev)}
    print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--full", action="store_true",
                        help="benchmark all five BASELINE configs")
    parser.add_argument("--sd", action="store_true",
                        help="benchmark the SD-1.5-scale diffusion stack "
                             "(f32 + bf16)")
    parser.add_argument("--sd-delta", action="store_true",
                        help="bf16 and w8 against f32 on random SD-scale weights")
    parser.add_argument("--video", action="store_true",
                        help="end-to-end video decode->stereo->encode bench")
    parser.add_argument("--oracle-width", type=int, default=512,
                        help="validation width for the pure-python oracle")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only for tests)")
    args = parser.parse_args(argv)

    if args.sd:
        run_sd(args.device)
        return
    if args.sd_delta:
        run_sd_delta(device=args.device)
        return
    if args.video:
        run_video(device=args.device)
        return
    run_headline(args.device)
    if args.full:
        run_full(args.oracle_width, args.device)


if __name__ == "__main__":
    main()
