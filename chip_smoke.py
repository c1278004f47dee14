#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the repository root (it imports `comfystereo_tpu_torch` from
beside itself; it never imports JAX or `comfystereo_tpu`). Phases, in order;
any failure ends the run with a non-zero exit code:

1. device: the card's name and power limit; build all four kernels with
   nvcc (sm_90a, one nvcc per source, all started together);
2. kernels vs their plain PyTorch versions on the card, at the main path's
   shapes (12 frames of 1080x1920 as [12*1080, 1920] rows): the warp on the
   fixture depth and on uniform-noise depth, divergence +-4.5% of the width
   with separation 0 and 1% (gap masks bit-equal; colours atol 1e-5 on the
   fixture, < 0.1% of pixels differing on noise), and the edge-distance
   transform (bit-equal); the bounded gather against torch.gather at the
   fills' shapes, int32 keys and a [B,1,H,W] index plane over [B,3,H,W]
   colour (bit-equal); the exact polylines against its plain version on
   the same 12 frames, sharp and soft, divergence +-4.5% with separation 0
   and 1%, fixture and noise depth (bit-equal);
3. the main paths at full size, each with every launch counter set to 0 just
   before and read just after: StereoImageNode().generate on 12 frames of
   1920x1080 with the default config (gpu_warp, depth blur, left-right,
   batch_size=12: warp 2, distance 1), then device_chunk on the same frames
   as uint8 BGR; the node with "Fill - Polylines Sharp" (polylines 2,
   distance 1, warp 0); stereo_pipeline once for each other fill at 1080p
   B=12 (gather launches printed; every gather fill must launch it);
4. card vs CPU: the port's stereo_pipeline on 2 frames of 270x480 on the card
   and on the CPU, gpu_warp and all ten fills, to the slice's tolerances;
5. times with CUDA events (warm-up, then >= 10 iterations, fewer for the
   slowest plain versions): each kernel and its plain version at the main
   path's shapes beside the bound (and torch.gather beside the gather), the
   gpu_warp pipeline's ms/frame and fps at 1080p, batch 12, in float32 and
   bfloat16, and the fills' ms/frame at the same size, with stage breakdowns
   and device idle shares for gpu_warp and polylines_sharp.

It prints one `kernels` JSON line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Without CUDA, or without the package beside
it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FRAMES, HEIGHT, WIDTH = 12, 1080, 1920
DIV_PCT, SEP_PCTS = 4.5, (0.0, 1.0)
FILLS = ("none", "naive", "naive_interpolating", "none_post", "inverse",
         "inverse_post", "hybrid_edge", "hybrid_edge_plus", "polylines_soft",
         "polylines_sharp")
GATHER_FILLS = FILLS[:8]
# Largest share of uint8 values in which the hybrid fills may differ (by 1)
# card vs CPU in phase 4: the 29% measured there, with room to spare.
HYBRID_SHARE = 0.35

# Published peaks (NVIDIA data sheets, SXM parts, at the full power limit):
# device-memory bytes/s and float32 FLOP/s outside the tensor cores.
_PEAKS = {"H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    """(bytes/s, float32 FLOP/s) of the card named `name`; an unknown card
    is measured against the H100 SXM and says so."""
    key = "H200" if "H200" in name else "H100"
    return key, _PEAKS[key]


def sync() -> None:
    import torch
    torch.cuda.synchronize()


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean ms per call over `iters` calls, timed with CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


# --- inputs ---------------------------------------------------------------

def fixture_frames(n: int, h: int, w: int):
    """n frames (uint8 RGB [n,h,w,3], uint8 depth [n,h,w]) of the fixture
    scene, each shifted sideways so no two frames are equal."""
    import numpy as np
    from comfystereo_tpu_torch.utils import fixtures
    img = fixtures.create_test_image(h, w)
    dm = fixtures.create_depth_map(h, w)
    shift = max(1, w // 97)
    imgs = np.stack([np.roll(img, shift * i, axis=1) for i in range(n)])
    deps = np.stack([np.roll(dm, shift * i, axis=1) for i in range(n)])
    return imgs, deps


def warp_rows_inputs(image, depth255, div_pct: float, sep_pct: float):
    """The warp kernel's row arguments, computed as ops/warp.forward_warp
    computes them (normalized depth, offsets, max_disp)."""
    import math
    from comfystereo_tpu_torch.ops import depth as depth_ops
    b, h, w, c = image.shape
    div_px, sep_px = depth_ops.percent_to_px(div_pct, sep_pct, w)
    nd = depth_ops.normalize_depth(depth255)
    off = depth_ops.pixel_offsets(nd, div_px, sep_px, 2.0, 0.5, prenormalized=True)
    max_disp = int(math.ceil(0.5 ** 2.0 * abs(div_px) + abs(sep_px))) + 4
    return (off.reshape(b * h, w).contiguous(), nd.reshape(b * h, w).contiguous(),
            image.reshape(b * h, w, c).contiguous(),
            dict(gradient_threshold=1.5, max_stretch=8, max_disp=max_disp))


def edge_masks(depth255):
    """The depth blur's two edge masks as [rows, W] (ops/blur.py)."""
    import torch
    from comfystereo_tpu_torch.ops import blur
    grad = blur.sobel_x(depth255)
    strong = torch.clamp(grad.abs() / 200.0, 0.0, 1.0) > 0.5
    w = depth255.shape[-1]
    return (((grad > 0) & strong).reshape(-1, w).contiguous(),
            ((grad < 0) & strong).reshape(-1, w).contiguous())


# --- phases ---------------------------------------------------------------

def phase_device():
    import torch
    from comfystereo_tpu_torch.kernels import _build
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    log(f"phase 1 device: nvidia-smi: {smi} | torch: {name} | "
        f"count {torch.cuda.device_count()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = _build.build()
    sec = time.perf_counter() - t0
    for n in libs:
        usage = [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "Used" in ln or "spill" in ln]
        log(f"  built {n}: {_build.library_path(n).name} ({' | '.join(usage)})")
    log(f"phase 1 ok: {len(libs)} kernels built from comfystereo_tpu_torch/csrc "
        f"by nvcc for sm_90a in {sec:.1f} s")
    return smi, name


def phase_kernels(dev, n: int = FRAMES, h: int = HEIGHT, w: int = WIDTH):
    """Each kernel against its plain version on the same inputs."""
    import numpy as np
    import torch
    from comfystereo_tpu_torch.kernels import distance, warp_kernel

    imgs, deps = fixture_frames(n, h, w)
    image = torch.from_numpy(imgs).to(dev).float() / 255.0
    fixture_d = torch.from_numpy(deps).to(dev).float()
    rng = np.random.default_rng(0)
    noise_d = torch.from_numpy(
        rng.uniform(0, 255, (n, h, w)).astype(np.float32)).to(dev)
    warp_err = 0.0
    cases = [(kind, d, sign * DIV_PCT, sign * sep + 0.0, "float32")
             for kind, d in (("fixture", fixture_d), ("noise", noise_d))
             for sep in SEP_PCTS for sign in (1.0, -1.0)]
    cases.append(("fixture", fixture_d, DIV_PCT, 0.0, "bfloat16"))
    for kind, d, div, sep, cdt in cases:
        img = image.to(getattr(torch, cdt))
        off, nd, rows, kw = warp_rows_inputs(img, d, div, sep)
        out_k, gap_k = warp_kernel.warp_rows(off, nd, rows, **kw)
        sync()
        out_p, gap_p = warp_kernel.warp_rows_plain(off, nd, rows, **kw)
        sync()
        if not torch.equal(gap_k, gap_p):
            raise AssertionError(
                f"warp gap mask differs ({kind}, div {div}%, sep {sep}%): "
                f"{int((gap_k != gap_p).sum())} px")
        err = (out_k.float() - out_p.float()).abs()
        max_err = float(err.max())
        off_px = float((err.amax(-1) > 1e-5).float().mean())
        if kind == "fixture":
            if max_err > 1e-5:
                raise AssertionError(f"warp colour error {max_err} > 1e-5 "
                                     f"(div {div}%, sep {sep}%, {cdt})")
            warp_err = max(warp_err, max_err)
        elif off_px >= 0.001:
            raise AssertionError(f"warp colours differ on {off_px:.5f} of noise "
                                 f"pixels (div {div}%, sep {sep}%)")
        log(f"  warp {kind} div {div:+.1f}% sep {sep:.1f}% {cdt}: gap bit-equal, "
            f"max |err| {max_err:.3g}, px > 1e-5: {off_px:.6f}")
    masks = [edge_masks(fixture_d), edge_masks(noise_d)]
    masks.append(tuple(torch.from_numpy(rng.random((n * h, w)) < p).to(dev)
                       for p in (0.001, 0.0)))  # sparse edges, and none at all
    for ml, mr in masks:
        kl, kr = distance.edge_distances(ml, mr)
        sync()
        pl, pr = distance.edge_distances_plain(ml, mr)
        sync()
        if not (torch.equal(kl, pl) and torch.equal(kr, pr)):
            raise AssertionError("edge distances differ from the plain version")
    log(f"phase 2: warp kernel vs plain on [{n * h}, {w}] rows: gap masks "
        f"bit-equal in {len(cases)} cases, fixture max |err| {warp_err:.3g}; "
        f"distance kernel bit-equal on {len(masks)} mask pairs")
    n_gather = check_gather(dev, n, h, w)
    n_poly = check_polylines(dev, image * 255.0,
                             {"fixture": fixture_d, "noise": noise_d})
    log(f"phase 2 ok: warp, distance, gather ({n_gather} cases) and polylines "
        f"({n_poly} cases) kernels agree with their plain versions")
    return {"warp_max_abs_err": warp_err, "distance_max_abs_err": 0.0,
            "gather_max_abs_err": 0.0, "polylines_max_abs_err": 0.0}


def gather_inputs(dev, n: int, h: int, w: int, seed: int = 0):
    """The fills' gather shapes: sorted int32 keys [n,h,w] with near-diagonal
    int32 indices, and colour planes [n,3,h,w] with one [n,1,h,w] index
    plane (the naive fill's max displacement at divergence 4.5%)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    disp = int(DIV_PCT / 100.0 * w) + 2
    cols = torch.arange(w, device=dev, dtype=torch.int32)
    keys = torch.sort(cols + torch.randint(-disp, disp + 1, (n, h, w), device=dev,
                                           generator=gen, dtype=torch.int32), -1).values
    idx = (cols + torch.randint(-disp, disp + 1, (n, h, w), device=dev, generator=gen,
                                dtype=torch.int32)).clamp(0, w - 1)
    planes = torch.rand((n, 3, h, w), device=dev, generator=gen) * 255.0
    return keys, idx, planes, idx[:, None], disp


def check_gather(dev, n: int, h: int, w: int) -> int:
    import torch
    from comfystereo_tpu_torch.kernels import gather
    keys, idx, planes, idx_plane, disp = gather_inputs(dev, n, h, w)
    cases = [(keys, idx), (planes, idx_plane), (keys[..., : w - 64], idx.clamp(max=w - 65))]
    for values, ix in cases:
        got = gather.bounded_take_along_w(values, ix, disp)
        sync()
        want = torch.gather(values, -1, ix.long().expand(values.shape[:-1] + ix.shape[-1:]))
        if got.dtype != values.dtype or not torch.equal(got, want):
            raise AssertionError(f"gather kernel differs from torch.gather on "
                                 f"{tuple(values.shape)} {values.dtype}")
        log(f"  gather {tuple(values.shape)} {values.dtype} idx {tuple(ix.shape)}: "
            "bit-equal to torch.gather")
    return len(cases)


def polylines_inputs(image255, depth255, div_pct: float, sep_pct: float):
    """The polylines kernel's row arguments, computed as
    ops/polylines_exact.apply_polylines_exact computes them."""
    import math
    import torch
    from comfystereo_tpu_torch.ops import depth as depth_ops
    b, h, w, c = image255.shape
    div_px, sep_px = depth_ops.percent_to_px(div_pct, sep_pct, w)
    nd = depth_ops.normalize_depth(depth255) - 0.5
    coord = depth_ops.signed_power(nd, 2.0) * div_px
    x = torch.arange(w, dtype=torch.float32, device=coord.device) + 0.5 + coord + sep_px
    max_disp = int(math.ceil(abs(div_px) + abs(sep_px))) + 4
    return (x.reshape(b * h, w).contiguous(), coord.abs().reshape(b * h, w).contiguous(),
            torch.trunc(image255).reshape(b * h, w, c).contiguous(), max_disp)


def check_polylines(dev, image255, depths) -> int:
    import torch
    from comfystereo_tpu_torch.kernels import polylines_exact as pk
    count = 0
    for kind, d in depths.items():
        for sharp in (True, False):
            for sep in SEP_PCTS:
                for sign in (1.0, -1.0):
                    x, cl, colors, max_disp = polylines_inputs(
                        image255, d, sign * DIV_PCT, sign * sep + 0.0)
                    got = pk.polylines_exact_rows(x, cl, colors, sharp=sharp,
                                                  max_pieces=12, max_disp=max_disp)
                    sync()
                    want = pk.polylines_exact_rows_plain(x, cl, colors, sharp, 12, max_disp)
                    sync()
                    if not torch.equal(got, want):
                        bad = float((got != want).float().mean())
                        raise AssertionError(
                            f"polylines kernel differs from plain ({kind}, sharp "
                            f"{sharp}, div {sign * DIV_PCT}%, sep {sep}%): {bad:.6f}")
                    count += 1
        log(f"  polylines {kind}: uint8 bit-equal to plain on {tuple(x.shape)} rows, "
            "sharp and soft, div +-4.5%, sep 0 and 1%")
    return count


KERNEL_MODULES = ("warp_kernel", "distance", "gather", "polylines_exact")
KERNEL_NAMES = {"warp_kernel": "warp_rows", "distance": "edge_distances",
                "gather": "bounded_take_along_w", "polylines_exact": "polylines_exact_rows"}


def reset_launches() -> None:
    import importlib
    for mod in KERNEL_MODULES:
        importlib.import_module(f"comfystereo_tpu_torch.kernels.{mod}").LAUNCHES = 0


def read_launches():
    import importlib
    return {KERNEL_NAMES[mod]: importlib.import_module(
        f"comfystereo_tpu_torch.kernels.{mod}").LAUNCHES for mod in KERNEL_MODULES}


def check_node_outputs(stereo, left_d, right_d, mask, mask_shape, n, h, w):
    import torch
    if tuple(stereo.shape) != (n, h, 2 * w, 3) or tuple(mask.shape) != mask_shape:
        raise AssertionError(f"shapes {tuple(stereo.shape)}, {tuple(mask.shape)}")
    if tuple(left_d.shape) != (n, h, w, 3) or tuple(right_d.shape) != (n, h, w, 3):
        raise AssertionError("depth output shapes")
    for t in (stereo, left_d, right_d, mask):
        if not bool(torch.isfinite(t).all()) or float(t.min()) < 0 or float(t.max()) > 1:
            raise AssertionError("outputs not finite or outside [0, 1]")
    parallax = float((stereo[:, :, :w] - stereo[:, :, w:]).abs().mean())
    if parallax <= 0.0:
        raise AssertionError(f"no parallax ({parallax})")
    return parallax


def phase_main_path(dev, n: int = FRAMES, h: int = HEIGHT, w: int = WIDTH):
    """The node at full size through the kernels (gpu_warp, then polylines
    sharp), the video chunk, and stereo_pipeline once for each other fill."""
    import numpy as np
    import torch
    from comfystereo_tpu_torch import StereoConfig, stereo_pipeline
    from comfystereo_tpu_torch.nodes.stereo_image import StereoImageNode
    from comfystereo_tpu_torch.utils.video import device_chunk

    imgs, deps = fixture_frames(n, h, w)
    image = imgs.astype(np.float32) / 255.0
    depth = deps.astype(np.float32) / 255.0
    reset_launches()
    t0 = time.perf_counter()
    stereo, left_d, right_d, mask = StereoImageNode().generate(
        image, depth, batch_size=n, device=dev)
    sec = time.perf_counter() - t0
    launches = read_launches()
    want = {"warp_rows": 2, "edge_distances": 1, "bounded_take_along_w": 0,
            "polylines_exact_rows": 0}
    if launches != want:
        raise AssertionError(f"gpu_warp path launches {launches}, expected {want}")
    parallax = check_node_outputs(stereo, left_d, right_d, mask, (n, h, w), n, h, w)
    if float(mask.mean()) <= 0.0:
        raise AssertionError("no gaps")
    log(f"phase 3 node gpu_warp: {n} frames {w}x{h} in {sec:.2f} s (first call), "
        f"launches {launches}, mean |L-R| {parallax:.4f}, gap share "
        f"{float(mask.mean()):.4f}")

    cfg = StereoConfig(batch_size=n)
    bgr = torch.from_numpy(np.ascontiguousarray(imgs[..., ::-1]))
    dep_bgr = torch.from_numpy(np.repeat(deps[..., None], 3, axis=-1))
    out = device_chunk(bgr, dep_bgr, cfg, device=dev)
    sync()
    if out.dtype != torch.uint8 or tuple(out.shape) != (n, h, 2 * w, 3):
        raise AssertionError(f"device_chunk gave {out.dtype} {tuple(out.shape)}")
    node_u8 = torch.trunc(stereo * 255.0).flip(-1)
    within = float(((out.cpu().float() - node_u8).abs() <= 1).float().mean())
    if within < 0.999:
        raise AssertionError(f"device_chunk vs node: only {within:.5f} within 1 LSB")
    log(f"  device_chunk uint8 BGR {tuple(out.shape)}, {within:.6f} of values "
        "within 1 LSB of the node")

    reset_launches()
    t0 = time.perf_counter()
    stereo, left_d, right_d, mask = StereoImageNode().generate(
        image, depth, batch_size=n, fill_technique="Fill - Polylines Sharp",
        device=dev)
    sec = time.perf_counter() - t0
    poly_launches = read_launches()
    want = {"warp_rows": 0, "edge_distances": 1, "bounded_take_along_w": 0,
            "polylines_exact_rows": 2}
    if poly_launches != want:
        raise AssertionError(f"polylines_sharp path launches {poly_launches}, "
                             f"expected {want}")
    parallax = check_node_outputs(stereo, left_d, right_d, mask, (n, h, 2 * w), n, h, w)
    q = stereo * 255.0
    if float((q - torch.round(q)).abs().max()) > 1e-3:
        raise AssertionError("polylines output is not uint8-valued")
    log(f"phase 3 node polylines_sharp: {n} frames {w}x{h} in {sec:.2f} s (first "
        f"call), launches {poly_launches}, mean |L-R| {parallax:.4f}, black "
        f"share {float(mask.mean()):.5f}")

    img_d = torch.from_numpy(image).to(dev)
    dep_d = torch.from_numpy(depth).to(dev)
    fill_launches = {}
    for fill in FILLS:
        if fill == "polylines_sharp":
            continue
        reset_launches()
        res = stereo_pipeline(img_d, dep_d, StereoConfig(fill_technique=fill))
        sync()
        got = read_launches()
        fill_launches[fill] = got
        if (got["edge_distances"] != 1 or got["warp_rows"] != 0
                or (got["bounded_take_along_w"] > 0) != (fill in GATHER_FILLS)
                or got["polylines_exact_rows"] != (2 if fill.startswith("poly")
                                                   or fill == "hybrid_edge_plus" else 0)):
            raise AssertionError(f"{fill} launches {got}")
        o = res["stereo"][0]
        if tuple(o.shape) != (n, h, 2 * w, 3) or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{fill} output {tuple(o.shape)} not finite")
        log(f"  stereo_pipeline {fill} 1080p B={n}: launches gather "
            f"{got['bounded_take_along_w']}, polylines {got['polylines_exact_rows']}, "
            f"distance {got['edge_distances']}, black share {float(res['mask'].mean()):.5f}")
    log("phase 3 ok: gpu_warp and polylines_sharp node paths and every fill "
        "through their kernels")
    launches["polylines_exact_rows"] = poly_launches["polylines_exact_rows"]
    launches["bounded_take_along_w"] = fill_launches["none"]["bounded_take_along_w"]
    return launches, fill_launches


def phase_card_vs_cpu(dev, n: int = 2, h: int = 270, w: int = 480):
    """stereo_pipeline on the card and on the CPU, to the slice's tolerances."""
    import torch
    from comfystereo_tpu_torch import StereoConfig, stereo_pipeline

    imgs, deps = fixture_frames(n, h, w)
    image = torch.from_numpy(imgs).float() / 255.0
    depth = torch.from_numpy(deps).float() / 255.0
    modes = ("left-right", "top-bottom", "red-cyan-anaglyph")
    for blur in (False, True):
        cfg = StereoConfig(modes=modes, depth_map_blur=blur)
        gpu = stereo_pipeline(image.to(dev), depth.to(dev), cfg)
        cpu = stereo_pipeline(image, depth, cfg)
        mask_off = float((gpu["mask"].cpu() != cpu["mask"]).float().mean())
        for k in ("left_depth", "right_depth"):
            err = float((gpu[k].cpu() - cpu[k]).abs().max())
            if err > 1e-5:
                raise AssertionError(f"{k} card vs CPU {err} > 1e-5 (blur {blur})")
        for g, c in zip(gpu["stereo"], cpu["stereo"]):
            g = g.cpu()
            if blur:
                q = (torch.trunc(g * 255) - torch.trunc(c * 255)).abs()
                ok = float((q <= 1).float().mean()) >= 0.999
            else:
                ok = float((g - c).abs().max()) <= 1e-5
            if not ok:
                raise AssertionError(f"colours card vs CPU out of tolerance (blur {blur})")
        if (mask_off > 0.001) if blur else (mask_off > 0):
            raise AssertionError(f"mask card vs CPU differs on {mask_off} (blur {blur})")
        log(f"  card vs CPU gpu_warp blur={blur}: mask mismatch {mask_off:.6f}, "
            "within tolerance")
    for fill in FILLS:
        for blur in (False, True):
            cfg = StereoConfig(modes=modes, depth_map_blur=blur, fill_technique=fill)
            gpu = stereo_pipeline(image.to(dev), depth.to(dev), cfg)
            cpu = stereo_pipeline(image, depth, cfg)
            mask_off = float((gpu["mask"].cpu() != cpu["mask"]).float().mean())
            off, worst = fill_diff(gpu["stereo"], cpu["stereo"])
            hybrid = fill.startswith("hybrid")
            # Bit-equal in uint8, except the hybrid fills: their float32
            # prefix sums round differently on the card (torch.cumsum's
            # parallel scan) than on the CPU, and differences of prefix sums
            # cancel, so they are held to 1 LSB on at most HYBRID_SHARE of
            # the values (measured on the H100: 28.9% blur off, 28.6% on).
            # Blur on adds the depth blur's card-vs-CPU tolerance (phase 4 of
            # gpu_warp): at most 0.1% of values may differ.
            if hybrid:
                ok = worst <= 1 and off <= HYBRID_SHARE and mask_off <= 0.001
            elif blur:
                ok = off <= 0.001 and mask_off <= 0.001
            else:
                ok = worst == 0 and mask_off == 0
            if not ok:
                raise AssertionError(f"{fill} card vs CPU (blur {blur}): {off:.6f} of "
                                     f"values differ, max {worst} LSB, mask {mask_off:.6f}")
            log(f"  card vs CPU {fill} blur={blur}: {off:.6f} of uint8 values differ "
                f"(max {worst:g} LSB), mask mismatch {mask_off:.6f}")
    log(f"phase 4 ok: stereo_pipeline card vs CPU on {n} frames {w}x{h}, gpu_warp "
        f"and {len(FILLS)} fills")


def fill_diff(gpu_outs, cpu_outs):
    """(share of uint8 values that differ, largest difference in LSB) over
    all packed outputs of the uint8 branch."""
    import torch
    n_off, n_all, worst = 0, 0, 0.0
    for g, c in zip(gpu_outs, cpu_outs):
        d = (torch.round(g.cpu() * 255.0) - torch.round(c * 255.0)).abs()
        n_off += int((d > 0).sum())
        n_all += d.numel()
        worst = max(worst, float(d.max()))
    return n_off / n_all, worst


def phase_times(dev, launches, errs, smi: str, name: str,
                n: int = FRAMES, h: int = HEIGHT, w: int = WIDTH):
    import torch
    from comfystereo_tpu_torch import StereoConfig, stereo_pipeline
    from comfystereo_tpu_torch.kernels import distance, warp_kernel

    key, (bw, flops) = peaks(name)
    imgs, deps = fixture_frames(n, h, w)
    image = torch.from_numpy(imgs).to(dev).float() / 255.0
    depth255 = torch.from_numpy(deps).to(dev).float()

    off, nd, rows, kw = warp_rows_inputs(image, depth255, DIV_PCT, 0.0)
    warp_ms = time_ms(lambda: warp_kernel.warp_rows(off, nd, rows, **kw))
    warp_plain_ms = time_ms(lambda: warp_kernel.warp_rows_plain(off, nd, rows, **kw))
    lo, hi = warp_kernel._window(off, kw["max_disp"])
    candidates = float(((hi - lo + 1).clamp(min=0) * w).sum())
    warp_bytes = sum(t.numel() * t.element_size() for t in (off, nd, rows)) \
        + rows.numel() * rows.element_size() + n * h * w  # out + bool gap
    warp_ops = 8.0 * candidates  # sub, div, sub, 2 mul, add, add, sub per candidate

    ml, mr = edge_masks(depth255)
    dist_ms = time_ms(lambda: distance.edge_distances(ml, mr))
    dist_plain_ms = time_ms(lambda: distance.edge_distances_plain(ml, mr))
    dist_bytes = 2 * ml.numel() + 2 * 4 * ml.numel()
    dist_ops = 4.0 * 2 * ml.numel()  # compare + select per direction per mask

    gather_t = gather_times(dev, n, h, w)
    poly_t = polylines_times(image * 255.0, depth255)

    def entry(kname, source, replaces, ms, plain_ms, nbytes, ops, err, library_ms=None):
        t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[kname],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms}

    kernels = [
        entry("warp_rows", "comfystereo_tpu_torch/csrc/warp_kernel.cu",
              "comfystereo_tpu/pallas/warp_kernel.py:222", warp_ms, warp_plain_ms,
              warp_bytes, warp_ops, errs["warp_max_abs_err"]),
        entry("edge_distances", "comfystereo_tpu_torch/csrc/distance.cu",
              "comfystereo_tpu/pallas/distance.py:59", dist_ms, dist_plain_ms,
              dist_bytes, dist_ops, errs["distance_max_abs_err"]),
        entry("bounded_take_along_w", "comfystereo_tpu_torch/csrc/gather.cu",
              "comfystereo_tpu/pallas/gather.py:100", gather_t["ms"],
              gather_t["plain_ms"], gather_t["bytes"], 0.0,
              errs["gather_max_abs_err"], gather_t["library_ms"]),
        entry("polylines_exact_rows", "comfystereo_tpu_torch/csrc/polylines_exact.cu",
              "comfystereo_tpu/pallas/polylines_exact_kernel.py:630", poly_t["ms"],
              poly_t["plain_ms"], poly_t["bytes"], poly_t["ops"],
              errs["polylines_max_abs_err"]),
    ]
    for k in kernels:
        lib = "" if k["library_ms"] is None else f", library {k['library_ms']:.4f} ms"
        log(f"  {k['name']}: {k['ms']:.4f} ms/launch, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}, {key} peaks), plain {k['plain_ms']:.3f} ms{lib}, "
            f"{k['launches']} launches per {n}-frame chunk "
            f"({k['launches'] / n:.4f} per frame) [{smi}]")
    log(f"  gather of [{n},3,{h},{w}] colour by a [{n},1,{h},{w}] plane: "
        f"{gather_t['plane_ms']:.4f} ms, torch.gather {gather_t['plane_library_ms']:.4f} ms; "
        f"polylines soft: {poly_t['soft_ms']:.4f} ms/launch; sharp: pieces per "
        f"pixel {poly_t['pieces_per_px']:.3f}, window {poly_t['window_mean']:.1f} "
        f"columns per row, active candidates per piece {poly_t['active_per_piece']:.3f}, "
        f"{poly_t['ops']:.4g} operations, {poly_t['bytes']:.4g} bytes [{smi}]")

    pipeline = {}
    depth01 = depth255 / 255.0
    for cdt in ("float32", "bfloat16"):
        cfg = StereoConfig(color_dtype=cdt)
        ms = time_ms(lambda: stereo_pipeline(image, depth01, cfg))
        pipeline[cdt] = {"ms_per_chunk": ms, "ms_per_frame": ms / n,
                         "fps": n * 1e3 / ms}
        log(f"  pipeline 1080p B={n} {cdt}: {ms / n:.4f} ms/frame, "
            f"{n * 1e3 / ms:.1f} fps [{smi}]")

    cfg = StereoConfig()
    stages = stage_times(image, depth01, cfg)
    log("  gpu_warp stages per chunk (float32): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in stages.items()) + f" [{smi}]")
    pipeline["float32"]["stages_ms"] = stages
    pipeline["float32"].update(idle_share(
        "gpu_warp", lambda: stereo_pipeline(image, depth01, cfg),
        pipeline["float32"]["ms_per_chunk"], smi))
    pipeline["fills"] = fill_times(image, depth01, smi)
    log(f"phase 5 ok: times on {name} ({smi})")
    return kernels, pipeline


def gather_times(dev, n: int, h: int, w: int):
    """The gather kernel, its plain version and torch.gather on the fills'
    int32 keys (the binary searches' call, the most frequent), and on
    colour planes by one index plane. Bytes: index, value and output, 4 B
    each, per output element."""
    import torch
    from comfystereo_tpu_torch.kernels import gather
    keys, idx, planes, idx_plane, disp = gather_inputs(dev, n, h, w, seed=1)
    idx64 = idx.long()
    plane64 = idx_plane.long().expand(planes.shape)
    return {
        "ms": time_ms(lambda: gather.bounded_take_along_w(keys, idx, disp)),
        "plain_ms": time_ms(lambda: gather.bounded_take_along_w_plain(keys, idx)),
        "library_ms": time_ms(lambda: torch.gather(keys, -1, idx64)),
        "bytes": 12.0 * idx.numel(),
        "plane_ms": time_ms(lambda: gather.bounded_take_along_w(planes, idx_plane, disp)),
        "plane_library_ms": time_ms(lambda: torch.gather(planes, -1, plane64)),
    }


def polylines_times(image255, depth255):
    """The polylines kernel (sharp, the node's fill; and soft) and its plain
    version on the left eye's rows at 1080p, with the bytes (x, closeness and
    colour in, colour out: 4 B each per pixel and channel) and the operations
    of the sharp call on this input (`polylines_work`)."""
    from comfystereo_tpu_torch.kernels import polylines_exact as pk
    x, cl, colors, max_disp = polylines_inputs(image255, depth255, DIV_PCT, 0.0)
    kw = dict(max_pieces=12, max_disp=max_disp)
    ms = time_ms(lambda: pk.polylines_exact_rows(x, cl, colors, sharp=True, **kw))
    soft_ms = time_ms(lambda: pk.polylines_exact_rows(x, cl, colors, sharp=False, **kw))
    plain_ms = time_ms(lambda: pk.polylines_exact_rows_plain(x, cl, colors, True, 12,
                                                             max_disp), iters=2, warmup=1)
    work = polylines_work(x, max_disp, True, colors.shape[-1])
    nbytes = 4.0 * (x.numel() + cl.numel() + 2 * colors.numel())
    return {"ms": ms, "soft_ms": soft_ms, "plain_ms": plain_ms, "bytes": nbytes, **work}


def polylines_work(x, max_disp: int, sharp: bool, c: int):
    """The float operations csrc/polylines_exact.cu does on rows `x`, counted
    from its code and this input:
    - the breakpoint walk, per column and in-row window step: the source's
      points and their landing tests (sharp: 2 adds and 4 compares; soft: 2
      compares), and 24 min/max for every point that lands in the row;
    - per valid piece: its geometry (6), the two sentinels' activity tests
      (4), the winner choice (1) and the accumulation (6 per channel); per
      in-row window step the candidates' activity tests (sharp: 3 adds for
      the endpoints and 2 compares for each of the flat and the connecting
      segment; soft: 1 add and 2 compares);
    - per active candidate, which alone goes on to the blend: the division
      and closeness blend (7) and the winner and fallback tests (5)."""
    import torch
    from comfystereo_tpu_torch.kernels import polylines_exact as pk
    n, w = x.shape
    hw = 0.45 if sharp else 0.0
    cols = torch.arange(w, device=x.device)
    lo, hi = pk.window(x, max_disp)                              # [n, 1]
    steps = (torch.minimum(hi, w - 1 - cols) - torch.maximum(lo, -cols) + 1).clamp(min=0)
    pts = torch.cat([x - hw, x + hw], dim=-1) if sharp else x
    landed = float(((pts >= 0) & (pts < w)).sum())
    centers, _, valids = pk.piece_geometry(x, sharp, 12, max_disp)
    r = max_disp + 5
    xp = torch.nn.functional.pad(x, (r, r + 1))
    pieces = torch.zeros_like(x)
    active = torch.zeros_like(x)
    for center, valid in zip(centers, valids):
        valid = valid > 0.5
        if not bool(valid.any()):
            continue
        act = ((-float(w) < center) & (x[:, :1] - hw >= center)).float()
        act += ((x[:, -1:] + hw < center) & (2.0 * w >= center)).float()
        for d in range(int(lo.min()), int(hi.max()) + 1):
            cur, nxt = xp[:, r + d:r + d + w], xp[:, r + d + 1:r + d + 1 + w]
            ok = (d >= lo) & (d <= hi) & (cols + d >= 0) & (cols + d <= w - 1)
            if sharp:
                act += (ok & (cur - hw < center) & (cur + hw >= center)).float()
            act += (ok & (cols + d <= w - 2) & (cur + hw < center)
                    & (nxt - hw >= center)).float()
        pieces += valid.float()
        active += torch.where(valid, act, 0.0)
    step_ops = 7.0 if sharp else 3.0
    ops = (float(steps.sum()) * (6.0 if sharp else 2.0) + 24.0 * landed
           + float(pieces.sum()) * (11.0 + 6.0 * c)
           + float((pieces * steps).sum()) * step_ops + 12.0 * float(active.sum()))
    return {"ops": ops, "pieces_per_px": float(pieces.mean()),
            "window_mean": float((hi - lo + 1).float().mean()),
            "active_per_piece": float(active.sum() / pieces.sum())}


def fill_times(image, depth01, smi: str):
    """ms/frame of stereo_pipeline for each fill at 1080p B=12, and for
    polylines_sharp a stage breakdown and the device idle share."""
    from comfystereo_tpu_torch import StereoConfig, stereo_pipeline
    n = image.shape[0]
    out = {}
    for fill in FILLS:
        cfg = StereoConfig(fill_technique=fill)
        ms = time_ms(lambda: stereo_pipeline(image, depth01, cfg), iters=5, warmup=1)
        out[fill] = {"ms_per_chunk": ms, "ms_per_frame": ms / n, "fps": n * 1e3 / ms}
        log(f"  pipeline 1080p B={n} {fill}: {ms / n:.4f} ms/frame, "
            f"{n * 1e3 / ms:.2f} fps [{smi}]")
    cfg = StereoConfig(fill_technique="polylines_sharp")
    stages = stage_times(image, depth01, cfg)
    log("  polylines_sharp stages per chunk: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in stages.items()) + f" [{smi}]")
    out["polylines_sharp"]["stages_ms"] = stages
    for fill in ("polylines_sharp", "none", "hybrid_edge"):
        cfg = StereoConfig(fill_technique=fill)
        out[fill].update(idle_share(fill, lambda: stereo_pipeline(image, depth01, cfg),
                                    out[fill]["ms_per_chunk"], smi))
    return out


def stage_times(image, depth01, cfg):
    """ms per chunk of each stage of stereo_pipeline, timed apart through the
    pipeline's own stage functions on the inputs the pipeline gives each:
    the blur, the eyes' source colour, each eye (warp or fill), and the pack
    with the mask and the depth outputs."""
    from comfystereo_tpu_torch import pipeline as pipe

    left_d, right_d = pipe._blurred_eye_depths(pipe._depth255(depth01), cfg)
    left_div, right_div = cfg.eye_divergences()
    src = pipe._eye_source(image, cfg)
    left = pipe._eye(src, left_d, left_div, +1.0, cfg)
    right = pipe._eye(src, right_d, right_div, -1.0, cfg)
    return {
        "blur": time_ms(lambda: pipe._blurred_eye_depths(pipe._depth255(depth01), cfg)),
        "source": time_ms(lambda: pipe._eye_source(image, cfg)),
        "eye_left": time_ms(lambda: pipe._eye(src, left_d, left_div, +1.0, cfg)),
        "eye_right": time_ms(lambda: pipe._eye(src, right_d, right_div, -1.0, cfg)),
        "pack_mask_depth": time_ms(lambda: pipe._outputs(left, right, left_d, right_d, cfg)),
    }


def idle_share(label: str, fn, chunk_ms: float, smi: str):
    """Device busy time of `fn` (torch.profiler) against the event-timed time
    of the same profiled calls, the idle share 1 - busy/wall unclamped, and
    the six largest device items. The share is None, and said to be not
    measured, when the profiler saw no device time or more than the wall."""
    busy_ms, wall_ms, top = device_busy(fn)
    idle = 1.0 - busy_ms / wall_ms
    why = f"{idle:.4f}"
    if busy_ms == 0.0:
        idle, why = None, "not measured (the profiler saw no device time)"
    elif busy_ms > wall_ms:
        idle, why = None, f"not measured (busy exceeds the wall: 1 - busy/wall = {why})"
    log(f"  {label} device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall per profiled "
        f"chunk ({chunk_ms:.3f} ms unprofiled), idle share {why} [{smi}]")
    for kname, ms, calls in top:
        log(f"    {ms:8.3f} ms  {calls:4d} launches  {kname}")
    return {"device_busy_ms": busy_ms, "profiled_wall_ms": wall_ms, "idle_share": idle,
            "top_kernels": top}


def device_busy(fn, iters: int = 3):
    """Device time per call from torch.profiler's CUDA activity (kernels,
    copies, sets), the CUDA-event time per call of the same profiled calls,
    and the six largest items as (name, ms per call, launches per call).
    The device time is 0.0 when the profiler records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        sync()

    def self_us(e):
        return float(getattr(e, "self_device_time_total", 0.0) or 0.0)

    events = [e for e in prof.key_averages() if self_us(e) > 0.0]
    busy_ms = sum(self_us(e) for e in events) / 1e3 / iters
    top = [(e.key[:80], self_us(e) / 1e3 / iters, e.count // iters)
           for e in sorted(events, key=self_us, reverse=True)[:6]]
    return busy_ms, start.elapsed_time(end) / iters, top


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "comfystereo_tpu_torch")):
        print("chip_smoke: comfystereo_tpu_torch is not beside chip_smoke.py",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    smi, name = phase_device()
    errs = phase_kernels(dev)
    launches, _ = phase_main_path(dev)
    phase_card_vs_cpu(dev)
    kernels, pipeline = phase_times(dev, launches, errs, smi, name)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    log("pipeline " + json.dumps(pipeline))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
