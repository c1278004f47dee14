#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the repository root (it imports `comfystereo_tpu_torch` from
beside itself; it never imports JAX or `comfystereo_tpu`). Phases, in order;
any failure ends the run with a non-zero exit code:

1. device: the card's name and power limit; build every kernel with nvcc
   (sm_90a, one nvcc per source, all started together);
2. kernels vs their plain PyTorch versions on the card, at the main path's
   shapes (12 frames of 1080x1920 as [12*1080, 1920] rows): the warp on the
   fixture depth and on uniform-noise depth, divergence +-4.5% of the width
   with separation 0 and 1% (gap masks bit-equal; colours atol 1e-5 on the
   fixture, < 0.1% of pixels differing on noise), and the edge-distance
   transform (bit-equal);
3. the main path at full size: StereoImageNode().generate on 12 frames of
   1920x1080 with the default config (gpu_warp, depth blur, left-right,
   batch_size=12), with every launch counter set to 0 just before and read
   just after (warp 2, distance 1 per chunk); then device_chunk on the same
   frames as uint8 BGR;
4. card vs CPU: the port's stereo_pipeline on 2 frames of 270x480 on the card
   and on the CPU, to the slice's tolerances;
5. times with CUDA events (warm-up, then >= 10 iterations): each kernel and
   its plain version at the main path's shapes beside the bound, and the
   pipeline's ms/frame and fps at 1080p, batch 12, in float32 and bfloat16.

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
    log(f"phase 2 ok: warp kernel vs plain on [{n * h}, {w}] rows: gap masks "
        f"bit-equal in {len(cases)} cases, fixture max |err| {warp_err:.3g}; "
        f"distance kernel bit-equal on {len(masks)} mask pairs")
    return {"warp_max_abs_err": warp_err, "distance_max_abs_err": 0.0}


def phase_main_path(dev, n: int = FRAMES, h: int = HEIGHT, w: int = WIDTH):
    """The node at full size through the kernels, then the video chunk."""
    import numpy as np
    import torch
    from comfystereo_tpu_torch import StereoConfig
    from comfystereo_tpu_torch.kernels import distance, warp_kernel
    from comfystereo_tpu_torch.nodes.stereo_image import StereoImageNode
    from comfystereo_tpu_torch.utils.video import device_chunk

    imgs, deps = fixture_frames(n, h, w)
    image = imgs.astype(np.float32) / 255.0
    depth = deps.astype(np.float32) / 255.0
    warp_kernel.LAUNCHES = 0
    distance.LAUNCHES = 0
    t0 = time.perf_counter()
    stereo, left_d, right_d, mask = StereoImageNode().generate(
        image, depth, batch_size=n, device=dev)
    sec = time.perf_counter() - t0
    launches = {"warp_rows": warp_kernel.LAUNCHES,
                "edge_distances": distance.LAUNCHES}
    if launches != {"warp_rows": 2, "edge_distances": 1}:
        raise AssertionError(f"main path launches {launches}, expected warp 2, "
                             "distance 1")
    if tuple(stereo.shape) != (n, h, 2 * w, 3) or tuple(mask.shape) != (n, h, w):
        raise AssertionError(f"shapes {tuple(stereo.shape)}, {tuple(mask.shape)}")
    if tuple(left_d.shape) != (n, h, w, 3) or tuple(right_d.shape) != (n, h, w, 3):
        raise AssertionError("depth output shapes")
    for t in (stereo, left_d, right_d, mask):
        if not bool(torch.isfinite(t).all()) or float(t.min()) < 0 or float(t.max()) > 1:
            raise AssertionError("outputs not finite or outside [0, 1]")
    parallax = float((stereo[:, :, :w] - stereo[:, :, w:]).abs().mean())
    if parallax <= 0.0 or float(mask.mean()) <= 0.0:
        raise AssertionError(f"no parallax ({parallax}) or no gaps")
    log(f"phase 3 node: {n} frames {w}x{h} in {sec:.2f} s (first call), launches "
        f"{launches}, mean |L-R| {parallax:.4f}, gap share {float(mask.mean()):.4f}")

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
    log(f"phase 3 ok: main path through both kernels; device_chunk uint8 BGR "
        f"{tuple(out.shape)}, {within:.6f} of values within 1 LSB of the node")
    return launches


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
        log(f"  card vs CPU blur={blur}: mask mismatch {mask_off:.6f}, within tolerance")
    log(f"phase 4 ok: stereo_pipeline card vs CPU on {n} frames {w}x{h}")


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

    def entry(kname, source, replaces, ms, plain_ms, nbytes, ops, err):
        t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[kname],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None}

    kernels = [
        entry("warp_rows", "comfystereo_tpu_torch/csrc/warp_kernel.cu",
              "comfystereo_tpu/pallas/warp_kernel.py:222", warp_ms, warp_plain_ms,
              warp_bytes, warp_ops, errs["warp_max_abs_err"]),
        entry("edge_distances", "comfystereo_tpu_torch/csrc/distance.cu",
              "comfystereo_tpu/pallas/distance.py:59", dist_ms, dist_plain_ms,
              dist_bytes, dist_ops, errs["distance_max_abs_err"]),
    ]
    for k in kernels:
        log(f"  {k['name']}: {k['ms']:.4f} ms/launch, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}, {key} peaks), plain {k['plain_ms']:.3f} ms, "
            f"{k['launches']} launches per {n}-frame chunk "
            f"({k['launches'] / n:.4f} per frame) [{smi}]")

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
    log("  stages per chunk (float32): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in stages.items()) + f" [{smi}]")
    busy_ms, top = device_busy(lambda: stereo_pipeline(image, depth01, cfg))
    chunk_ms = pipeline["float32"]["ms_per_chunk"]
    idle = None if busy_ms == 0.0 else max(0.0, 1.0 - busy_ms / chunk_ms)
    log(f"  device busy {busy_ms:.3f} ms of a {chunk_ms:.3f} ms chunk, idle share "
        + ("not measured (the profiler saw no device time)" if idle is None
           else f"{idle:.4f}") + f" [{smi}]")
    for kname, ms, calls in top:
        log(f"    {ms:8.3f} ms  {calls:4d} launches  {kname}")
    pipeline["float32"].update(stages_ms=stages, device_busy_ms=busy_ms,
                               idle_share=idle, top_kernels=top)
    log(f"phase 5 ok: times on {name} ({smi})")
    return kernels, pipeline


def stage_times(image, depth01, cfg):
    """ms per chunk of each stage of the gpu_warp pipeline, timed apart on
    the inputs the pipeline gives each stage."""
    import torch
    from comfystereo_tpu_torch.ops import blur, pack, warp

    div_px = cfg.divergence / 100.0 * image.shape[-2]

    def run_blur():
        depth255 = torch.where(depth01.max() <= 1.0, depth01 * 255.0, depth01)
        return blur.directional_motion_blur(
            depth255, cfg.depth_blur_strength, cfg.depth_blur_edge_threshold,
            cfg.depth_blur_strength, cfg.depth_blur_falloff,
            cfg.depth_blur_vert_smooth)

    def run_warp(d, div):
        return warp.forward_warp(image, d, div, 0.0, cfg.stereo_offset_exponent,
                                 cfg.convergence_point, cfg.gradient_threshold,
                                 cfg.max_stretch)

    left_d, right_d = run_blur()
    (left, lmask), (right, rmask) = run_warp(left_d, div_px), run_warp(right_d, -div_px)

    def run_pack():
        return (torch.clamp(pack.pack_mode(left, right, "left-right"), 0.0, 1.0),
                (lmask | rmask).float(), torch.clamp(left_d / 255.0, 0.0, 1.0),
                torch.clamp(right_d / 255.0, 0.0, 1.0))

    return {"blur": time_ms(run_blur),
            "warp_left": time_ms(lambda: run_warp(left_d, div_px)),
            "warp_right": time_ms(lambda: run_warp(right_d, -div_px)),
            "pack_clip_mask": time_ms(run_pack)}


def device_busy(fn, iters: int = 3):
    """Device time per call from torch.profiler's CUDA activity (kernels,
    copies, sets), and the six largest items as (name, ms per call, launches
    per call). (0.0, []) when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()

    def self_us(e):
        return float(getattr(e, "self_device_time_total", 0.0) or 0.0)

    events = [e for e in prof.key_averages() if self_us(e) > 0.0]
    busy_ms = sum(self_us(e) for e in events) / 1e3 / iters
    top = [(e.key[:80], self_us(e) / 1e3 / iters, e.count // iters)
           for e in sorted(events, key=self_us, reverse=True)[:6]]
    return busy_ms, top


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
    launches = phase_main_path(dev)
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
