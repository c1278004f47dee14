#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the repository root (it imports `comfystereo_tpu_torch` from
beside itself; it never imports JAX or `comfystereo_tpu`). Phases, in order;
any failure ends the run with a non-zero exit code:

1. device: the card's name and power limit; build all six kernels with
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
   and 1%, fixture and noise depth (bit-equal); the supersampled polylines
   kernel against its plain version on the same 12 frames, sharp and soft,
   divergence +4.5% with separation 0 and -4.5% with 1%, fixture and noise
   depth (colour sums bit-equal); the flash attention against
   its plain version (`reference`) at the SD 1.5 UNet's bf16 self-attention
   shapes, [BH, Nq, Nk, D] = [16, 4096, 4096, 40] (level 0, CFG batch 2 x 8
   heads), [16, 1024, 1024, 80] (level 1) and [16, 4096, 8192, 40] (BN 'bi'),
   atol 4e-3 on bf16 outputs compared in float32, and a shape outside
   `supports` (cross-attention, 77 keys) that takes no launch;
3. the main paths at full size, each with every launch counter set to 0 just
   before and read just after: StereoImageNode().generate on 12 frames of
   1920x1080 with the default config (gpu_warp, depth blur, left-right,
   batch_size=12: warp 2, distance 1), then device_chunk on the same frames
   as uint8 BGR; the node with "Fill - Polylines Sharp" (polylines 2,
   distance 1, warp 0); stereo_pipeline once for each other fill at 1080p
   B=12 (gather launches printed; every gather fill must launch it); with
   polylines_exact=False, stereo_pipeline for polylines_sharp,
   polylines_soft and hybrid_edge_plus (supersampled polylines 2, exact
   polylines 0, distance 1, gather only for hybrid_edge_plus; uint8-valued
   outputs) and device_chunk for polylines_sharp; the
   StereoDiffusion node in Fast (Warp + Inpaint) mode with its defaults on
   one 512x512 fixture frame, on the full-width SD 1.5-inpainting UNet and
   SD VAE in bfloat16 with seeded random weights (flash attention 130:
   13 UNet calls x 10 self-attentions), then one UNet CFG call and the
   whole warp_inpaint with the attention forced to its plain version;
4. card vs CPU: the port's stereo_pipeline on 2 frames of 270x480 on the card
   and on the CPU, gpu_warp and all ten fills, to the slice's tolerances,
   and the three supersampled fills (the kernel route on the card, the twin
   on the CPU) to the JAX package's kernel-vs-twin bound; the kernel route
   against the twin on the card at 1080p B=12, sharp to that bound, soft to
   a wider one (see `check_routes_1080p`);
   warp_inpaint at the TINY UNet (9- and 4-channel) and VAE configs in
   float32 with the same injected noise on the card and on the CPU;
5. times with CUDA events (warm-up, then >= 10 iterations, fewer for the
   slowest plain versions): each kernel and its plain version at the main
   path's shapes beside the bound (and torch.gather beside the gather), the
   gpu_warp pipeline's ms/frame and fps at 1080p, batch 12, in float32 and
   bfloat16, and the fills' ms/frame at the same size (the three supersampled
   ones too), with stage breakdowns and device idle shares for gpu_warp and
   polylines_sharp, exact and supersampled; the flash kernel,
   its plain version and `scaled_dot_product_attention` (a yardstick the
   port never calls) at the three shapes, the bf16 UNet CFG call, VAE
   encode and decode, and warp_inpaint per frame with its idle share.

It prints one `kernels` JSON line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Without CUDA, or without the package beside
it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
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
# The fills that take the supersampled polylines renderer with
# polylines_exact=False.
LEGACY_FILLS = ("polylines_sharp", "polylines_soft", "hybrid_edge_plus")
# Largest share of uint8 values in which the hybrid fills may differ (by 1)
# card vs CPU in phase 4: the 29% measured there, with room to spare.
HYBRID_SHARE = 0.35

# Published peaks (NVIDIA data sheets, SXM parts, at the full power limit):
# device-memory bytes/s, float32 FLOP/s outside the tensor cores, dense bf16
# tensor-core FLOP/s, and exponentials/s of the special function units (16
# per SM per clock, 132 SMs at 1.83 GHz: about 3.9e12).
_PEAKS = {"H100": (3.35e12, 67e12, 989e12, 3.9e12),
          "H200": (4.8e12, 67e12, 989e12, 3.9e12)}
# Flash attention shapes [BH, Nq, Nk, D] of the SD 1.5 UNet at 512x512 in
# bf16 with CFG (batch 2): level 0 (the timed one), level 1, BN 'bi'.
FLASH_SHAPES = ((16, 4096, 4096, 40), (16, 1024, 1024, 80), (16, 4096, 8192, 40))
SD_SIZE, SD_SEED = 512, 1337
# The node's Fast-mode defaults: 20 PNDM steps at strength 0.6 keep 13 of
# the 21 PLMS timesteps; each UNet call runs 10 self-attentions the kernel
# takes (5 at 4096 tokens, 5 at 1024).
SD_UNET_CALLS, SD_FLASH_PER_CALL = 13, 10


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    """(bytes/s, float32 FLOP/s, bf16 tensor FLOP/s, exponentials/s) of the
    card named `name`; an unknown card is measured against the H100 SXM and
    says so."""
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
    n_ss = check_polylines_ss(image * 255.0, {"fixture": fixture_d, "noise": noise_d})
    del image, fixture_d, noise_d, masks
    flash_err = check_flash(dev)
    log(f"phase 2 ok: warp, distance, gather ({n_gather} cases), polylines "
        f"({n_poly} cases), supersampled polylines ({n_ss} cases) and flash "
        f"attention ({len(FLASH_SHAPES)} shapes) kernels agree with their plain versions")
    return {"warp_max_abs_err": warp_err, "distance_max_abs_err": 0.0,
            "gather_max_abs_err": 0.0, "polylines_max_abs_err": 0.0,
            "polylines_ss_max_abs_err": 0.0, "flash_max_abs_err": flash_err}


def flash_inputs(dev, bh: int, nq: int, nk: int, d: int, seed: int = 0):
    """q [bh, nq, d], k and v [bh, nk, d]: standard normal draws in bf16, as
    the JAX package's own kernel tests draw them."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((bh, n, d), device=dev, generator=gen).to(torch.bfloat16)
            for n in (nq, nk, nk)]


def check_flash(dev) -> float:
    """The flash kernel against `reference` (f32 logits and softmax, bf16
    weights times v) at the UNet's shapes, atol 4e-3 on the bf16 outputs in
    float32 (the JAX package's bound for its kernel against `_reference`);
    a cross-attention shape (77 keys) is outside `supports` and must take
    the bf16-logit form without a launch. Returns the level-0 max |err|."""
    import torch
    from comfystereo_tpu_torch.diffusion import attention
    from comfystereo_tpu_torch.kernels import flash_attention as fa
    errs = []
    for bh, nq, nk, d in FLASH_SHAPES:
        q, k, v = flash_inputs(dev, bh, nq, nk, d)
        if not fa.supports(nq, nk, d, q.dtype):
            raise AssertionError(f"supports({nq}, {nk}, {d}) is false")
        before = fa.LAUNCHES
        got = fa.flash_attention(q, k, v, d ** -0.5)
        sync()
        if fa.LAUNCHES != before + 1:
            raise AssertionError("the flash kernel did not count its launch")
        want = fa.reference(q, k, v, d ** -0.5)
        err = float((got.float() - want.float()).abs().max())
        if got.dtype != torch.bfloat16 or not bool(torch.isfinite(got).all()) or err > 4e-3:
            raise AssertionError(f"flash kernel vs reference at {(bh, nq, nk, d)}: "
                                 f"max |err| {err} > 4e-3")
        errs.append(err)
        log(f"  flash {(bh, nq, nk, d)}: max |err| {err:.3g} against reference")
        del q, k, v, got, want
        torch.cuda.empty_cache()
    q, k, v = (t.reshape(2, 8, -1, 40) for t in flash_inputs(dev, 16, 4096, 77, 40))
    before = fa.LAUNCHES
    out = attention.standard_attention(q, k, v, 40 ** -0.5)
    sync()
    if fa.supports(4096, 77, 40, q.dtype) or fa.LAUNCHES != before or \
            not bool(torch.isfinite(out).all()):
        raise AssertionError("cross-attention (77 keys) took the flash kernel")
    log("  flash: cross-attention [2, 8, 4096 x 77, 40] is outside supports, no launch")
    return errs[0]


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
    """The polylines kernels' row arguments, computed as ops/polylines_exact
    and ops/polylines compute them: (x, signed coord, colours, max_disp);
    the exact kernel takes |coord|."""
    import math
    import torch
    from comfystereo_tpu_torch.ops import depth as depth_ops
    b, h, w, c = image255.shape
    div_px, sep_px = depth_ops.percent_to_px(div_pct, sep_pct, w)
    nd = depth_ops.normalize_depth(depth255) - 0.5
    coord = depth_ops.signed_power(nd, 2.0) * div_px
    x = torch.arange(w, dtype=torch.float32, device=coord.device) + 0.5 + coord + sep_px
    max_disp = int(math.ceil(abs(div_px) + abs(sep_px))) + 4
    return (x.reshape(b * h, w).contiguous(), coord.reshape(b * h, w).contiguous(),
            torch.trunc(image255).reshape(b * h, w, c).contiguous(), max_disp)


def check_polylines(dev, image255, depths) -> int:
    import torch
    from comfystereo_tpu_torch.kernels import polylines_exact as pk
    count = 0
    for kind, d in depths.items():
        for sharp in (True, False):
            for sep in SEP_PCTS:
                for sign in (1.0, -1.0):
                    x, coord, colors, max_disp = polylines_inputs(
                        image255, d, sign * DIV_PCT, sign * sep + 0.0)
                    cl = coord.abs()
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


def check_polylines_ss(image255, depths) -> int:
    """The supersampled polylines kernel against its plain version: colour
    sums bit-equal (S = 8, K = 4)."""
    import torch
    from comfystereo_tpu_torch.kernels import polylines as pk
    count = 0
    for kind, d in depths.items():
        for sharp in (True, False):
            for div, sep in ((DIV_PCT, 0.0), (-DIV_PCT, 1.0)):
                x, coord, colors, max_disp = polylines_inputs(image255, d, div, sep)
                kw = dict(sharp=sharp, samples=8, k_candidates=4, max_disp=max_disp)
                got = pk.polylines_scanline(x, coord, colors, **kw)
                sync()
                want = pk.polylines_scanline_plain(x, coord, colors, **kw)
                sync()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"supersampled polylines kernel differs from plain ({kind}, sharp "
                        f"{sharp}, div {div}%, sep {sep}%): max |err| "
                        f"{float((got - want).abs().max())} on "
                        f"{float((got != want).float().mean()):.6f} of sums")
                count += 1
                del got, want
        log(f"  supersampled polylines {kind}: sums bit-equal to plain on "
            f"{tuple(x.shape)} rows, sharp and soft, div +4.5% sep 0 and -4.5% sep 1%")
    torch.cuda.empty_cache()
    return count


KERNEL_MODULES = ("warp_kernel", "distance", "gather", "polylines_exact", "polylines",
                  "flash_attention")
KERNEL_NAMES = {"warp_kernel": "warp_rows", "distance": "edge_distances",
                "gather": "bounded_take_along_w", "polylines_exact": "polylines_exact_rows",
                "polylines": "polylines_scanline", "flash_attention": "flash_attention"}


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
            "polylines_exact_rows": 0, "polylines_scanline": 0, "flash_attention": 0}
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
            "polylines_exact_rows": 2, "polylines_scanline": 0, "flash_attention": 0}
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
        if (got["edge_distances"] != 1 or got["warp_rows"] != 0 or got["flash_attention"]
                or got["polylines_scanline"]
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
    ss_launches = phase_main_path_supersampled(dev, img_d, dep_d, bgr, dep_bgr)
    log("phase 3 ok: gpu_warp and polylines_sharp node paths and every fill, exact "
        "and supersampled, through their kernels")
    launches["polylines_exact_rows"] = poly_launches["polylines_exact_rows"]
    launches["bounded_take_along_w"] = fill_launches["none"]["bounded_take_along_w"]
    launches["polylines_scanline"] = ss_launches["polylines_sharp"]["polylines_scanline"]
    return launches, fill_launches


def phase_main_path_supersampled(dev, img_d, dep_d, bgr, dep_bgr):
    """The fills that reach the supersampled polylines renderer, with
    polylines_exact=False: stereo_pipeline on card tensors, then
    device_chunk (the video loop's chunk program) for polylines_sharp."""
    import torch
    from comfystereo_tpu_torch import StereoConfig, stereo_pipeline
    from comfystereo_tpu_torch.utils.video import device_chunk
    n, h, w = dep_d.shape
    out = {}
    for fill in LEGACY_FILLS:
        cfg = StereoConfig(fill_technique=fill, polylines_exact=False)
        reset_launches()
        res = stereo_pipeline(img_d, dep_d, cfg)
        sync()
        got = read_launches()
        out[fill] = got
        if (got["polylines_scanline"] != 2 or got["polylines_exact_rows"] != 0
                or got["edge_distances"] != 1 or got["warp_rows"] != 0 or got["flash_attention"]
                or (got["bounded_take_along_w"] > 0) != (fill == "hybrid_edge_plus")):
            raise AssertionError(f"{fill} (polylines_exact=False) launches {got}")
        o = res["stereo"][0]
        if tuple(o.shape) != (n, h, 2 * w, 3) or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{fill} (supersampled) output {tuple(o.shape)} not finite")
        q = o * 255.0
        if float((q - torch.round(q)).abs().max()) > 1e-3 or float(q.min()) < 0 \
                or float(q.max()) > 255:
            raise AssertionError(f"{fill} (supersampled) output is not uint8-valued")
        log(f"  stereo_pipeline {fill} polylines_exact=False 1080p B={n}: launches "
            f"supersampled polylines {got['polylines_scanline']}, exact polylines "
            f"{got['polylines_exact_rows']}, gather {got['bounded_take_along_w']}, distance "
            f"{got['edge_distances']}, black share {float(res['mask'].mean()):.5f}")
    cfg = StereoConfig(batch_size=n, fill_technique="polylines_sharp", polylines_exact=False)
    reset_launches()
    chunk = device_chunk(bgr, dep_bgr, cfg, device=dev)
    sync()
    got = read_launches()
    if got["polylines_scanline"] != 2 or got["polylines_exact_rows"] != 0:
        raise AssertionError(f"device_chunk polylines_sharp (supersampled) launches {got}")
    if chunk.dtype != torch.uint8 or tuple(chunk.shape) != (n, h, 2 * w, 3):
        raise AssertionError(f"device_chunk gave {chunk.dtype} {tuple(chunk.shape)}")
    log(f"  device_chunk polylines_sharp polylines_exact=False: uint8 BGR "
        f"{tuple(chunk.shape)}, launches {got}")
    return out


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
    for fill in LEGACY_FILLS:
        for blur in (False, True):
            cfg = StereoConfig(modes=modes, depth_map_blur=blur, fill_technique=fill,
                               polylines_exact=False)
            gpu = stereo_pipeline(image.to(dev), depth.to(dev), cfg)
            cpu = stereo_pipeline(image, depth, cfg)
            mask_off = float((gpu["mask"].cpu() != cpu["mask"]).float().mean())
            mean_err, over1, off = route_diff(gpu["stereo"], cpu["stereo"])
            # The card takes the kernel route, the CPU the twin: the JAX
            # package's bound for its kernel against its twin (mean |err| <
            # 0.05, < 0.1% of values off by more than 1 LSB); hybrid_edge_plus
            # adds the hybrid base's card-vs-CPU share (HYBRID_SHARE, 1 LSB).
            if fill == "hybrid_edge_plus":
                ok = over1 < 0.001 and off <= HYBRID_SHARE and mask_off <= 0.001
            else:
                ok = mean_err < 0.05 and over1 < 0.001 and mask_off <= 0.001
            if not ok:
                raise AssertionError(f"{fill} supersampled card vs CPU (blur {blur}): mean "
                                     f"|err| {mean_err:.5f}, {over1:.6f} of values > 1 LSB, "
                                     f"{off:.6f} differ, mask {mask_off:.6f}")
            log(f"  card (kernel) vs CPU (twin) {fill} polylines_exact=False blur={blur}: "
                f"mean |err| {mean_err:.5f}, > 1 LSB {over1:.6f}, differing {off:.6f}, mask "
                f"mismatch {mask_off:.6f}")
    check_routes_1080p(dev)
    log(f"phase 4 ok: stereo_pipeline card vs CPU on {n} frames {w}x{h}, gpu_warp "
        f"and {len(FILLS)} fills, {len(LEGACY_FILLS)} supersampled; kernel route vs "
        "twin at 1080p")


def route_diff(gpu_outs, cpu_outs):
    """(mean |err|, share of values more than 1 LSB apart, share that differ)
    over all packed outputs of the uint8 branch."""
    import torch
    total, n_over, n_off, n_all = 0.0, 0, 0, 0
    for g, c in zip(gpu_outs, cpu_outs):
        d = (torch.round(g.cpu() * 255.0) - torch.round(c * 255.0)).abs()
        total += float(d.sum())
        n_over += int((d > 1).sum())
        n_off += int((d > 0).sum())
        n_all += d.numel()
    return total / n_all, n_over / n_all, n_off / n_all


def check_routes_1080p(dev, n: int = FRAMES, h: int = HEIGHT, w: int = WIDTH):
    """apply_polylines' kernel route against its twin, both on the card, on
    the left eye of 12 frames at 1080p. Sharp: the JAX package's bound (mean
    |err| < 0.05, < 0.1% of values off by more than 1 LSB). Soft: mean |err|
    < 0.5, < 2% of values off by more than 1 LSB. At 1080p the fixture's flat
    depth gives offsets on the 1/8 sample grid (-8.4375 px at divergence
    4.5%), where a sample lies exactly on a point and neither group covers
    it: the kernel then takes a found group's left colour (its `neither`
    fallback), the twin the positive group's, black where that group found
    nothing, so whole rows come out 1/8 darker in the twin. JAX's own kernel
    and twin differ so on such rows (tests/test_torch_port_polylines.py)."""
    import torch
    from comfystereo_tpu_torch.ops import depth as depth_ops
    from comfystereo_tpu_torch.ops import polylines
    imgs, deps = fixture_frames(n, h, w)
    image = torch.from_numpy(imgs).to(dev).float()
    nd = depth_ops.normalize_depth(torch.from_numpy(deps).to(dev).float()) - 0.5
    for sharp in (True, False):
        outs = [polylines.apply_polylines(image, nd, DIV_PCT / 100.0 * w, 0.0, 2.0,
                                          sharp=sharp, impl=impl)
                for impl in ("kernel", "twin")]
        err = (outs[0] - outs[1]).abs()
        mean_err, over1 = float(err.mean()), float((err > 1).float().mean())
        if not (mean_err < 0.05 and over1 < 0.001 if sharp else
                mean_err < 0.5 and over1 < 0.02):
            raise AssertionError(f"kernel route vs twin at 1080p (sharp {sharp}): mean |err| "
                                 f"{mean_err}, {over1} of values > 1 LSB")
        log(f"  kernel route vs twin on the card, {n} frames {w}x{h}, sharp {sharp}: mean "
            f"|err| {mean_err:.6f}, > 1 LSB {over1:.7f}, differing "
            f"{float((err > 0).float().mean()):.6f}, mean kernel - twin "
            f"{float((outs[0] - outs[1]).mean()):.6f}")
        del outs, err
    torch.cuda.empty_cache()


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


# --- StereoDiffusion Fast path ---------------------------------------------

def sd_fixture(size: int, frames: int = 1):
    """`frames` fixture frames at size x size, each shifted sideways: image
    [n, s, s, 3] and depth [n, s, s] as float32 numpy in [0, 1]."""
    imgs, deps = fixture_frames(frames, size, size)
    return imgs.astype("float32") / 255.0, deps.astype("float32") / 255.0


@contextlib.contextmanager
def attention_as(fn):
    """Send the diffusion stack's kernel calls to `fn` for the time of the
    block (`diffusion/attention.py` looks the kernel's wrapper up at each
    call)."""
    from comfystereo_tpu_torch.kernels import flash_attention as fa
    kernel = fa.flash_attention
    fa.flash_attention = fn
    try:
        yield
    finally:
        fa.flash_attention = kernel


def exact_attention(q, k, v, scale: float):
    """Softmax attention of bf16 inputs computed wholly in float32 and
    rounded once to bf16: what the kernel and its plain version both
    approximate."""
    import torch
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@contextlib.contextmanager
def nan_guard_spy(seen: list):
    """Record how many non-finite values each call of the pipeline's NaN
    guard scrubs, so a run cannot pass by having its NaNs replaced."""
    import torch
    from comfystereo_tpu_torch.diffusion import sd_pipeline
    guard = sd_pipeline._nan_guard

    def spy(x):
        seen.append(int((~torch.isfinite(x)).sum()))
        return guard(x)

    sd_pipeline._nan_guard = spy
    try:
        yield
    finally:
        sd_pipeline._nan_guard = guard


def phase_diffusion(dev):
    """The StereoDiffusion node in Fast mode, node defaults, on one 512x512
    fixture frame, full-width SD 1.5-inpainting UNet + SD VAE in bf16 with
    seeded random weights; then the kernel against its plain version inside
    the model: one UNet CFG call, and the whole warp_inpaint."""
    import numpy as np
    import torch
    from comfystereo_tpu_torch.diffusion import (SD15_INPAINT_UNET_CONFIG, SD_VAE_CONFIG,
                                                 build_sd_model, schedulers, sd_pipeline)
    from comfystereo_tpu_torch.kernels import flash_attention as fa
    from comfystereo_tpu_torch.nodes.stereodiffusion import StereoDiffusionNode

    t0 = time.perf_counter()
    model = build_sd_model(SD15_INPAINT_UNET_CONFIG, SD_VAE_CONFIG, dtype=torch.bfloat16,
                           seed=0, device=dev)
    sync()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for m in (model.unet, model.vae) for p in m.parameters())
    img, dep = sd_fixture(SD_SIZE)
    seen = []
    reset_launches()
    t0 = time.perf_counter()
    with nan_guard_spy(seen):
        pair, left, right = StereoDiffusionNode().generate_stereo(img, dep, model=model,
                                                                  device=dev)
    node_s = time.perf_counter() - t0
    launches = read_launches()
    want = {k: 0 for k in launches}
    want["flash_attention"] = SD_UNET_CALLS * SD_FLASH_PER_CALL
    if launches != want:
        raise AssertionError(f"StereoDiffusion Fast launches {launches}, expected {want}")
    s = SD_SIZE
    if (tuple(pair.shape), tuple(left.shape), tuple(right.shape)) != (
            (1, s, 2 * s, 3), (1, s, s, 3), (1, s, s, 3)):
        raise AssertionError(f"node output shapes {tuple(pair.shape)}, {tuple(right.shape)}")
    for t in (pair, left, right):
        if not bool(torch.isfinite(t).all()) or float(t.min()) < 0 or float(t.max()) > 1:
            raise AssertionError("node outputs not finite or outside [0, 1]")
    if seen != [0]:
        raise AssertionError(f"the NaN guard scrubbed {seen} non-finite values")
    if not torch.equal(left, torch.from_numpy(img)):
        raise AssertionError("left eye differs from the input")
    img_d, dep_d = torch.from_numpy(img).to(dev), torch.from_numpy(dep).to(dev)
    warped, mask = sd_pipeline.backward_warp_right(img_d, dep_d, 5.0)
    prefilled = sd_pipeline.border_prefill(warped, mask).cpu()
    keep = ~mask.cpu()
    if not torch.equal(right[keep], prefilled[keep]):
        raise AssertionError("right eye differs from the prefilled warp outside the mask")
    changed = float((right - prefilled).abs()[~keep].mean())
    log(f"phase 3 StereoDiffusion Fast: model {n_params / 1e6:.1f}M parameters (bf16) "
        f"built in {build_s:.1f} s; node on 1 frame {s}x{s} in {node_s:.2f} s (first "
        f"call), launches {launches}; mask share {float(mask.float().mean()):.4f}, "
        f"mean |inpainted - prefill| inside the mask {changed:.4f}; left == input, "
        "right == prefilled warp outside the mask")

    # One bf16 UNet CFG call (batch 2, 64x64 latent, 9 channels) at the
    # path's first timestep with the kernel, its plain version, and exact
    # (f32) attention; and the whole warp_inpaint with the plain version.
    gen = torch.Generator().manual_seed(0)
    ls = s // 2 ** (len(model.vae.cfg.block_out_channels) - 1)
    lat = torch.randn((2, model.unet_in_channels, ls, ls), generator=gen).to(dev)
    ctx = torch.cat([model.text_encode("")] * 2, dim=0)
    t_first = int(schedulers.pndm_skip_timesteps(schedulers.make_pndm(20), 0.6)[0])
    kernel, calls = fa.flash_attention, []

    def record(q, k, v, scale):
        calls.append((q, k, v, scale))
        return kernel(q, k, v, scale)

    before = fa.LAUNCHES
    with attention_as(record):
        eps_k = model.unet_apply(lat, t_first, ctx)
    with attention_as(fa.reference):
        eps_p = model.unet_apply(lat, t_first, ctx)
        plain_out = sd_pipeline.warp_inpaint(
            model, img_d, dep_d, "", divergence=5.0, num_inference_steps=20, strength=0.6,
            guidance_scale=3.0, seed=np.array([SD_SEED], np.uint64))
    with attention_as(exact_attention):
        eps_x = model.unet_apply(lat, t_first, ctx)
    sync()
    if fa.LAUNCHES != before + SD_FLASH_PER_CALL or len(calls) != SD_FLASH_PER_CALL:
        raise AssertionError("the plain and exact runs launched the kernel")
    # The bf16 rounding floor of this model: the same (bf16-valued) weights
    # and inputs with every activation in float32.
    unet32 = copy.deepcopy(model.unet).float()
    eps_32 = unet32(lat, t_first, ctx.float())
    del unet32
    torch.cuda.empty_cache()
    if not all(bool(torch.isfinite(e).all()) for e in (eps_k, eps_p, eps_x, eps_32)):
        raise AssertionError("UNet eps not finite")
    # Each of the call's 10 attentions on its own inputs: the kernel's and
    # the plain version's distance from exact attention. Both round once per
    # product (the kernel its unnormalised weights, the plain version its
    # normalised ones) and once at the output, so the kernel may be no more
    # than 1.5 times as far from exact as the plain version is.
    per_call = []
    for q, k, v, scale in calls:
        x = exact_attention(q, k, v, scale)
        per_call.append((rel_l2(kernel(q, k, v, scale), x),
                         rel_l2(fa.reference(q, k, v, scale), x)))
    del calls
    bad = [(i, rk, rp) for i, (rk, rp) in enumerate(per_call) if rk > 1.5 * rp]
    if bad:
        raise AssertionError(f"kernel farther from exact attention than 1.5x the plain "
                             f"version: {bad}")
    # Through the whole network the rounding differences add up as noise of
    # the same size for both, so eps may be at most twice as far from eps
    # with exact attention.
    rel, rel_k, rel_p = rel_l2(eps_k, eps_p), rel_l2(eps_k, eps_x), rel_l2(eps_p, eps_x)
    floor = rel_l2(eps_p, eps_32)
    if rel_k > 2.0 * rel_p:
        raise AssertionError(f"UNet eps: kernel {rel_k} vs plain {rel_p} from exact attention")
    img_diff = (plain_out.right.cpu() - right).abs()
    log("  the UNet call's 10 attentions, relative L2 from exact (f32) attention, kernel / "
        "plain: " + ", ".join(f"{rk:.3g}/{rp:.3g}" for rk, rp in per_call))
    log(f"  UNet CFG call at t={t_first}: eps relative L2 kernel vs plain attention "
        f"{rel:.4g}; from eps with exact attention: kernel {rel_k:.4g}, plain {rel_p:.4g}; "
        f"bf16 (plain attention) vs the same weights in f32 {floor:.4g} (|eps| rms "
        f"{float(eps_p.float().pow(2).mean().sqrt()):.3g}); warp_inpaint with plain "
        f"attention vs the node's right eye: max |diff| {float(img_diff.max()):.4g}, mean "
        f"{float(img_diff.mean()):.3g}")
    log("phase 3 ok: StereoDiffusion Fast node through the flash kernel")
    return {"model": model, "launches": launches, "eps_rel_l2": rel, "eps_bf16_floor": floor,
            "eps_rel_exact": (rel_k, rel_p), "attention_rel_exact": per_call,
            "image_max_diff": float(img_diff.max()), "node_s": node_s,
            "lat": lat, "ctx": ctx, "t": t_first}


def phase_diffusion_card_vs_cpu(dev, size: int = 64):
    """warp_inpaint at the TINY configs in float32 (TF32 off) with the same
    seeded weights and the same injected noise on the card and on the CPU:
    the 9-channel inpainting form and the masked-latent form."""
    import dataclasses
    import torch
    from comfystereo_tpu_torch.diffusion import (TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG,
                                                 build_sd_model, schedulers, sd_pipeline)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off for the card-vs-CPU comparison")
    img, dep = (torch.from_numpy(a) for a in sd_fixture(size, frames=2))
    steps, strength = 6, 0.75
    n = len(schedulers.pndm_skip_timesteps(schedulers.make_pndm(steps), strength))
    f = 2 ** (len(TINY_SD_VAE_CONFIG.block_out_channels) - 1)
    lat_shape = (TINY_SD_VAE_CONFIG.latent_channels, size // f, size // f)
    cpu = torch.device("cpu")
    for cfg in (dataclasses.replace(TINY_SD_UNET_CONFIG, in_channels=9), TINY_SD_UNET_CONFIG):
        nine = cfg.in_channels == 9
        noise = sd_pipeline.frame_noise([7, 8], lat_shape, 0 if nine else n, cpu)
        outs, masks = [], []  # card, then CPU
        for d in (dev, cpu):
            m = build_sd_model(cfg, TINY_SD_VAE_CONFIG, seed=0, device=d)
            outs.append(sd_pipeline.warp_inpaint(
                m, img.to(d), dep.to(d), "a cat", divergence=8.0, num_inference_steps=steps,
                strength=strength, guidance_scale=3.0,
                noise=tuple(None if x is None else x.to(d) for x in noise)))
            masks.append(sd_pipeline.backward_warp_right(img.to(d), dep.to(d), 8.0)[1].cpu())
        if not torch.equal(masks[0], masks[1]):
            raise AssertionError("disocclusion masks differ card vs CPU")
        if not torch.equal(outs[0].left.cpu(), outs[1].left):
            raise AssertionError("left eye differs card vs CPU")
        err = float((outs[0].right.cpu() - outs[1].right).abs().max())
        # float32 on both, sums in other orders (cuDNN vs the CPU's
        # convolutions) through a 4-step loop on [0, 1] images.
        if err > 1e-3:
            raise AssertionError(f"warp_inpaint card vs CPU ({'9' if nine else '4'}-channel): "
                                 f"max |err| {err} > 1e-3")
        log(f"  card vs CPU warp_inpaint TINY {'9' if nine else '4'}-channel UNet, 2 frames "
            f"{size}x{size}, {n} steps, f32: masks equal, left equal, right max |err| "
            f"{err:.3g}")
    log("phase 4 ok: warp_inpaint card vs CPU at the TINY configs")


def flash_bound(bh: int, nq: int, nk: int, d: int, pk):
    """(bound ms, 'bytes' or 'operations', what bounds it): the largest of
    the q/k/v/out bytes at the memory rate, the 4*bh*nq*nk*d product
    operations at the bf16 tensor rate, and the bh*nq*nk exponentials at the
    special function units' rate."""
    bw, _, tensor, exps = pk
    times = {"bytes": 2.0 * bh * d * (2 * nq + 2 * nk) / bw * 1e3,
             "tensor products": 4.0 * bh * nq * nk * d / tensor * 1e3,
             "exponentials": float(bh) * nq * nk / exps * 1e3}
    what = max(times, key=times.get)
    return times[what], "bytes" if what == "bytes" else "operations", what


def diffusion_times(dev, sd, launches: int, err: float, smi: str, name: str):
    """The flash kernel beside its plain version, scaled_dot_product_attention
    and its bound at each shape; the bf16 UNet CFG call, VAE encode and
    decode, and warp_inpaint per frame with its device idle share."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from comfystereo_tpu_torch.diffusion import sd_pipeline
    from comfystereo_tpu_torch.kernels import flash_attention as fa

    key, pk = peaks(name)
    rows = []
    for bh, nq, nk, d in FLASH_SHAPES:
        q, k, v = flash_inputs(dev, bh, nq, nk, d, seed=1)
        scale = d ** -0.5
        q4, k4, v4 = (t.reshape(2, bh // 2, -1, d) for t in (q, k, v))
        ms = time_ms(lambda: fa.flash_attention(q, k, v, scale), iters=20)
        plain_ms = time_ms(lambda: fa.reference(q, k, v, scale), iters=3, warmup=1)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale),
                         iters=20)
        bound, by, what = flash_bound(bh, nq, nk, d, pk)
        rows.append((ms, plain_ms, lib_ms, bound, by))
        log(f"  flash_attention {(bh, nq, nk, d)}: {ms:.4f} ms/launch, bound {bound:.4f} ms "
            f"({what}, {key} peaks; {100 * bound / ms:.1f}% of it reached), plain "
            f"{plain_ms:.3f} ms, scaled_dot_product_attention {lib_ms:.4f} ms [{smi}]")
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    ms, plain_ms, lib_ms, bound, by = rows[0]
    entry = {"name": "flash_attention", "route": "cuda",
             "source": "comfystereo_tpu_torch/csrc/flash_attention.cu",
             "replaces": "comfystereo_tpu/pallas/flash_attention.py:164", "launches": launches,
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": by, "library_ms": lib_ms}

    model, s = sd["model"], SD_SIZE
    unet_ms = time_ms(lambda: model.unet_apply(sd["lat"], sd["t"], sd["ctx"]), iters=5)
    x = torch.rand((1, 3, s, s), device=dev) * 2 - 1
    z = torch.randn((1, model.latent_channels) + tuple(sd["lat"].shape[-2:]), device=dev)
    enc_ms = time_ms(lambda: model.vae_encode(x), iters=5)
    dec_ms = time_ms(lambda: model.vae_decode(z), iters=5)
    img, dep = (torch.from_numpy(a).to(dev) for a in sd_fixture(s))

    def run():
        return sd_pipeline.warp_inpaint(model, img, dep, "", divergence=5.0,
                                        num_inference_steps=20, strength=0.6,
                                        guidance_scale=3.0,
                                        seed=np.array([SD_SEED], np.uint64))
    run()
    sync()
    t0 = time.perf_counter()
    for _ in range(2):
        run()
    sync()
    frame_ms = (time.perf_counter() - t0) / 2 * 1e3
    calls, half = SD_UNET_CALLS, launches // 2  # half the launches at each level
    log(f"  StereoDiffusion Fast {s}x{s} bf16 [{smi}]: UNet CFG call "
        f"{tuple(sd['lat'].shape)} {unet_ms:.3f} ms; VAE encode {enc_ms:.3f} ms, decode "
        f"{dec_ms:.3f} ms; warp_inpaint {frame_ms:.1f} ms/frame ({calls} UNet calls = "
        f"{calls * unet_ms:.1f} ms, 2 encodes + 1 decode = {2 * enc_ms + dec_ms:.1f} ms, "
        f"flash kernel {half} x {rows[0][0]:.4f} + {half} x {rows[1][0]:.4f} = "
        f"{half * (rows[0][0] + rows[1][0]):.1f} ms)")
    times = {"unet_cfg_ms": unet_ms, "vae_encode_ms": enc_ms, "vae_decode_ms": dec_ms,
             "warp_inpaint_ms_per_frame": frame_ms,
             "flash_ms": [r[0] for r in rows], "flash_plain_ms": [r[1] for r in rows],
             "flash_sdpa_ms": [r[2] for r in rows], "flash_bound_ms": [r[3] for r in rows]}
    times.update(idle_share("warp_inpaint", run, frame_ms, smi, iters=1))
    return entry, times


def phase_times(dev, launches, errs, smi: str, name: str,
                n: int = FRAMES, h: int = HEIGHT, w: int = WIDTH):
    import torch
    from comfystereo_tpu_torch import StereoConfig, stereo_pipeline
    from comfystereo_tpu_torch.kernels import distance, warp_kernel

    key, (bw, flops, _, _) = peaks(name)
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
    ss_t = polylines_ss_times(image * 255.0, depth255)

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
        entry("polylines_scanline", "comfystereo_tpu_torch/csrc/polylines.cu",
              "comfystereo_tpu/pallas/polylines_kernel.py:281", ss_t["ms"],
              ss_t["plain_ms"], ss_t["bytes"], ss_t["ops"],
              errs["polylines_ss_max_abs_err"]),
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
    log(f"  supersampled polylines soft: {ss_t['soft_ms']:.4f} ms/launch; sharp: "
        f"{ss_t['ops']:.4g} operations ({ss_t['ops'] / (n * h * w):.1f} per pixel), "
        f"{ss_t['bytes']:.4g} bytes, found share {ss_t['found_share']:.4f} [{smi}]")

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
    x, coord, colors, max_disp = polylines_inputs(image255, depth255, DIV_PCT, 0.0)
    cl = coord.abs()
    kw = dict(max_pieces=12, max_disp=max_disp)
    ms = time_ms(lambda: pk.polylines_exact_rows(x, cl, colors, sharp=True, **kw))
    soft_ms = time_ms(lambda: pk.polylines_exact_rows(x, cl, colors, sharp=False, **kw))
    plain_ms = time_ms(lambda: pk.polylines_exact_rows_plain(x, cl, colors, True, 12,
                                                             max_disp), iters=2, warmup=1)
    work = polylines_work(x, max_disp, True, colors.shape[-1])
    nbytes = 4.0 * (x.numel() + cl.numel() + 2 * colors.numel())
    return {"ms": ms, "soft_ms": soft_ms, "plain_ms": plain_ms, "bytes": nbytes, **work}


def polylines_ss_times(image255, depth255):
    """The supersampled polylines kernel (sharp, S = 8, K = 4; and soft) and
    its plain version on the left eye's rows at 1080p, with the bytes (x,
    coord and colour in, colour sums out: 4 B each per pixel and channel)
    and the operations of the sharp call on this input (`polylines_ss_work`)."""
    from comfystereo_tpu_torch.kernels import polylines as pk
    x, coord, colors, max_disp = polylines_inputs(image255, depth255, DIV_PCT, 0.0)
    kw = dict(samples=8, k_candidates=4, max_disp=max_disp)
    ms = time_ms(lambda: pk.polylines_scanline(x, coord, colors, sharp=True, **kw))
    soft_ms = time_ms(lambda: pk.polylines_scanline(x, coord, colors, sharp=False, **kw))
    plain_ms = time_ms(lambda: pk.polylines_scanline_plain(x, coord, colors, sharp=True, **kw),
                       iters=3, warmup=1)
    work = polylines_ss_work(x, coord, max_disp, True, colors.shape[-1])
    nbytes = 4.0 * (x.numel() + coord.numel() + 2 * colors.numel())
    return {"ms": ms, "soft_ms": soft_ms, "plain_ms": plain_ms, "bytes": nbytes, **work}


def polylines_ss_work(x, coord, max_disp: int, sharp: bool, c: int, samples: int = 8,
                      k: int = 4):
    """The float operations (adds, products, divisions, compares, min/max)
    csrc/polylines.cu does on rows `x`, counted from its code and this input:
    - per slot of the W + 1: the endpoints (2), the member and order tests
      (5), sharp the flat tops (2) and their min/max (2), and the two scans'
      min/max (4);
    - per column: the two searches' compares (2 per round, and col + 1) and
      the candidates' hit keys (between: 2 ends, 2 member tests, x1 > x0;
      within: 2 ends and 2 tests) for both groups;
    - per column and sample: the sample position (3); per group the key
      compares (one per candidate), the winner's rebuild (5, where a
      candidate is hit: counted from this input), denom (3), ip (4), covered
      (2), closeness (4) and 3 per channel; the combine (1) and the sums (C)."""
    import torch
    from comfystereo_tpu_torch.kernels import polylines as pk
    n, w = x.shape
    rounds = pk.search_rounds(max_disp)
    n_cands = 2 * k if sharp else k
    e_hi, e_lo = pk.endpoint_streams(x, coord, sharp)
    bases = (pk.search(torch.cummax(e_hi, -1).values, max_disp, True),
             pk.search(torch.cummin(e_lo.flip(-1), -1).values.flip(-1), max_disp, False))
    del e_hi, e_lo
    cols = torch.arange(w, dtype=torch.float32, device=x.device)
    found = 0.0
    for base, up in zip(bases, (True, False)):
        # one stand-in colour channel: the keys need only the ends and members
        cands = pk.candidates(base, x, coord.abs(), coord, x[..., None], sharp, k, up)
        keys = [torch.where(mem & (x1 > x0), x1 if up else x0,
                            -float("inf") if up else float("inf"))
                for x0, x1, _, _, _, _, mem in cands]
        del cands
        ext = torch.stack(keys).amax(0) if up else torch.stack(keys).amin(0)
        del keys
        for t in range(samples):
            s = cols + pk.sample_offset(t, samples)
            found += float(((ext > s) if up else (ext < s)).sum())
    per_slot = 15.0 if sharp else 11.0
    per_column = 2 * rounds + 1 + 2 * (k * (9 if sharp else 5))
    per_group_sample = n_cands + 3 + 4 + 2 + 4 + 3 * c
    per_sample = 3 + 2 * per_group_sample + 1 + c
    ops = (n * (w + 1) * per_slot + n * w * per_column + n * w * samples * per_sample
           + 5.0 * found)
    return {"ops": ops, "found_share": found / (2.0 * n * w * samples)}


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
    for fill in LEGACY_FILLS:
        cfg = StereoConfig(fill_technique=fill, polylines_exact=False)
        ms = time_ms(lambda: stereo_pipeline(image, depth01, cfg), iters=5, warmup=1)
        out[f"{fill} supersampled"] = {"ms_per_chunk": ms, "ms_per_frame": ms / n,
                                       "fps": n * 1e3 / ms}
        log(f"  pipeline 1080p B={n} {fill} polylines_exact=False: {ms / n:.4f} ms/frame, "
            f"{n * 1e3 / ms:.2f} fps [{smi}]")
    for label, exact in (("polylines_sharp", True), ("polylines_sharp supersampled", False)):
        cfg = StereoConfig(fill_technique="polylines_sharp", polylines_exact=exact)
        stages = stage_times(image, depth01, cfg)
        log(f"  {label} stages per chunk: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in stages.items()) + f" [{smi}]")
        out[label]["stages_ms"] = stages
        out[label].update(idle_share(label, lambda: stereo_pipeline(image, depth01, cfg),
                                     out[label]["ms_per_chunk"], smi))
    for fill in ("none", "hybrid_edge"):
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


def idle_share(label: str, fn, chunk_ms: float, smi: str, iters: int = 3):
    """Device busy time of `fn` (torch.profiler) against the event-timed time
    of the same profiled calls, the idle share 1 - busy/wall unclamped, and
    the six largest device items. The share is None, and said to be not
    measured, when the profiler saw no device time or more than the wall."""
    busy_ms, wall_ms, top = device_busy(fn, iters)
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
    sd = phase_diffusion(dev)
    launches["flash_attention"] = sd["launches"]["flash_attention"]
    phase_card_vs_cpu(dev)
    phase_diffusion_card_vs_cpu(dev)
    kernels, pipeline = phase_times(dev, launches, errs, smi, name)
    flash, pipeline["stereodiffusion_fast"] = diffusion_times(
        dev, sd, launches["flash_attention"], errs["flash_max_abs_err"], smi, name)
    kernels.append(flash)
    log(f"phase 5 ok: StereoDiffusion times on {name} ({smi})")

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    log("pipeline " + json.dumps(pipeline))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
