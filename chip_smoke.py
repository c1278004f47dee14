#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times [--root DIR]

Runs from the repository root (it imports `comfystereo_tpu_torch` from
beside itself; it never imports JAX or `comfystereo_tpu`). Phases, in order;
any failure ends the run with a non-zero exit code:

1. device: the card's name and power limit; build all six kernels with
   nvcc (sm_90a, one nvcc per source, all started together);
2. kernels vs their plain PyTorch versions on the card, at the main path's
   shapes (12 frames of 1080x1920 as [12*1080, 1920] rows): the warp on the
   fixture depth and on uniform-noise depth, divergence +-4.5% of the width
   with separation 0 and 1%, through the entry taking offsets and the fused
   entry taking the depth (gap masks bit-equal; colours atol 1e-5 on the
   fixture, < 0.1% of pixels differing on noise), and the edge-distance
   kernel through the entry taking masks (four mask pairs) and the fused
   entry forming the blur's weights from fixture, noise and flat depth
   (bit-equal), and the box-blend kernel on those weights and depths, with
   the cells' window (20 taps, radius 6), no vertical box and a radius past
   its register ring (bit-equal); the bounded gather against torch.gather at the
   fills' shapes, int32 keys and a [B,1,H,W] index plane over [B,3,H,W]
   colour (bit-equal); the exact polylines against its plain version on
   the same 12 frames, sharp and soft, divergence +-4.5% with separation 0
   and 1%, fixture and noise depth, through both entries (bit-equal; the
   columns whose candidate list overflowed counted by the kernel and held
   to the model's count; and with lists of capacity 2, which overflow on
   most columns); the supersampled polylines kernel against its plain
   version on the same 12 frames, sharp and soft, divergence +4.5% with
   separation 0 and -4.5% with 1%, fixture and noise depth (colour sums
   bit-equal; the fused entry's finished colour too); the flash attention against
   its plain version (`reference`) at the SD 1.5 UNet's bf16 self-attention
   shapes, [BH, Nq, Nk, D] = [16, 4096, 4096, 40] (level 0, CFG batch 2 x 8
   heads), [16, 1024, 1024, 80] (level 1) and [16, 4096, 8192, 40] (BN 'bi'),
   atol 4e-3 on bf16 outputs compared in float32, and a shape outside
   `supports` (cross-attention, 77 keys) that takes no launch; and the
   flash kernel's gradient (its autograd: the kernel forward, a backward
   that recomputes `reference_bf16`) at the null-text shapes [8, 4096,
   4096, 40] and [16, 4096, 8192, 40]: the backward is `reference_bf16`'s
   VJP bit for bit and launches nothing, and d(sum o^2) is within 4e-3 (dq)
   and 1e-2 (dk, dv) of `reference_bf16`'s own gradient;
2b. the kernels' input contracts: the exact polylines kernel at max_pieces
   1, 4, 8, 12 and 16 (both of its slot templates) and the supersampled one
   at k_candidates 1, 2, 4 and 8, sharp and soft, through the fused entries
   on the same 12 frames, each bit-equal to its plain version with one
   launch counted per call, and timed; C = 4 through the warp and both
   polylines routes on the same frames, 16,384-column frames through the
   warp, the gather and both polylines kernels (their workspace or direct
   instances) and 327,680-column rows through the distance kernel, each
   with one launch and its plain version's result, both timed; max_pieces
   17 and k_candidates 9 raising before any launch;
3. the main paths at full size, each with every launch counter set to 0 just
   before and read just after: StereoImageNode().generate on 12 frames of
   1920x1080 with the default config (gpu_warp, depth blur, left-right,
   batch_size=12: warp 2, distance 1, box blend 1), then device_chunk on the same frames
   as uint8 BGR (its result page-locked on the host, within 1 LSB of the
   node's); the node with "Fill - Polylines Sharp" (polylines 2,
   distance 1, box blend 1, warp 0); stereo_pipeline once for each other fill at 1080p
   B=12 (gather launches printed; every gather fill must launch it); with
   polylines_exact=False, stereo_pipeline for polylines_sharp,
   polylines_soft and hybrid_edge_plus (supersampled polylines 2, exact
   polylines 0, distance 1, gather only for hybrid_edge_plus; uint8-valued
   outputs) and device_chunk for polylines_sharp (2 a group of frames); the
   StereoDiffusion node in Fast (Warp + Inpaint) mode with its defaults on
   one 512x512 fixture frame, on the full-width SD 1.5-inpainting UNet and
   SD VAE in bfloat16 with seeded random weights (13 UNet calls x 10
   self-attentions on the card: 13 calls served by one captured CUDA
   graph, so the flash wrapper's host launches are 20, the warm-up's and
   the capture's), then one UNet CFG call (eagerly) and the whole
   warp_inpaint with the attention forced to its plain version; the
   node in Standard (DDIM) mode with its defaults (20 steps, guidance 3,
   'uni', deblur off, null-text on) on the same frame, on the full-width SD
   1.5 UNet and SD VAE in bfloat16 with seeded random weights, then a short
   second call ('bi', deblur on, 5 steps, no null-text): flash host
   launches 10 per eager UNet forward (null-text's inner iterations) and
   per warm-up and capture of a graph, twice that for stereo-active CFG
   calls, none for a replay, the UNet calls counted around `unet_apply`
   (the backward launches none); outputs
   finite in [0, 1]; one null-text gradient of u at full width through
   the kernel against the plain attention's (relative L2 <= 0.05); and,
   from two diffusers-layout directories written under build/sd_checkpoints/
   before the diffusion parts (seeded float16 weights by the port's own
   safetensors writer: SD 1.5-inpainting and SD 1.5, each with the CLIP
   ViT-L/14 text tower and a vocab generated at CLIP's size), the node
   resolving its own model offline: Fast mode with `inpaint_model_id`
   (`load_inpainting_model`, bf16, the checkpoint's CLIP; flash host
   launches 20, one capture), one
   CFG call of that bundle bit-equal to `build_sd_model`'s on the same
   float16 weights, the w8 model's CFG call within 0.05 of it (flash 20,
   its capture),
   Standard mode with `model_id` (5 steps, no null-text; float32, flash 0),
   and an id on no disk falling back loudly to the toy model on the card;
   then stereo_pipeline on sharded chunks (`parallel/`) at 1080p B=12: the
   default config packed left-right and top-bottom on a "data" mesh over
   every local card and on a (2, 2) ("data", "seq") mesh on cuda:0 (the
   row path: halo rows and per-frame extrema exchanged), and naive and
   polylines_sharp on the (2, 2) mesh, each with the counters set to 0
   just before and read just after: each kernel launched once per block
   as often as on the unsharded chunk (gpu_warp: warp 2 and distance 1
   per block), every output bit-equal to the unsharded chunk;
   `graft_entry.dryrun_multichip(4, device="cuda:0")` (sharded gpu_warp
   and naive bit-equal to one device, a data-parallel null-text step and
   TINY UNet forward against one device's); and the VR nodes on the card's
   gpu_warp output (no headset: the image node says the viewer is
   unavailable and returns its card input; the status names the card);
4. card vs CPU: the division by a scalar each way (the share of values
   that differ from the CPU's; `device.true_divide` must give the CPU's
   bits) and pow at a few exponents; the port's stereo_pipeline on 2
   frames of 270x480 on the card and on the CPU, blur off and on alike, gpu_warp (mask and depth outputs
   bit-equal, colours within 1e-5) and all ten fills (uint8 bit-equal; the
   hybrid fills within 1 LSB on at most HYBRID_SHARE), and the three supersampled fills (the kernel route on the card, the twin
   on the CPU) to the JAX package's kernel-vs-twin bound; the kernel route
   against the twin on the card at 1080p B=12, sharp to that bound, soft to
   a wider one (see `check_routes_1080p`);
   warp_inpaint at the TINY UNet (9- and 4-channel) and VAE configs in
   float32 with the same injected noise on the card and on the CPU; and
   text2stereo at the TINY configs (4 steps, null-text with 2 inner steps,
   deblur on, the same injected noise), left and right within 1e-3; and a
   TINY checkpoint directory read by the port's own safetensors parser and
   loaded in float32 on the card and on the CPU: text embeddings, a UNet
   call, VAE encode and decode and the w8 TINY model's eps within 1e-4;
   the backward-warp family (`ops/backward_warp.py`) on the first two
   frames of the 1080p chunk, card against CPU (masks bit-equal, colours
   within BW_ATOL);
5. times with CUDA events (warm-up, then >= 10 iterations, fewer for the
   slowest plain versions): each kernel and its plain version at the main
   path's shapes beside the bound (and torch.gather beside the gather; the
   warp and distance kernels through the fused entries the path launches,
   beside the entries of the Pallas contracts, with the warp's prefilter
   counts), the
   gpu_warp pipeline's ms/frame and fps at 1080p, batch 12, in float32 and
   bfloat16, and the fills' ms/frame at the same size (the three supersampled
   ones too), with stage breakdowns and device idle shares for gpu_warp and
   polylines_sharp, exact and supersampled, and gpu_warp's blur and eye part
   by part; the flash kernel,
   its plain version and `scaled_dot_product_attention` (a yardstick the
   port never calls) at the three shapes, the bf16 UNet CFG call, VAE
   encode and decode, and warp_inpaint per frame with its idle share; the
   flash backward (its recompute) at [8, 4096, 4096, 40] beside SDPA's
   backward; the Standard frame at the node's defaults part by part (VAE
   encode and round trip, DDIM inversion, null-text with its inner
   iterations and ms per iteration, the denoising loop's CFG calls before
   and after the stereo start, the decode), its peak device memory and
   its idle share (each part's unit profiled, weighted by time); for
   the checkpoint directories' write and load seconds, CLIP encode of one
   prompt (bf16 and float32, first call and cached), the Fast frame through
   the loaded bundle against `build_sd_model`'s in turns, and the w8 CFG
   call against bf16 with the UNet's bytes as stored and each call's peak
   device memory; for
   the polylines kernels' times by max_pieces and k_candidates from phase
   2b (in the `kernels` line); for
   the kernels redesigned after their port (all six) their registers,
   spills and shared memory from `-Xptxas -v`, for the gather of a colour plane its
   bound, and for the polylines kernels their recounted operations beside
   their previous design's count. The polylines kernels are timed through
   the fused entries their routes launch. Also the sharded gpu_warp chunk
   beside the unsharded one in turns, on both meshes, and the backward-warp
   family's ms per 1080p B=12 chunk;
6. the BASELINE lines at full size (`BASELINE_LINES`): the headline
   (1080p B=4 gpu_warp) and BASELINE.md's five (512x512 naive; the 1080p
   polylines sweep, exact and supersampled; 720p B=12 hybrid_edge
   top-bottom; 4K gpu_warp anaglyph with its mask check; 4K B=2 every fill
   at balance 0 and 0.5), driven through stereo_pipeline. The counters are
   set to 0 just before each configuration and read just after: each
   line's launches of one pass exactly `BENCH_LAUNCHES`, and over the
   line's whole run every kernel its fills need launched and no other.
   Configs 1 and 2 (exact) differ from the CPU oracle's stereo pair in no
   uint8 value, and config 4's gap mask equals the oracle's, at the
   oracle's reduced width. Each line's pass is then run again with every
   kernel's plain version in its place, on the same card tensors at the
   line's shapes (4K included), and must give the same outputs (gpu_warp's
   colours within 1e-5, all else bit-equal).

`--kernel-times` only builds and times the flash kernel (beside
scaled_dot_product_attention), the gather (beside torch.gather), both
polylines kernels (sharp and soft, through the entries that take x, and
the fused entries where the tree has them), the warp and distance
kernels (through the entries of the Pallas contracts, and the fused
entries where the tree has them), and the blur's box sums and blends after
the edge weights (the box-blend kernel where the tree has it, beside its
bound and the plain composition, which every tree has) and prints one JSON
line; with
`--root DIR` it imports the package from DIR, so that a parent tree
unpacked under `build/` and the change can be timed in turns in one call.

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

# Flash attention shapes [BH, Nq, Nk, D] of the SD 1.5 UNet at 512x512 in
# bf16 with CFG (batch 2): level 0 (the timed one), level 1, BN 'bi'.
FLASH_SHAPES = ((16, 4096, 4096, 40), (16, 1024, 1024, 80), (16, 4096, 8192, 40))
SD_SIZE, SD_SEED = 512, 1337
# The node's Fast-mode defaults: 20 PNDM steps at strength 0.6 keep 13 of
# the 21 PLMS timesteps; each UNet call runs 10 self-attentions the kernel
# takes (5 at 4096 tokens, 5 at 1024).
SD_UNET_CALLS, SD_FLASH_PER_CALL = 13, 10
# Gradient shapes of the null-text backward: level 0 of one UNet call on one
# latent (8 heads), and the BN 'bi' pair shape.
FLASH_GRAD_SHAPES = ((8, 4096, 4096, 40), (16, 4096, 8192, 40))
# The node's Standard-mode defaults (20 DDIM steps, guidance 3, 'uni', deblur
# off, null-text on with 10 inner steps), and the short second call.
STD_DEFAULTS = dict(pipeline_mode="Standard (DDIM)", scale_factor=5.0, direction="uni",
                    deblur=False, guidance_scale=3.0, num_inference_steps=20,
                    null_text_optimization=True, seed=SD_SEED)
STD_SHORT = dict(STD_DEFAULTS, direction="bi", deblur=True, num_inference_steps=5,
                 null_text_optimization=False)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks(name: str):
    """(bytes/s, float32 FLOP/s, bf16 tensor FLOP/s, exponentials/s): the
    H100 SXM's published peaks, from `stereo_bench/counts/peaks.py`. Every
    card is measured against them; a card named otherwise is said to be."""
    from stereo_bench.counts import peaks as pk
    if "H100" not in name:
        log(f"{name} is not an H100: its times are measured against the H100 SXM's peaks")
    return pk.BYTES_PER_S, pk.FLOP_PER_S, pk.TENSOR_FLOP_PER_S, pk.EXP_PER_S


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


def warp_max_disp(div_px: float, sep_px: float) -> int:
    """ops/warp.forward_warp's displacement bound at exponent 2, convergence
    0.5."""
    import math
    return int(math.ceil(0.5 ** 2.0 * abs(div_px) + abs(sep_px))) + 4


def warp_rows_inputs(image, depth255, div_pct: float, sep_pct: float):
    """The warp kernel's row arguments for the entry that takes offsets,
    computed as the fused entry's plain composition computes them
    (normalized depth, offsets, max_disp)."""
    from comfystereo_tpu_torch.ops import depth as depth_ops
    b, h, w, c = image.shape
    div_px, sep_px = depth_ops.percent_to_px(div_pct, sep_pct, w)
    nd = depth_ops.normalize_depth(depth255)
    off = depth_ops.pixel_offsets(nd, div_px, sep_px, 2.0, 0.5, prenormalized=True)
    return (off.reshape(b * h, w).contiguous(), nd.reshape(b * h, w).contiguous(),
            image.reshape(b * h, w, c).contiguous(),
            dict(gradient_threshold=1.5, max_stretch=8, max_disp=warp_max_disp(div_px, sep_px)))


def warp_fused_inputs(image, depth255, div_pct: float, sep_pct: float):
    """The fused warp entry's arguments, as ops/warp.forward_warp passes
    them: the depth rows, each image's min and max, the colour rows and the
    keywords."""
    import torch
    from comfystereo_tpu_torch.ops import depth as depth_ops
    b, h, w, c = image.shape
    div_px, sep_px = depth_ops.percent_to_px(div_pct, sep_pct, w)
    rows = depth255.reshape(b * h, w).contiguous()
    dmin, dmax = torch.aminmax(rows.reshape(b, h * w), dim=-1)
    kw = dict(divergence_px=div_px, separation_px=sep_px, exponent=2.0, convergence_point=0.5,
              gradient_threshold=1.5, max_stretch=8, max_disp=warp_max_disp(div_px, sep_px),
              height=h)
    return rows, dmin, dmax, image.reshape(b * h, w, c).contiguous(), kw


def edge_masks(depth255):
    """The depth blur's two edge masks as [rows, W] (ops/blur.py, edge
    threshold 20), dividing truly as the blur does."""
    import torch
    from comfystereo_tpu_torch.ops import blur
    grad = blur.sobel_x(depth255)
    div = torch.full((), 200.0, device=depth255.device)
    strong = torch.clamp(grad.abs() / div, 0.0, 1.0) > 0.5
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
    from comfystereo_tpu_torch.kernels import distance

    imgs, deps = fixture_frames(n, h, w)
    image = torch.from_numpy(imgs).to(dev).float() / 255.0
    fixture_d = torch.from_numpy(deps).to(dev).float()
    rng = np.random.default_rng(0)
    noise_d = torch.from_numpy(
        rng.uniform(0, 255, (n, h, w)).astype(np.float32)).to(dev)
    cases = [(kind, d, sign * DIV_PCT, sign * sep + 0.0, "float32")
             for kind, d in (("fixture", fixture_d), ("noise", noise_d))
             for sep in SEP_PCTS for sign in (1.0, -1.0)]
    cases.append(("fixture", fixture_d, DIV_PCT, 0.0, "bfloat16"))
    warp_err = check_warp(image, cases)
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
    flat_d = torch.full_like(fixture_d, 77.0)
    depths = (("fixture", fixture_d), ("noise", noise_d), ("flat", flat_d))
    for kind, d in depths:
        kw = dict(edge_threshold=20.0, mask_radius=20, falloff=2.0, height=h)
        rows = d.reshape(-1, w).contiguous()
        kl, kr = distance.edge_weights_fused(rows, **kw)
        sync()
        pl, pr = distance.edge_weights_plain(rows, **kw)
        sync()
        if not (torch.equal(kl, pl) and torch.equal(kr, pr)):
            raise AssertionError(f"edge weights (fused entry) differ from plain ({kind})")
        n_blend = check_box_blend(d, kl.reshape(d.shape), kr.reshape(d.shape), kind)
    log(f"phase 2: warp kernel vs plain on [{n * h}, {w}] rows, both entries: gap masks "
        f"bit-equal in {len(cases)} cases each, fixture max |err| {warp_err:.3g}; "
        f"distance kernel bit-equal on {len(masks)} mask pairs, its fused entry on "
        f"{len(depths)} depths (fixture, noise, flat); box-blend kernel bit-equal on "
        f"those depths and weights, {n_blend} windows each")
    del flat_d, masks
    n_gather = check_gather(dev, n, h, w)
    n_poly = check_polylines(dev, image * 255.0,
                             {"fixture": fixture_d, "noise": noise_d})
    n_ss = check_polylines_ss(image * 255.0, {"fixture": fixture_d, "noise": noise_d})
    del image, fixture_d, noise_d
    flash_err = check_flash(dev)
    grad_errs = check_flash_grad(dev)
    log(f"phase 2 ok: warp, distance, gather ({n_gather} cases), polylines "
        f"({n_poly} cases), supersampled polylines ({n_ss} cases) and flash "
        f"attention ({len(FLASH_SHAPES)} shapes; its gradient at {len(FLASH_GRAD_SHAPES)}) "
        "kernels agree with their plain versions")
    return {"warp_max_abs_err": warp_err, "distance_max_abs_err": 0.0,
            "box_blend_max_abs_err": 0.0, "gather_max_abs_err": 0.0, "polylines_max_abs_err": 0.0,
            "polylines_ss_max_abs_err": 0.0, "flash_max_abs_err": flash_err,
            "flash_grad_max_abs_err": grad_errs}


# (taps, radius) of the box-blend checks: the cells' window, no vertical
# box, and a radius past the kernel's register ring.
BOX_BLEND_WINDOWS = ((20, 6), (20, 0), (5, 12))


def check_box_blend(depth, wl, wr, kind: str) -> int:
    """The box-blend kernel against its plain version on [n, h, w] depth and
    its edge weights, one launch a call; returns the windows checked."""
    import torch
    from comfystereo_tpu_torch.kernels import box_blend
    for taps, radius in BOX_BLEND_WINDOWS:
        before = box_blend.LAUNCHES
        got = box_blend.box_blend(depth, wl, wr, taps=taps, radius=radius)
        sync()
        if box_blend.LAUNCHES != before + 1:
            raise AssertionError("box_blend did not launch its kernel once")
        want = box_blend.box_blend_plain(depth, wl, wr, taps=taps, radius=radius)
        sync()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"box-blend kernel differs from plain ({kind}, {taps} taps, "
                                 f"radius {radius})")
    return len(BOX_BLEND_WINDOWS)


def check_warp(image, cases) -> float:
    """Both warp entries against their plain versions on each case (kind,
    depth, divergence %, separation %, colour dtype): the entry taking
    offsets and nd, and the fused entry, which forms them from the depth.
    Gap masks bit-equal; colours within 1e-5 on the fixture, under 0.1% of
    pixels differing on noise. Returns the fixture's max |err|."""
    import torch
    from comfystereo_tpu_torch.kernels import warp_kernel
    warp_err = 0.0
    for kind, d, div, sep, cdt in cases:
        img = image.to(getattr(torch, cdt))
        off, nd, rows, kw = warp_rows_inputs(img, d, div, sep)
        depth_rows, dmin, dmax, _, fkw = warp_fused_inputs(img, d, div, sep)
        runs = (("rows", lambda: warp_kernel.warp_rows(off, nd, rows, **kw),
                 lambda: warp_kernel.warp_rows_plain(off, nd, rows, **kw)),
                ("fused", lambda: warp_kernel.warp_rows_fused(depth_rows, dmin, dmax, rows, **fkw),
                 lambda: warp_kernel.warp_rows_fused_plain(depth_rows, dmin, dmax, rows, **fkw)))
        for entry, kernel, plain in runs:
            out_k, gap_k = kernel()
            sync()
            out_p, gap_p = plain()
            sync()
            if not torch.equal(gap_k, gap_p):
                raise AssertionError(
                    f"warp gap mask differs ({entry}, {kind}, div {div}%, sep {sep}%): "
                    f"{int((gap_k != gap_p).sum())} px")
            err = (out_k.float() - out_p.float()).abs()
            max_err = float(err.max())
            off_px = float((err.amax(-1) > 1e-5).float().mean())
            if kind == "fixture":
                if max_err > 1e-5:
                    raise AssertionError(f"warp colour error {max_err} > 1e-5 ({entry}, "
                                         f"div {div}%, sep {sep}%, {cdt})")
                warp_err = max(warp_err, max_err)
            elif off_px >= 0.001:
                raise AssertionError(f"warp colours differ on {off_px:.5f} of noise "
                                     f"pixels ({entry}, div {div}%, sep {sep}%)")
            log(f"  warp {entry} {kind} div {div:+.1f}% sep {sep:.1f}% {cdt}: gap bit-equal, "
                f"max |err| {max_err:.3g}, px > 1e-5: {off_px:.6f}")
            del out_k, gap_k, out_p, gap_p, err
    return warp_err


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


def flash_grads(fn, q, k, v, scale: float):
    """Gradients of sum(o^2) (o in float32) w.r.t. q, k and v through `fn`,
    as the JAX package's kernel test takes them."""
    import torch
    qkv = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    loss = (fn(*qkv, scale).float() ** 2).sum()
    return torch.autograd.grad(loss, qkv)


def check_flash_grad(dev):
    """The gradient through the flash kernel's autograd (forward: the
    kernel; backward: the recompute of `reference_bf16`) at the null-text
    backward's shapes. With one random cotangent the backward must be
    `reference_bf16`'s own VJP bit for bit, and launch nothing. The gradient
    of sum(o^2) against `reference_bf16`'s own gradient of it: dq within
    atol 4e-3, the JAX package's check of its kernel's VJP
    (tests/test_flash_attention.py differentiates w.r.t. q); dk and dv
    within 1e-2. The two forwards differ (f32 logits in the kernel, bf16 in
    `reference_bf16`), so the cotangents 2o differ too; dk and dv sum that
    difference over every query (measured 6e-3 on the CPU at 1024 keys, 2e-3
    at 4096). Returns the max |err| per shape."""
    import torch
    from comfystereo_tpu_torch.kernels import flash_attention as fa
    errs = []
    for bh, nq, nk, d in FLASH_GRAD_SHAPES:
        q, k, v = flash_inputs(dev, bh, nq, nk, d, seed=2)
        scale = d ** -0.5
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        g = torch.randn((bh, nq, d), device=dev).to(torch.bfloat16)
        before = fa.LAUNCHES
        out = fa.flash_attention(*qkv, scale)
        vjp = torch.autograd.grad(out, qkv, g)
        got = flash_grads(fa.flash_attention, q, k, v, scale)
        sync()
        if fa.LAUNCHES != before + 2:
            raise AssertionError(f"two flash fwd+bwd launched {fa.LAUNCHES - before} kernels, "
                                 "expected 2 (the forwards)")
        vjp_ref = torch.autograd.grad(fa.reference_bf16(*qkv, scale), qkv, g)
        if not all(torch.equal(a, b) for a, b in zip(vjp, vjp_ref)):
            raise AssertionError(f"flash backward at {(bh, nq, nk, d)} is not reference_bf16's "
                                 "VJP")
        want = flash_grads(fa.reference_bf16, q, k, v, scale)
        dq, dk, dv = (float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
        mags = [float(w.float().abs().max()) for w in want]
        if not all(bool(torch.isfinite(a).all()) for a in got) or dq > 4e-3 or \
                max(dk, dv) > 1e-2:
            raise AssertionError(f"flash gradient vs reference_bf16's at {(bh, nq, nk, d)}: "
                                 f"max |err| dq {dq} (bound 4e-3), dk {dk}, dv {dv} (1e-2)")
        errs.append(max(dq, dk, dv))
        log(f"  flash gradient {(bh, nq, nk, d)}: backward == reference_bf16's VJP bit for "
            f"bit, no launch in it; d(sum o^2) against reference_bf16's max |err| dq {dq:.3g}, "
            f"dk {dk:.3g}, dv {dv:.3g} (max |dq|, |dk|, |dv| "
            f"{', '.join(f'{m:.3g}' for m in mags)})")
        del q, k, v, qkv, out, vjp, vjp_ref, got, want
        torch.cuda.empty_cache()
    return errs


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
    """The exact polylines kernel against its plain version, uint8
    bit-equal: both entries (the fused one, which forms x and |coord|
    itself, against the same plain result on the x it forms), with the
    columns whose candidate list overflowed counted by the kernel and held
    to `candidate_lists`' count; and with lists of capacity 2, which
    overflow on most columns."""
    import torch
    from comfystereo_tpu_torch.kernels import _common, polylines_exact as pk
    count, over = 0, {}
    for kind, d in depths.items():
        for sharp in (True, False):
            for sep in SEP_PCTS:
                for sign in (1.0, -1.0):
                    div_pct, sep_pct = sign * DIV_PCT, sign * sep + 0.0
                    x, coord, colors, max_disp = polylines_inputs(image255, d, div_pct,
                                                                  sep_pct)
                    sep_px = sep_pct / 100.0 * x.shape[-1]
                    if not torch.equal(_common.point_x(coord, sep_px), x):
                        raise AssertionError("point_x differs from the route's x")
                    cl = coord.abs()
                    lengths = pk.candidate_lists(x, sharp, max_disp)[0]
                    want = pk.polylines_exact_rows_plain(x, cl, colors, sharp, 12, max_disp)
                    sync()
                    caps = (pk.LIST_CAP, 2) if sep == 0.0 and sign > 0 else (pk.LIST_CAP,)
                    runs = [("rows", cap) for cap in caps] + [("fused", pk.LIST_CAP)]
                    for entry, cap in runs:
                        ov = torch.zeros(1, dtype=torch.int32, device=dev)
                        kw = dict(sharp=sharp, max_pieces=12, max_disp=max_disp,
                                  list_cap=cap, overflow=ov)
                        got = (pk.polylines_exact_rows(x, cl, colors, **kw) if entry == "rows"
                               else pk.polylines_exact_rows_fused(coord, colors, sep_px, **kw))
                        sync()
                        if not torch.equal(got, want):
                            bad = float((got != want).float().mean())
                            raise AssertionError(
                                f"polylines kernel ({entry}, list_cap {cap}) differs from "
                                f"plain ({kind}, sharp {sharp}, div {div_pct}%, sep "
                                f"{sep_pct}%): {bad:.6f}")
                        expect = int((lengths > cap).sum())
                        if int(ov) != expect:
                            raise AssertionError(f"polylines kernel overflowed {int(ov)} "
                                                 f"columns at list_cap {cap}, expected {expect}")
                        over[(kind, sharp, cap)] = over.get((kind, sharp, cap), 0) + expect
                        count += 1
                    del got, want, lengths
        log(f"  polylines {kind}: uint8 bit-equal to plain on {tuple(x.shape)} rows, "
            "sharp and soft, div +-4.5%, sep 0 and 1%, both entries; columns over the "
            "list capacity: " + ", ".join(
                f"{'sharp' if sh else 'soft'} cap {cap} {v}"
                for (k, sh, cap), v in over.items() if k == kind))
    torch.cuda.empty_cache()
    return count


def check_polylines_ss(image255, depths) -> int:
    """The supersampled polylines kernel against its plain version: colour
    sums bit-equal (S = 8, K = 4); and the fused entry, which forms x and
    finishes the colour itself, against the plain composition on the same
    x, bit-equal."""
    import torch
    from comfystereo_tpu_torch.kernels import _common, polylines as pk
    count = 0
    for kind, d in depths.items():
        for sharp in (True, False):
            for div, sep in ((DIV_PCT, 0.0), (-DIV_PCT, 1.0)):
                x, coord, colors, max_disp = polylines_inputs(image255, d, div, sep)
                sep_px = sep / 100.0 * x.shape[-1]
                if not torch.equal(_common.point_x(coord, sep_px), x):
                    raise AssertionError("point_x differs from the route's x")
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
                fused = pk.polylines_scanline_fused(coord, colors, sep_px, **kw)
                sync()
                if not torch.equal(fused, torch.trunc(torch.clamp(want / 8 + 0.5, 0.0, 255.0))):
                    raise AssertionError(f"supersampled polylines fused entry differs from "
                                         f"plain ({kind}, sharp {sharp}, div {div}%, sep {sep}%)")
                count += 2
                del got, want, fused
        log(f"  supersampled polylines {kind}: sums bit-equal to plain on "
            f"{tuple(x.shape)} rows, sharp and soft, div +4.5% sep 0 and -4.5% sep 1%; "
            "fused entry bit-equal to the plain composition")
    torch.cuda.empty_cache()
    return count


def reset_launches() -> None:
    from comfystereo_tpu_torch import kernels
    kernels.reset_launch_counts()


def read_launches():
    from comfystereo_tpu_torch import kernels
    return kernels.launch_counts()


# Kernels redesigned after their port, and in which PR.
REDESIGNED = {"warp_kernel": "PR 7", "distance": "PR 7", "gather": "PR 5",
              "polylines_exact": "PR 6", "polylines": "PR 6", "flash_attention": "PR 5"}


def ptxas_usage(name: str) -> str:
    """Registers, spill stores and static shared memory of each entry
    function, from `-Xptxas -v` in the kernel's build log, instances by
    their template arguments (the flash kernel's Q.K^T k-steps; the
    polylines kernels' <sharp, fused>)."""
    import re
    from comfystereo_tpu_torch.kernels import _build
    parts, fn, spill = [], "kernel", "?"
    for ln in _build.build_log(name).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            args = re.findall(r"L[bi](\d+)E", m.group(1))
            colour = ("bf16," if "nv_bfloat16" in m.group(1) else
                      "f32," if re.search(r"kernelIfL", m.group(1)) else "")
            fn = f"<{colour}{','.join(args)}>" if args else "kernel"
            spill = "?"
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            smem = re.search(r"(\d+) bytes smem", ln)
            parts.append(f"{fn} {m.group(1)} registers, {spill} B spilled, "
                         f"{smem.group(1) if smem else 0} B static shared")
    return "; ".join(parts) if parts else "no build log (library found built)"


def flash_smem(dp: int) -> int:
    """Dynamic shared memory of a flash CTA (csrc/flash_attention.cu,
    Config::kSmem): Q and 4 (DP 64) or 2 (DP 128) stages of K and V, 16 KB
    per 64 columns of a 128-row tile, and 1 KB of alignment slack."""
    nb = dp // 64
    return 16384 * nb * (1 + 2 * (4 if nb == 1 else 2)) + 1024


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


# The exact kernel's max_pieces across both breakpoint-slot templates (12,
# 16) and the supersampled kernel's k_candidates, checked and timed at the
# main path's shapes; the colour count over 3; and a row width over the
# shared memory of the warp, the gather and both polylines kernels, and one
# over the distance kernel's.
EXACT_KS = (1, 4, 8, 12, 16)
SS_KS = (1, 2, 4, 8)
WIDE = 16384
WIDE_DISTANCE = 327680


def _expect_launches(mod, before: int, want: int, what: str) -> None:
    if mod.LAUNCHES != before + want:
        raise AssertionError(f"{what}: {mod.LAUNCHES - before} launches, expected {want}")


def _expect_raise(fn, mods, what: str) -> None:
    """A count past a kernel's range raises a ValueError before any launch."""
    before = [m.LAUNCHES for m in mods]
    try:
        fn()
    except ValueError:
        pass
    else:
        raise AssertionError(f"{what}: did not raise")
    if [m.LAUNCHES for m in mods] != before:
        raise AssertionError(f"{what}: launched before raising")


def phase_input_contracts(dev, smi: str, n: int = FRAMES, h: int = HEIGHT, w: int = WIDTH):
    """The kernels take what the TPU kernels take: the exact polylines
    kernel at max_pieces EXACT_KS and the supersampled one at k_candidates
    SS_KS, sharp and soft, through the fused entries on the main path's
    1080p B=12 rows, each bit-equal to its plain version with one launch
    counted per call, and timed; C = 4 through the warp and both polylines
    routes on the same frames, WIDE-column frames through the warp, the
    gather and both polylines kernels (their workspace or direct instances)
    and WIDE_DISTANCE-column rows through the distance kernel, each with one
    launch and the plain version's result, both timed; and max_pieces 17
    and k_candidates 9 raising before any launch."""
    import torch
    from comfystereo_tpu_torch.kernels import distance, gather
    from comfystereo_tpu_torch.kernels import polylines as ss, polylines_exact as ex
    from comfystereo_tpu_torch.kernels import warp_kernel as wk
    from comfystereo_tpu_torch.ops import depth as depth_ops
    from comfystereo_tpu_torch.ops import polylines as poly_ops
    from comfystereo_tpu_torch.ops import polylines_exact as exact_ops
    from comfystereo_tpu_torch.ops import warp as warp_ops

    imgs, deps = fixture_frames(n, h, w)
    image255 = torch.from_numpy(imgs).to(dev).float()
    depth255 = torch.from_numpy(deps).to(dev).float()
    x, coord, colors, md = polylines_inputs(image255, depth255, DIV_PCT, 0.0)
    out = {"exact_ms_by_max_pieces": {}, "supersampled_ms_by_k_candidates": {},
           "other_inputs_ms": {}}
    for sharp, mode in ((True, "sharp"), (False, "soft")):
        for k in EXACT_KS:
            kw = dict(sharp=sharp, max_pieces=k, max_disp=md)
            before = ex.LAUNCHES
            got = ex.polylines_exact_rows_fused(coord, colors, 0.0, **kw)
            sync()
            _expect_launches(ex, before, 1, f"exact max_pieces {k}")
            if not torch.equal(got, ex.polylines_exact_rows_fused_plain(coord, colors, 0.0,
                                                                        sharp, k, md)):
                raise AssertionError(f"exact kernel at max_pieces {k} ({mode}) differs "
                                     "from its plain version")
            out["exact_ms_by_max_pieces"][f"{mode} {k}"] = time_ms(
                lambda: ex.polylines_exact_rows_fused(coord, colors, 0.0, **kw))
        for k in SS_KS:
            kw = dict(sharp=sharp, samples=8, k_candidates=k, max_disp=md)
            before = ss.LAUNCHES
            got = ss.polylines_scanline_fused(coord, colors, 0.0, **kw)
            sync()
            _expect_launches(ss, before, 1, f"supersampled k_candidates {k}")
            if not torch.equal(got, ss.polylines_scanline_fused_plain(coord, colors, 0.0, **kw)):
                raise AssertionError(f"supersampled kernel at k_candidates {k} ({mode}) "
                                     "differs from its plain version")
            out["supersampled_ms_by_k_candidates"][f"{mode} {k}"] = time_ms(
                lambda: ss.polylines_scanline_fused(coord, colors, 0.0, **kw))
        del got
    log(f"  exact polylines kernel at max_pieces {EXACT_KS} and supersampled at k_candidates "
        f"{SS_KS}, sharp and soft, on [{n * h}, {w}] rows: bit-equal to plain, one launch "
        "each; ms per launch: " + json.dumps(out) + f" [{smi}]")

    mods = (wk, ex, ss, gather, distance)

    def taken(label, mod, kernel, plain, same):
        """One launch of `mod`'s kernel for `kernel()`, none of the others,
        and `same(got, plain())`; both timed."""
        before = [m.LAUNCHES for m in mods]
        got = kernel()
        sync()
        want = [b + (m is mod) for m, b in zip(mods, before)]
        if [m.LAUNCHES for m in mods] != want:
            raise AssertionError(f"{label}: launches {[m.LAUNCHES for m in mods]}, "
                                 f"expected {want}")
        if not same(got, plain()):
            raise AssertionError(f"{label}: the kernel differs from the plain version")
        out["other_inputs_ms"][label] = {"ms": time_ms(kernel, iters=3, warmup=1),
                                         "plain_ms": time_ms(plain, iters=1, warmup=0)}
        del got

    def warp_same(got, want):
        # gap masks bit-equal, colours within phase 2's 1e-5 (fixture) or on
        # all but 0.1% of the pixels (noise)
        err = (got[0].float() - want[0].float()).abs().amax(-1)
        return torch.equal(got[1], want[1]) and float((err > 1e-5).float().mean()) < 0.001

    def equal(got, want):
        return torch.equal(got, want)

    div_px = DIV_PCT / 100.0 * w
    nd = depth_ops.normalize_depth(depth255) - 0.5
    rgba = torch.cat([image255, image255[..., :1]], -1)
    u8_4 = torch.trunc(rgba)
    c4 = u8_4.reshape(n * h, w, 4).contiguous()
    wkw = (rgba / 255.0, depth255, div_px, 0.0, 2.0)
    taken(f"warp C=4 [{n},{h},{w}]", wk, lambda: warp_ops.forward_warp(*wkw),
          lambda: warp_ops.forward_warp(*wkw, impl="twin"), warp_same)
    ekw = (u8_4, nd, div_px, 0.0, 2.0)
    taken(f"polylines_exact C=4 [{n},{h},{w}]", ex,
          lambda: exact_ops.apply_polylines_exact(*ekw),
          lambda: exact_ops.apply_polylines_exact(*ekw, impl="twin"), equal)
    skw = dict(sharp=True, samples=8, k_candidates=4, max_disp=md)
    taken(f"polylines C=4 [{n},{h},{w}]", ss, lambda: poly_ops.apply_polylines(*ekw),
          lambda: ss.polylines_scanline_fused_plain(coord, c4, 0.0, **skw).reshape(u8_4.shape),
          equal)
    u8 = torch.trunc(image255)
    _expect_raise(lambda: exact_ops.apply_polylines_exact(u8, nd, div_px, 0.0, 2.0,
                                                          max_pieces=17),
                  mods, "polylines_exact max_pieces=17")
    _expect_raise(lambda: poly_ops.apply_polylines(u8, nd, div_px, 0.0, 2.0, k_candidates=9),
                  mods, "polylines k_candidates=9")
    del x, coord, colors, nd, rgba, u8_4, c4, u8, image255, depth255
    torch.cuda.empty_cache()

    from comfystereo_tpu_torch.utils import fixtures
    wide_img = torch.from_numpy(fixtures.create_test_image(h, WIDE)).to(dev).float()[None]
    wide_dep = torch.from_numpy(fixtures.create_depth_map(h, WIDE)).to(dev).float()[None]
    wdiv = DIV_PCT / 100.0 * WIDE
    wkw = (wide_img / 255.0, wide_dep, wdiv, 0.0, 2.0)
    taken(f"warp W={WIDE} [1,{h},{WIDE}]", wk, lambda: warp_ops.forward_warp(*wkw),
          lambda: warp_ops.forward_warp(*wkw, impl="twin"), warp_same)
    planes = wide_img.movedim(-1, 1).contiguous()
    gen = torch.Generator(device=dev).manual_seed(3)
    cols = torch.arange(WIDE, device=dev, dtype=torch.int32)
    disp = int(wdiv) + 2
    idx = (cols + torch.randint(-disp, disp + 1, (1, 1, h, WIDE), device=dev, generator=gen,
                                dtype=torch.int32)).clamp(0, WIDE - 1)
    taken(f"gather W={WIDE} [1,3,{h},{WIDE}]", gather,
          lambda: gather.bounded_take_along_w(planes, idx, disp),
          lambda: gather.bounded_take_along_w_plain(planes, idx), equal)
    _, wcoord, wcolors, wmd = polylines_inputs(wide_img, wide_dep, DIV_PCT, 0.0)
    ekw = dict(sharp=True, max_pieces=12, max_disp=wmd)
    taken(f"polylines_exact W={WIDE} [1,{h},{WIDE}]", ex,
          lambda: ex.polylines_exact_rows_fused(wcoord, wcolors, 0.0, **ekw),
          lambda: ex.polylines_exact_rows_fused_plain(wcoord, wcolors, 0.0, True, 12, wmd),
          equal)
    skw = dict(sharp=True, samples=8, k_candidates=4, max_disp=wmd)
    taken(f"polylines W={WIDE} [1,{h},{WIDE}]", ss,
          lambda: ss.polylines_scanline_fused(wcoord, wcolors, 0.0, **skw),
          lambda: ss.polylines_scanline_fused_plain(wcoord, wcolors, 0.0, **skw), equal)
    del wide_img, wide_dep, planes, idx, wcoord, wcolors
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(4)
    drows = torch.rand((3, WIDE_DISTANCE), device=dev, generator=gen) * 255.0
    dkw = dict(edge_threshold=20.0, mask_radius=20, falloff=2.0, height=3)

    def pair_equal(got, want):
        return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    taken(f"distance W={WIDE_DISTANCE} [3,{WIDE_DISTANCE}]", distance,
          lambda: distance.edge_weights_fused(drows, **dkw),
          lambda: distance.edge_weights_plain(drows, **dkw), pair_equal)
    del drows
    log("  other inputs (one launch each, the plain version's result; max_pieces 17 and "
        "k_candidates 9 raised before any launch), ms per call: "
        + json.dumps(out["other_inputs_ms"]) + f" [{smi}]")
    log("phase 2b ok: the polylines kernels take max_pieces 1-16 and k_candidates 1-8; "
        "the kernels take C = 4 and rows over their shared memory")
    return out


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
            "polylines_exact_rows": 0, "polylines_scanline": 0, "flash_attention": 0,
            "box_blend": 1}
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
    if out.dtype != torch.uint8 or tuple(out.shape) != (n, h, 2 * w, 3):
        raise AssertionError(f"device_chunk gave {out.dtype} {tuple(out.shape)}")
    if out.device.type != "cpu" or not out.is_pinned():
        raise AssertionError(f"device_chunk's result on {out.device}, pinned "
                             f"{out.is_pinned()}: not page-locked on the host")
    node_u8 = torch.trunc(stereo * 255.0).flip(-1)
    within = float(((out.float() - node_u8).abs() <= 1).float().mean())
    if within < 0.999:
        raise AssertionError(f"device_chunk vs node: only {within:.5f} within 1 LSB")
    log(f"  device_chunk uint8 BGR {tuple(out.shape)}, on the host, pinned "
        f"{out.is_pinned()}, {within:.6f} of values within 1 LSB of the node")

    reset_launches()
    t0 = time.perf_counter()
    stereo, left_d, right_d, mask = StereoImageNode().generate(
        image, depth, batch_size=n, fill_technique="Fill - Polylines Sharp",
        device=dev)
    sec = time.perf_counter() - t0
    poly_launches = read_launches()
    want = {"warp_rows": 0, "edge_distances": 1, "bounded_take_along_w": 0,
            "polylines_exact_rows": 2, "polylines_scanline": 0, "flash_attention": 0,
            "box_blend": 1}
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
        if (got["edge_distances"] != 1 or got["box_blend"] != 1 or got["warp_rows"] != 0
                or got["flash_attention"] or got["polylines_scanline"]
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
    from comfystereo_tpu_torch.utils.video import _groups, device_chunk
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
                or got["edge_distances"] != 1 or got["box_blend"] != 1 or got["warp_rows"] != 0
                or got["flash_attention"]
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
    groups = len(_groups(n, bgr.nbytes))  # device_chunk's groups of frames
    if got["polylines_scanline"] != 2 * groups or got["polylines_exact_rows"] != 0:
        raise AssertionError(f"device_chunk polylines_sharp (supersampled) launches {got}")
    if chunk.dtype != torch.uint8 or tuple(chunk.shape) != (n, h, 2 * w, 3):
        raise AssertionError(f"device_chunk gave {chunk.dtype} {tuple(chunk.shape)}")
    log(f"  device_chunk polylines_sharp polylines_exact=False: uint8 BGR "
        f"{tuple(chunk.shape)}, launches {got}")
    return out


def check_division(dev) -> None:
    """Why the port divides by scalars with device.true_divide: on the card
    PyTorch divides a float32 tensor by a Python scalar (or a 0-dim CPU
    tensor) as a product with the scalar's rounded reciprocal, while the CPU
    divides truly; a 0-dim tensor on the card divides truly. Prints the
    share of 2^24 uniform values in [0, 500) that differ from the CPU's x / d
    each way, and fails unless the 0-dim card tensor (what true_divide uses)
    gives the CPU's bits. Also the shares for torch.pow at a few exponents,
    which only ATen's special cases (2, 3, -1, ...) keep equal."""
    import torch
    from comfystereo_tpu_torch.device import true_divide
    x = torch.rand(1 << 24, generator=torch.Generator().manual_seed(0)) * 500.0
    xd = x.to(dev)
    for d in (13.0, 255.0, 20.0):
        cpu = x / d
        shares = {"python scalar": (xd / d).cpu(),
                  "0-dim CPU tensor": (xd / torch.tensor(d)).cpu(),
                  "0-dim card tensor (true_divide)": true_divide(xd, d).cpu()}
        shares = {k: float((v != cpu).float().mean()) for k, v in shares.items()}
        if shares["0-dim card tensor (true_divide)"] != 0.0:
            raise AssertionError(f"true_divide by {d} differs from the CPU on the card")
        log(f"  x / {d:g}, card vs CPU, share of values differing: " + ", ".join(
            f"{k} {v:.6f}" for k, v in shares.items()))
    y = x / 500.0
    log("  torch.pow(x, e), card vs CPU, share of values differing: " + ", ".join(
        f"e={e:g} {float(((y.to(dev) ** e).cpu() != y ** e).float().mean()):.6f}"
        for e in (2.0, 3.0, 1.0, 0.5, 1.7)))


def phase_card_vs_cpu(dev, n: int = 2, h: int = 270, w: int = 480):
    """stereo_pipeline on the card and on the CPU, to the slice's tolerances."""
    import torch
    from comfystereo_tpu_torch import StereoConfig, stereo_pipeline

    check_division(dev)
    imgs, deps = fixture_frames(n, h, w)
    image = torch.from_numpy(imgs).float() / 255.0
    depth = torch.from_numpy(deps).float() / 255.0
    modes = ("left-right", "top-bottom", "red-cyan-anaglyph")
    for blur in (False, True):
        # Blur on or off, the same rules: every division by a scalar divides
        # truly on the card as on the CPU (device.true_divide), and the
        # fused kernels divide in IEEE arithmetic, so the blurred depth is
        # bit-equal and so are the offsets the warp forms from it.
        cfg = StereoConfig(modes=modes, depth_map_blur=blur)
        gpu = stereo_pipeline(image.to(dev), depth.to(dev), cfg)
        cpu = stereo_pipeline(image, depth, cfg)
        if not torch.equal(gpu["mask"].cpu(), cpu["mask"]):
            raise AssertionError(f"mask card vs CPU differs (blur {blur})")
        for k in ("left_depth", "right_depth"):
            if not torch.equal(gpu[k].cpu(), cpu[k]):
                raise AssertionError(f"{k} card vs CPU differs (blur {blur}): max |err| "
                                     f"{float((gpu[k].cpu() - cpu[k]).abs().max())}")
        err = max(float((g.cpu() - c).abs().max()) for g, c in zip(gpu["stereo"], cpu["stereo"]))
        if err > 1e-5:
            raise AssertionError(f"colours card vs CPU {err} > 1e-5 (blur {blur})")
        log(f"  card vs CPU gpu_warp blur={blur}: mask and depth outputs bit-equal, colours "
            f"max |err| {err:.3g}")
    for fill in FILLS:
        for blur in (False, True):
            cfg = StereoConfig(modes=modes, depth_map_blur=blur, fill_technique=fill)
            gpu = stereo_pipeline(image.to(dev), depth.to(dev), cfg)
            cpu = stereo_pipeline(image, depth, cfg)
            mask_off = float((gpu["mask"].cpu() != cpu["mask"]).float().mean())
            off, worst = fill_diff(gpu["stereo"], cpu["stereo"])
            # Bit-equal in uint8, blur on or off, except the hybrid fills:
            # their float32 prefix sums round differently on the card
            # (torch.cumsum's parallel scan) than on the CPU, and differences
            # of prefix sums cancel, so they are held to 1 LSB on at most
            # HYBRID_SHARE of the values (measured on the H100: 28.9% blur
            # off, 28.6% on).
            if fill.startswith("hybrid"):
                ok = worst <= 1 and off <= HYBRID_SHARE and mask_off <= 0.001
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


def eager_unet(model, lat, t, ctx):
    """One UNet call of a `build_sd_model` bundle run eagerly
    (`GraphedUNet.eager`), for checks that swap the attention route or
    record its calls: a graph's replay makes no Python call."""
    from comfystereo_tpu_torch.diffusion.attention import AttentionMode
    return model.unet_apply.eager(lat, t, ctx, AttentionMode(), False)


def graph_counts():
    from comfystereo_tpu_torch.diffusion import sd_unet
    return sd_unet.UNET_GRAPH_CAPTURES, sd_unet.UNET_GRAPH_CALLS


def host_flash(calls: int, before) -> int:
    """The flash launches the host makes for `calls` plain (not stereo)
    UNet calls of SD 1.5 at 512x512, given the graph counters' values
    `before` them: an eager call makes its 10, a capture makes them once
    for each warm-up and once into the graph, a replay makes none
    (`LAUNCHES` counts host launches)."""
    from comfystereo_tpu_torch.diffusion import sd_unet
    caps, graphed = (a - b for a, b in zip(graph_counts(), before))
    return SD_FLASH_PER_CALL * (calls - graphed + (sd_unet.GRAPH_WARMUPS + 1) * caps)


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


def check_sd_outputs(label: str, pair, left, right, s: int) -> None:
    import torch
    if (tuple(pair.shape), tuple(left.shape), tuple(right.shape)) != (
            (1, s, 2 * s, 3), (1, s, s, 3), (1, s, s, 3)):
        raise AssertionError(f"{label}: node output shapes {tuple(pair.shape)}, "
                             f"{tuple(right.shape)}")
    for t in (pair, left, right):
        if not bool(torch.isfinite(t).all()) or float(t.min()) < 0 or float(t.max()) > 1:
            raise AssertionError(f"{label}: node outputs not finite or outside [0, 1]")


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
    graphs0 = graph_counts()
    t0 = time.perf_counter()
    with nan_guard_spy(seen):
        pair, left, right = StereoDiffusionNode().generate_stereo(img, dep, model=model,
                                                                  device=dev)
    node_s = time.perf_counter() - t0
    launches = read_launches()
    want = {k: 0 for k in launches}
    want["flash_attention"] = host_flash(SD_UNET_CALLS, graphs0)
    graphs = [a - b for a, b in zip(graph_counts(), graphs0)]
    want_graphs = [1, SD_UNET_CALLS] if dev.type == "cuda" else [0, 0]  # none on the CPU
    if launches != want or graphs != want_graphs:
        raise AssertionError(f"StereoDiffusion Fast launches {launches}, expected {want}; "
                             f"graphs captured and replayed {graphs}, expected {want_graphs}")
    s = SD_SIZE
    check_sd_outputs("StereoDiffusion Fast", pair, left, right, s)
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
        f"call), host launches {launches}, {graphs[1]} UNet calls served by "
        f"{graphs[0]} captured CUDA graph; mask share {float(mask.float().mean()):.4f}, "
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
        eps_k = eager_unet(model, lat, t_first, ctx)
    with attention_as(fa.reference):
        eps_p = eager_unet(model, lat, t_first, ctx)
        # Through graphs captured with the plain version (the graph key
        # holds the attention route).
        plain_out = sd_pipeline.warp_inpaint(
            model, img_d, dep_d, "", divergence=5.0, num_inference_steps=20, strength=0.6,
            guidance_scale=3.0, seed=np.array([SD_SEED], np.uint64))
    with attention_as(exact_attention):
        eps_x = eager_unet(model, lat, t_first, ctx)
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


# --- StereoDiffusion Standard path --------------------------------------------

class UNetCalls:
    """Counts a bundle's UNet calls while it is in use: all forwards, the
    forwards whose context needs a gradient (null-text inner iterations),
    the stereo-active CFG calls of the denoising loop, the calls a CUDA
    graph's replay served, and `host_passes`, the forwards whose flash
    launches the host made, a stereo-active CFG call's counting twice (its
    self-attentions run as two pairs): one for an eager call, the warm-ups
    and the capture for a call that captured, none for a replay alone; with
    `timed`, the CUDA-event time of each denoising call, plain and
    stereo-active apart."""

    def __init__(self, model, timed: bool = False):
        self.model, self.apply, self.timed = model, model.unet_apply, timed
        self.forward = self.grad = self.stereo = self.plain_cfg = 0
        self.graphed = self.host_passes = 0
        self.events = {"plain": [], "stereo": []}

    def __enter__(self):
        import torch

        def counted(latents, t, context, mode=None, stereo_active=False):
            self.forward += 1
            self.grad += bool(context.requires_grad)
            kind = None
            if mode is not None and mode.stereo:
                kind = "stereo" if stereo_active else "plain"
                self.stereo += kind == "stereo"
                self.plain_cfg += kind == "plain"
            from comfystereo_tpu_torch.diffusion import sd_unet
            before = graph_counts()
            ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  if self.timed and kind else None)
            if ev:
                ev[0].record()
            out = self.apply(latents, t, context, mode=mode, stereo_active=stereo_active)
            if ev:
                ev[1].record()
                self.events[kind].append(ev)
            caps, graphed = (a - b for a, b in zip(graph_counts(), before))
            self.graphed += graphed
            passes = (sd_unet.GRAPH_WARMUPS + 1) * caps if graphed else 1
            self.host_passes += passes * (2 if kind == "stereo" else 1)
            return out

        self.model.unet_apply = counted
        return self

    def __exit__(self, *exc):
        self.model.unet_apply = self.apply

    def ms(self, kind: str):
        """(calls, total ms) of the timed denoising calls of one kind."""
        sync()
        evs = self.events[kind]
        return len(evs), sum(a.elapsed_time(b) for a, b in evs)


def std_expected_calls(steps: int, null_text: bool, inner: int):
    """(UNet forwards, stereo-active CFG calls) of one Standard frame: the
    inversion loop (steps), per timestep with null-text the conditional eps,
    the inner iterations and the advance (2 per step + inner), the denoising
    loop (steps), of which those from 20% of the steps on are stereo."""
    start = max(int(steps * 0.2), 1)
    return steps + (2 * steps + inner if null_text else 0) + steps, steps - start


def phase_standard(dev):
    """The StereoDiffusion node in Standard (DDIM) mode with its defaults on
    one 512x512 fixture frame, on the full-width SD 1.5 UNet + SD VAE in bf16
    with seeded random weights; then a short second call ('bi', deblur on, 5
    steps, no null-text). Flash launches must be 10 per UNet forward plus 10
    per stereo-active CFG call (its self-attentions run as two pairs); the
    backward launches none; `LAUNCHES` counts host launches, so a call
    served by a CUDA graph's replay adds none (`UNetCalls.host_passes`).
    Then one null-text gradient of u at full width
    through the kernel against the same gradient with the attention forced
    to its plain version."""
    import torch
    from comfystereo_tpu_torch.diffusion import SD15_UNET_CONFIG, SD_VAE_CONFIG, build_sd_model
    from comfystereo_tpu_torch.nodes.stereodiffusion import StereoDiffusionNode

    t0 = time.perf_counter()
    model = build_sd_model(SD15_UNET_CONFIG, SD_VAE_CONFIG, dtype=torch.bfloat16, seed=0,
                           device=dev)
    sync()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for m in (model.unet, model.vae) for p in m.parameters())
    img, dep = sd_fixture(SD_SIZE)
    s = SD_SIZE
    runs = {}
    for label, kw in (("defaults", STD_DEFAULTS), ("short", STD_SHORT)):
        seen = []
        reset_launches()
        t0 = time.perf_counter()
        with nan_guard_spy(seen), UNetCalls(model) as calls:
            pair, left, right = StereoDiffusionNode().generate_stereo(img, dep, model=model,
                                                                      device=dev, **kw)
        sec = time.perf_counter() - t0
        launches = read_launches()
        steps, nt = kw["num_inference_steps"], kw["null_text_optimization"]
        fwd, stereo = std_expected_calls(steps, nt, calls.grad)
        if (calls.forward, calls.stereo) != (fwd, stereo) or (not nt and calls.grad) or \
                calls.grad > 10 * steps:
            raise AssertionError(f"Standard {label}: UNet calls {calls.forward} (stereo "
                                 f"{calls.stereo}, inner {calls.grad}), expected {fwd} "
                                 f"({stereo})")
        want = {k: 0 for k in launches}
        want["flash_attention"] = SD_FLASH_PER_CALL * calls.host_passes
        replayed = calls.forward - calls.grad if dev.type == "cuda" else 0
        if launches != want or calls.graphed != replayed:
            raise AssertionError(f"Standard {label} launches {launches}, expected {want}; "
                                 f"{calls.graphed} calls replayed, expected {replayed}")
        check_sd_outputs(f"Standard {label}", pair, left, right, s)
        if seen != [0]:
            raise AssertionError(f"the NaN guard scrubbed {seen} non-finite values")
        lr_diff = float((left - right).abs().mean())
        if lr_diff == 0.0:
            raise AssertionError("Standard node: the right eye equals the left")
        runs[label] = {"seconds": sec, "unet_forwards": calls.forward,
                       "stereo_cfg_calls": calls.stereo, "null_text_inner": calls.grad,
                       "graphed_calls": calls.graphed,
                       "flash_launches": launches["flash_attention"]}
        log(f"phase 3 StereoDiffusion Standard ({label}: {steps} steps, '{kw['direction']}', "
            f"deblur {kw['deblur']}, null-text {nt}): node on 1 frame {s}x{s} in {sec:.2f} s "
            f"(first call), {calls.forward} UNet forwards ({calls.grad} null-text inner "
            f"iterations with a backward), {calls.stereo} stereo-active CFG calls, "
            f"{calls.graphed} calls replayed; host launches {launches} = "
            f"{SD_FLASH_PER_CALL} x {calls.host_passes} passes; mean "
            f"|left - right| "
            f"{lr_diff:.4f}, mean |left - input| "
            f"{float((left - torch.from_numpy(img)).abs().mean()):.4f}")
    log(f"  Standard model: {n_params / 1e6:.1f}M parameters (bf16), built in {build_s:.1f} s")
    grad = check_null_text_grad(model)
    log("phase 3 ok: StereoDiffusion Standard node through the flash kernel, forward and "
        "backward")
    return {"model": model, "runs": runs, "grad": grad,
            "launches": sum(r["flash_launches"] for r in runs.values())}


def null_text_grad(model, lat, prev, t: int, sched, guidance: float = 3.0):
    """The null-text loss's gradient w.r.t. the unconditional embedding at
    one timestep, as `inversion.null_text_optimize_step` takes it."""
    import torch
    from comfystereo_tpu_torch.diffusion import schedulers
    cond = model.text_encode("")
    with torch.no_grad():  # eager, so the two forwards launch 2 x 10 whatever graphs exist
        eps_c = eager_unet(model, lat, t, cond)
    u = cond.detach().clone().requires_grad_(True)
    eps_u = model.unet_apply(lat, t, u)
    eps = eps_u + guidance * (eps_c - eps_u)
    loss = torch.mean((schedulers.ddim_step(sched, eps, t, lat) - prev) ** 2)
    return torch.autograd.grad(loss, u)[0]


def check_null_text_grad(model):
    """One null-text gradient of u at full width (64x64 latent, the first
    timestep of 20): through the flash kernel's autograd, against the same
    gradient with the attention forced to its plain version (`reference`,
    autograd through f32 logits), relative L2 at most 0.05; and against the
    gradient with the kernel's output cut from the graph (what a forward
    without autograd gave): the self-attentions must carry gradient."""
    import torch
    from comfystereo_tpu_torch.diffusion import schedulers
    from comfystereo_tpu_torch.kernels import flash_attention as fa
    dev = model.device
    sched = schedulers.make_ddim(20)
    t = int(sched.timesteps[0])
    gen = torch.Generator().manual_seed(1)
    ls = SD_SIZE // 2 ** (len(model.vae.cfg.block_out_channels) - 1)
    lat = torch.randn((1, model.latent_channels, ls, ls), generator=gen).to(dev)
    prev = lat + 0.05 * torch.randn(lat.shape, generator=gen).to(dev)
    before = fa.LAUNCHES
    g_k = null_text_grad(model, lat, prev, t, sched)
    sync()
    if fa.LAUNCHES != before + 2 * SD_FLASH_PER_CALL:
        raise AssertionError(f"null-text gradient launched {fa.LAUNCHES - before} flash "
                             f"kernels, expected {2 * SD_FLASH_PER_CALL} (two forwards)")
    kernel = fa.flash_attention
    with attention_as(fa.reference):
        g_p = null_text_grad(model, lat, prev, t, sched)
    with attention_as(lambda q, k, v, scale: kernel(q, k, v, scale).detach()):
        g_cut = null_text_grad(model, lat, prev, t, sched)
    sync()
    if not all(bool(torch.isfinite(g).all()) for g in (g_k, g_p, g_cut)):
        raise AssertionError("null-text gradient not finite")
    rel, rel_cut = rel_l2(g_k, g_p), rel_l2(g_cut, g_k)
    log(f"  null-text gradient of u {tuple(g_k.shape)} at t={t}, full width: relative L2 "
        f"kernel route vs plain route {rel:.4g} (bound 0.05); without the self-attentions' "
        f"gradient it would be {rel_cut:.4g} off; |g| rms "
        f"{float(g_k.float().pow(2).mean().sqrt()):.3g}")
    if rel > 0.05:
        raise AssertionError(f"null-text gradient kernel vs plain: relative L2 {rel} > 0.05")
    if rel_cut <= rel:
        raise AssertionError("the self-attentions carry no gradient")
    return {"rel_l2_kernel_vs_plain": rel, "rel_l2_without_self_attention": rel_cut}


# --- StereoDiffusion from a checkpoint ------------------------------------------

CKPT_ROOT = os.path.join(HERE, "build", "sd_checkpoints")
SD_PROMPT = "a wooden house on the shore of a quiet lake, mountains behind it"
TOY_BANNER = "FALLING BACK TO THE OFFLINE TOY MODEL"


def tests_module(name: str):
    """A module of tests/ loaded by path (it imports the port, never JAX)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "tests", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_checkpoints():
    """Two diffusers-layout directories under build/ with the port's
    safetensors writer (float16, seeded with `porting.random_init_`'s rule,
    tests/torch_checkpoint.py): SD 1.5-inpainting (9-channel UNet) and SD
    1.5 (4-channel UNet, its vae/, text_encoder/ and tokenizer/ hard links
    to the first's), each with the CLIP ViT-L/14 text tower and a vocab
    generated at CLIP's size."""
    import shutil
    from comfystereo_tpu_torch.diffusion import (SD15_INPAINT_UNET_CONFIG, SD15_TEXT_CONFIG,
                                                 SD15_UNET_CONFIG, SD_VAE_CONFIG)
    ckpt = tests_module("torch_checkpoint")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    vocab = ckpt.clip_vocab()
    inpaint, sd15 = (os.path.join(CKPT_ROOT, n) for n in ("sd15-inpainting", "sd15"))
    states, n1, s1 = ckpt.write_sd_dir(inpaint, SD15_INPAINT_UNET_CONFIG, SD_VAE_CONFIG,
                                       SD15_TEXT_CONFIG, vocab, seed=0)
    _, n2, s2 = ckpt.write_sd_dir(sd15, SD15_UNET_CONFIG, SD_VAE_CONFIG, SD15_TEXT_CONFIG,
                                  vocab, seed=0, share_from=inpaint)
    sec = time.perf_counter() - t0
    n_text = sum(v.numel() for v in states["text_encoder"].values())
    if n_text != 123_060_480 or len(vocab[0]) != 49408:
        raise AssertionError(f"text tower {n_text} parameters, vocab {len(vocab[0])} ids")
    log(f"phase 3 checkpoints: {inpaint} {n1 / 1e9:.3f} GB in {s1:.1f} s, {sd15} {n2 / 1e9:.3f} "
        f"GB in {s2:.1f} s (its vae/, text_encoder/ and tokenizer/ hard links), float16 "
        f"safetensors by the port's own writer, read back by its own parser; CLIP ViT-L/14 "
        f"text tower {n_text:,} parameters, vocab "
        f"{len(vocab[0])} ids; {sec:.1f} s in all")
    return {"inpaint": inpaint, "sd15": sd15, "unet_state": states["unet"],
            "vae_state": states["vae"], "write_s": sec, "bytes": n1 + n2}


def phase_checkpoint(dev, ck):
    """The StereoDiffusion node resolving its own model from the checkpoint
    directories, offline (COMFYSTEREO_OFFLINE=1):
    (a) Fast mode, node defaults, `inpaint_model_id` = the inpainting
        directory and a prompt: the bundle from `load_inpainting_model` in
        bf16 with the checkpoint's CLIP; flash host launches 20 (`host_flash`:
        13 calls replayed from one capture);
    (b) one UNet CFG call of that bundle bit-equal to `build_sd_model`'s on
        the same float16 weights;
    (e) w8: the same weights with `weight_quant=True`, one CFG call within
        0.05 (mean |delta eps| / mean |eps|), flash host launches 20 (its
        capture);
    (c) Standard mode, `model_id` = the SD 1.5 directory, 5 steps, no
        null-text: float32 from `load_sd_model`, flash 0;
    (d) an id on no disk: the loud banner, and the toy model on the card."""
    import io
    import torch
    from comfystereo_tpu_torch.diffusion import (SD15_INPAINT_UNET_CONFIG, SD_VAE_CONFIG,
                                                 NativeCLIPTextEncoder, build_sd_model,
                                                 porting, quantize, schedulers)
    from comfystereo_tpu_torch.nodes import stereodiffusion as node_mod
    from comfystereo_tpu_torch.utils import caching
    os.environ["COMFYSTEREO_OFFLINE"] = "1"
    caching.clear_model_cache()
    img, dep = sd_fixture(SD_SIZE)
    s, node = SD_SIZE, node_mod.StereoDiffusionNode()
    loads, load = [], porting.load_sd_from_diffusers_dir

    def timed_load(*args, **kw):
        t0 = time.perf_counter()
        out = load(*args, **kw)
        sync()
        loads.append(time.perf_counter() - t0)
        return out

    porting.load_sd_from_diffusers_dir = timed_load
    try:
        seen = []
        reset_launches()
        graphs0 = graph_counts()
        t0 = time.perf_counter()
        with nan_guard_spy(seen):
            pair, left, right = node.generate_stereo(img, dep, inpaint_model_id=ck["inpaint"],
                                                     prompt=SD_PROMPT, device=dev)
        fast_s = time.perf_counter() - t0
        fast_launches = read_launches()
        fast_want = host_flash(SD_UNET_CALLS, graphs0)
        fast = caching._model_cache.get(f"{ck['inpaint']}:inpaint:{dev}")
        reset_launches()
        t0 = time.perf_counter()
        with nan_guard_spy(seen):
            spair, sleft, sright = node.generate_stereo(
                img, dep, pipeline_mode="Standard (DDIM)", model_id=ck["sd15"],
                prompt=SD_PROMPT, num_inference_steps=5, null_text_optimization=False,
                device=dev)
        std_s = time.perf_counter() - t0
        std_launches = read_launches()
        std = caching._model_cache.get(f"{ck['sd15']}:ddim:{dev}")
    finally:
        porting.load_sd_from_diffusers_dir = load
    if fast is None or std is None or len(loads) != 2:
        raise AssertionError(f"the node did not load through model_loader ({len(loads)} loads)")
    want = {k: 0 for k in fast_launches}
    want["flash_attention"] = fast_want
    if fast_launches != want:
        raise AssertionError(f"loaded Fast launches {fast_launches}, expected {want}")
    if std_launches != {k: 0 for k in std_launches}:
        raise AssertionError(f"loaded Standard (float32) launches {std_launches}, expected none")
    if seen != [0, 0]:
        raise AssertionError(f"the NaN guard scrubbed {seen} non-finite values")
    for m, dt in ((fast, torch.bfloat16), (std, torch.float32)):
        te = m.text_encode
        if next(m.unet.parameters()).dtype != dt or not isinstance(te, NativeCLIPTextEncoder) \
                or next(te.model.parameters()).dtype != dt or SD_PROMPT not in te \
                or m.device != dev:
            raise AssertionError(f"loaded bundle: not {dt} on {dev} with the checkpoint's CLIP")
    if fast.unet_in_channels != 9 or std.unet_in_channels != 4:
        raise AssertionError("loaded UNets' input channels")
    check_sd_outputs("loaded Fast", pair, left, right, s)
    check_sd_outputs("loaded Standard", spair, sleft, sright, s)
    cond, unc = fast.text_encode(SD_PROMPT), fast.text_encode("")
    cond_diff = rel_l2(cond, unc)
    if not cond_diff > 0:
        raise AssertionError("the prompt's CLIP embedding equals the empty prompt's")
    log(f"phase 3 loaded Fast: node resolved inpaint_model_id (load_inpainting_model, bf16, "
        f"load {loads[0]:.1f} s) and ran 1 frame {s}x{s} in {fast_s:.2f} s (first call, "
        f"load included), launches {fast_launches}; CLIP conditioning {tuple(cond.shape)}, "
        f"relative L2 from the empty prompt's {cond_diff:.3f}")
    log(f"phase 3 loaded Standard: node resolved model_id (load_sd_model, ddim, float32, load "
        f"{loads[1]:.1f} s), 5 steps, no null-text, in {std_s:.2f} s, launches "
        f"{std_launches} (flash {std_launches['flash_attention']}, against the loaded Fast "
        f"{fast_launches['flash_attention']}: float32 never takes the kernel)")

    # (b) and (e): the loaded bundle's CFG call against build_sd_model's on
    # the same float16 weights, and the w8 model's.
    ref = build_sd_model(SD15_INPAINT_UNET_CONFIG, SD_VAE_CONFIG, dtype=torch.bfloat16,
                         device=dev, unet_state=ck["unet_state"], vae_state=ck["vae_state"])
    same = all(torch.equal(a, b) for a, b in zip(fast.unet.state_dict().values(),
                                                 ref.unet.state_dict().values()))
    gen = torch.Generator().manual_seed(5)
    ls = s // 2 ** (len(fast.vae.cfg.block_out_channels) - 1)
    lat = torch.randn((2, fast.unet_in_channels, ls, ls), generator=gen).to(dev)
    ctx = torch.cat([unc, cond])
    t_first = int(schedulers.pndm_skip_timesteps(schedulers.make_pndm(20), 0.6)[0])
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        eps_l = fast.unet_apply(lat, t_first, ctx)
        eps_r = ref.unet_apply(lat, t_first, ctx)
    sync()
    if not same or not torch.equal(eps_l, eps_r):
        raise AssertionError(f"loaded bundle vs build_sd_model: weights equal {same}, eps "
                             f"max |diff| {float((eps_l - eps_r).abs().max())}")
    w8 = build_sd_model(SD15_INPAINT_UNET_CONFIG, SD_VAE_CONFIG, dtype=torch.bfloat16,
                        device=dev, unet_state=ck["unet_state"], vae_state=ck["vae_state"],
                        weight_quant=True)
    n_w8 = sum(isinstance(m, quantize.W8Linear) for m in w8.unet.modules())
    reset_launches()
    graphs0 = graph_counts()
    eps_q = w8.unet_apply(lat, t_first, ctx)
    sync()
    w8_launches = read_launches()["flash_attention"]
    w8_want = host_flash(1, graphs0)
    w8_rel = float((eps_q - eps_r).abs().mean() / eps_r.abs().mean())
    if not bool(torch.isfinite(eps_q).all()) or w8_rel >= 0.05 or w8_launches != w8_want:
        raise AssertionError(f"w8 CFG call: mean |delta eps| / mean |eps| {w8_rel} (bound "
                             f"0.05), flash launches {w8_launches}")
    bytes_bf16, bytes_w8 = quantize.quantized_bytes(ref.unet), quantize.quantized_bytes(w8.unet)
    log(f"phase 3 loaded CFG call {tuple(lat.shape)} at t={t_first}: bit-equal to "
        f"build_sd_model's on the same float16 weights (weights equal); w8 ({n_w8} layers "
        f"quantised) mean |delta eps| / mean |eps| {w8_rel:.4f} (bound 0.05), flash "
        f"{w8_launches}; UNet stored {bytes_bf16 / 1e9:.3f} GB bf16, {bytes_w8 / 1e9:.3f} GB w8")

    # (d) An id on no disk: the loud toy fallback, on the card.
    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        tpair, tleft, tright = node.generate_stereo(img, dep, inpaint_model_id="org/not-on-disk",
                                                    device=dev)
    toy_launches = read_launches()
    out = buf.getvalue()
    log(out.rstrip())
    toy = node_mod._default_model(dev)
    if TOY_BANNER not in out or "org/not-on-disk" not in out or toy.device != dev or \
            next(toy.unet.parameters()).device.type != dev.type:
        raise AssertionError("the unresolvable id did not fall back loudly to the toy on the card")
    check_sd_outputs("toy fallback", tpair, tleft, tright, s)
    log(f"phase 3 toy fallback: banner and trail printed, toy model on {dev} "
        f"({toy.sample_size}x{toy.sample_size}), launches {toy_launches}")
    log("phase 3 ok: StereoDiffusion from checkpoint directories (Fast via inpaint_model_id, "
        "Standard via model_id, the loud toy fallback) and w8")
    launches = (fast_launches["flash_attention"] + std_launches["flash_attention"]
                + toy_launches["flash_attention"])
    return {**ck, "fast": fast, "std": std, "ref": ref, "w8": w8, "lat": lat, "ctx": ctx,
            "t": t_first, "load_s": loads, "fast_node_s": fast_s, "std_node_s": std_s,
            "launches": launches, "w8_rel": w8_rel, "w8_layers": n_w8,
            "unet_bytes": {"bf16": bytes_bf16, "w8": bytes_w8},
            "flash_launches": {"fast": fast_launches["flash_attention"],
                               "standard": std_launches["flash_attention"],
                               "toy": toy_launches["flash_attention"], "w8_call": w8_launches}}


def release_checkpoint_models(ck) -> None:
    """Free the checkpoint phases' models (the model cache, which holds the
    loaded bundles and the toy, included), so that the Standard frame's
    peak device memory counts the models it counted before these phases
    existed."""
    import torch
    from comfystereo_tpu_torch.utils import caching
    for key in ("fast", "std", "ref", "w8", "lat", "ctx", "unet_state", "vae_state"):
        ck.pop(key, None)
    caching.clear_model_cache()
    torch.cuda.empty_cache()


def phase_checkpoint_card_vs_cpu(dev):
    """A TINY diffusers directory (TINY UNet, VAE and text configs, the toy
    vocab, float16 files) loaded in float32 on the card and on the CPU: the
    text embeddings of three prompts, one UNet call, VAE encode and decode,
    and the w8 TINY model's eps (min_elems 1024, q bit-equal), each within
    1e-4 (TF32 off). The files are read by the port's own parser."""
    import torch
    from comfystereo_tpu_torch.diffusion import (TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG,
                                                 TINY_TEXT_CONFIG, build_sd_model, porting,
                                                 quantize)
    ckpt = tests_module("torch_checkpoint")
    d = os.path.join(CKPT_ROOT, "tiny")
    states, _, _ = ckpt.write_sd_dir(d, TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG,
                                     TINY_TEXT_CONFIG, ckpt.toy_vocab(), seed=2)
    gen = torch.Generator().manual_seed(0)
    lat, img = torch.randn(2, 4, 16, 16, generator=gen), torch.rand(1, 3, 32, 32, generator=gen)
    ctx = torch.randn(2, 77, TINY_SD_UNET_CONFIG.cross_attention_dim, generator=gen)
    names = ("text 'low'", "text 'lower lower'", "text ''", "UNet", "VAE encode", "VAE decode",
             "w8 UNet")
    outs, qs = [], []
    for dv in (dev, torch.device("cpu")):
        m = porting.load_sd_from_diffusers_dir(d, TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG,
                                               dtype=torch.float32, device=dv)
        z = m.vae_encode(img.to(dv) * 2 - 1)
        w8 = build_sd_model(TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, device=dv,
                            unet_state=states["unet"])
        quantize.quantize_module_(w8.unet, torch.float32, min_elems=1024)
        qs.append([x.q.cpu() for x in w8.unet.modules() if isinstance(x, quantize.W8Linear)])
        outs.append([m.text_encode(p) for p in ("low", "lower lower", "")]
                    + [m.unet_apply(lat.to(dv), 500, ctx.to(dv)), z, m.vae_decode(z),
                       w8.unet_apply(lat.to(dv), 500, ctx.to(dv))])
    errs = {n: float((a.cpu() - b).abs().max()) for n, a, b in zip(names, *outs)}
    if max(errs.values()) > 1e-4 or not qs[0] or \
            not all(torch.equal(a, b) for a, b in zip(*qs)):
        raise AssertionError(f"TINY checkpoint card vs CPU: {errs} (bound 1e-4), w8 q equal "
                             f"{all(torch.equal(a, b) for a, b in zip(*qs))}")
    log("phase 4 ok: TINY checkpoint directory (written and read by the port's own "
        "safetensors writer and parser) loaded on the card and on the CPU (float32), max |err|: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; w8 q bit-equal in {len(qs[0])} layers")
    return errs


def unet_file_read_times(model_dir: str):
    """Seconds to read a UNet's safetensors file into CPU tensors with the
    port's parser and, where it is installed, with the safetensors
    package's `load_file`, in turns (port, package, package, port); the
    file is in the page cache from its writing."""
    from comfystereo_tpu_torch.diffusion import porting
    path = os.path.join(model_dir, "unet", "diffusion_pytorch_model.safetensors")
    try:
        from safetensors.torch import load_file
    except ImportError:
        load_file = None
    readers = {"port": porting.load_safetensors, "package": load_file}
    times = {"port": [], "package": [] if load_file else None, "bytes": os.path.getsize(path)}
    for name in ("port", "package", "package", "port"):
        if readers[name] is None:
            continue
        t0 = time.perf_counter()
        tensors = readers[name](path)
        times[name].append(time.perf_counter() - t0)
        del tensors
    return times


def checkpoint_times(dev, sd, ck, smi: str):
    """Directory write and load seconds; CLIP encode of one prompt at full
    width in bf16 (the Fast bundle's) and float32 (the Standard bundle's):
    the first call and the cached one on the host clock with a synchronise,
    and the model's forward alone with CUDA events; the Fast frame through
    the loaded bundle against `build_sd_model`'s, in turns (built, loaded,
    loaded, built); the w8 CFG call against bf16, the UNet's bytes as
    stored, and each call's peak device memory above what was resident;
    the UNet file's read by the port's parser against the safetensors
    package's (`unet_file_read_times`)."""
    import numpy as np
    import torch
    from comfystereo_tpu_torch.diffusion import sd_pipeline
    out = {"write_s": ck["write_s"], "bytes_written": ck["bytes"],
           "load_s": {"fast_bf16": ck["load_s"][0], "standard_f32": ck["load_s"][1]}}
    for key, m in (("bf16", ck["fast"]), ("f32", ck["std"])):
        enc, prompt = m.text_encode, f"{SD_PROMPT}, timed in {key}"
        ids = enc.tokenizer([prompt], padding="max_length", max_length=77, truncation=True,
                            return_tensors="pt").input_ids.to(dev)
        host = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            enc(prompt)
            sync()
            host.append((time.perf_counter() - t0) * 1e3)
        with torch.no_grad():
            fwd = time_ms(lambda: enc.model(ids), iters=10)
        out[f"clip_{key}"] = {"first_ms": host[0], "cached_ms": host[1], "forward_ms": fwd}
        log(f"  CLIP ViT-L/14 encode of one prompt, {key}: first call {host[0]:.2f} ms, cached "
            f"{host[1]:.4f} ms, the model's forward alone {fwd:.3f} ms [{smi}]")
    out["unet_read_s"] = read = unet_file_read_times(ck["inpaint"])
    log(f"  reading the inpainting UNet's safetensors file ({read['bytes'] / 1e9:.3f} GB) "
        f"into CPU tensors, in turns: port's parser {read['port']}, safetensors package "
        f"{read['package']} s (timed here only; the port has no use for the package) [{smi}]")
    img, dep = (torch.from_numpy(a).to(dev) for a in sd_fixture(SD_SIZE))

    def frame(model):
        sync()
        t0 = time.perf_counter()
        sd_pipeline.warp_inpaint(model, img, dep, SD_PROMPT, divergence=5.0,
                                 num_inference_steps=20, strength=0.6, guidance_scale=3.0,
                                 seed=np.array([SD_SEED], np.uint64))
        sync()
        return (time.perf_counter() - t0) * 1e3

    built, loaded = sd["model"], ck["fast"]
    frame(built)
    frame(loaded)
    turns = [("built", frame(built)), ("loaded", frame(loaded)), ("loaded", frame(loaded)),
             ("built", frame(built))]
    out["fast_frame_ms"] = {k: [ms for n, ms in turns if n == k] for k in ("built", "loaded")}
    log(f"  StereoDiffusion Fast frame {SD_SIZE}x{SD_SIZE} bf16, in turns: " + ", ".join(
        f"{n} {ms:.1f}" for n, ms in turns) + f" ms (loaded bundle: CLIP conditioning; built: "
        f"the hash stand-in) [{smi}]")
    lat, ctx, t = ck["lat"], ck["ctx"], ck["t"]
    for key in ("ref", "w8"):
        m = ck[key]
        ms = time_ms(lambda: m.unet_apply(lat, t, ctx), iters=5)
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        m.unet_apply(lat, t, ctx)
        sync()
        peak = torch.cuda.max_memory_allocated() - base
        name = "bf16" if key == "ref" else "w8"
        out[f"cfg_{name}"] = {"ms": ms, "peak_above_resident_bytes": peak,
                              "unet_bytes": ck["unet_bytes"][name]}
        log(f"  UNet CFG call {tuple(lat.shape)} {name}: {ms:.3f} ms, peak device memory "
            f"{peak / 2 ** 30:.3f} GiB above the resident {base / 2 ** 30:.2f} GiB, UNet stored "
            f"{ck['unet_bytes'][name] / 1e9:.3f} GB [{smi}]")
    log(f"  checkpoint directories: written in {ck['write_s']:.1f} s ({ck['bytes'] / 1e9:.3f} "
        f"GB), loaded onto the card in {ck['load_s'][0]:.1f} s (bf16 inpainting) and "
        f"{ck['load_s'][1]:.1f} s (float32 SD 1.5) [{smi}]")
    return out


def phase_standard_card_vs_cpu(dev, size: int = 64):
    """text2stereo at the TINY configs in float32 (TF32 off) with the same
    seeded weights and injected deblur noise on the card and on the CPU:
    4 steps, null-text on with 2 inner steps, deblur on. Left and right
    within 1e-3, as warp_inpaint is held."""
    import torch
    from comfystereo_tpu_torch.diffusion import (TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG,
                                                 build_sd_model, sd_pipeline)
    img, dep = (torch.from_numpy(a) for a in sd_fixture(size))
    x = img.permute(0, 3, 1, 2) * 2.0 - 1.0
    f = 2 ** (len(TINY_SD_VAE_CONFIG.block_out_channels) - 1)
    noise = torch.randn((1, TINY_SD_VAE_CONFIG.latent_channels, size // f, size // f),
                        generator=torch.Generator().manual_seed(3))
    outs = []
    for d in (dev, torch.device("cpu")):
        m = build_sd_model(TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, seed=0, device=d)
        outs.append(sd_pipeline.text2stereo(
            m, x.to(d), dep.to(d), "a cat", scale_factor=8.0, direction="uni", deblur=True,
            guidance_scale=3.0, num_inference_steps=4, null_text_optimization=True,
            num_inner_steps=2, noise=noise.to(d)))
    errs = [float((a.cpu() - b).abs().max()) for a, b in zip(outs[0], outs[1])]
    if max(errs) > 1e-3:
        raise AssertionError(f"text2stereo card vs CPU: max |err| left {errs[0]}, right "
                             f"{errs[1]} > 1e-3")
    log(f"phase 4 ok: text2stereo card vs CPU at the TINY configs, {size}x{size}, 4 steps, "
        f"null-text (2 inner steps), deblur: left max |err| {errs[0]:.3g}, right "
        f"{errs[1]:.3g}")
    return errs


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

    pk = peaks(name)
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
            f"({what}, H100 peaks; {100 * bound / ms:.1f}% of it reached), plain "
            f"{plain_ms:.3f} ms, scaled_dot_product_attention {lib_ms:.4f} ms [{smi}]")
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    ms, plain_ms, lib_ms, bound, by = rows[0]
    entry = {"name": "flash_attention", "route": "cuda",
             "source": "comfystereo_tpu_torch/csrc/flash_attention.cu",
             "replaces": "comfystereo_tpu/pallas/flash_attention.py:164", "launches": launches,
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": by, "library_ms": lib_ms, "redesigned": REDESIGNED["flash_attention"]}
    log(f"  flash_attention build [{smi}]: {ptxas_usage('flash_attention')}; dynamic shared "
        f"memory per CTA {flash_smem(64)} B (d <= 64), {flash_smem(128)} B (d <= 128)")

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
    # half of a frame's device launches at each level (replays included)
    calls, half = SD_UNET_CALLS, SD_UNET_CALLS * SD_FLASH_PER_CALL // 2
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


def flash_backward_times(dev, smi: str):
    """The flash kernel's backward (the recompute of `reference_bf16` and its
    autograd) at [8, 4096, 4096, 40], beside the backward of
    scaled_dot_product_attention on the same inputs (a yardstick the port
    never calls), both from a retained graph with one cotangent."""
    import torch
    import torch.nn.functional as F
    from comfystereo_tpu_torch.kernels import flash_attention as fa
    bh, nq, nk, d = FLASH_GRAD_SHAPES[0]
    q, k, v = (t.requires_grad_(True) for t in flash_inputs(dev, bh, nq, nk, d, seed=3))
    g = torch.randn((bh, nq, d), device=dev).to(torch.bfloat16)
    out = fa.flash_attention(q, k, v, d ** -0.5)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True),
                     iters=5)
    q4, k4, v4 = (t.detach().reshape(1, bh, -1, d).requires_grad_(True) for t in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4, scale=d ** -0.5)
    g4 = g.reshape(1, bh, nq, d)
    lib_ms = time_ms(lambda: torch.autograd.grad(out4, (q4, k4, v4), g4, retain_graph=True),
                     iters=10)
    log(f"  flash_attention backward {(bh, nq, nk, d)}: {bwd_ms:.4f} ms (recompute of "
        f"reference_bf16, no kernel), scaled_dot_product_attention backward {lib_ms:.4f} ms "
        f"[{smi}]")
    del q, k, v, out, q4, k4, v4, out4
    torch.cuda.empty_cache()
    return bwd_ms, lib_ms


def standard_times(dev, std, smi: str):
    """One Standard frame at the node's defaults, part by part on the host
    clock with a synchronise at each boundary: VAE encode, the round trip's
    decode, the DDIM inversion loop, the null-text loop (its inner
    iterations, and one fwd+bwd iteration timed alone), the denoising loop
    (each CFG call timed with CUDA events, plain and stereo-active apart),
    the decode; peak device memory; the device idle share of each part's
    unit (one inversion UNet call, one null-text timestep, one plain and
    one stereo CFG call, the decode), weighted by the parts' times."""
    import numpy as np
    import torch
    from comfystereo_tpu_torch.diffusion import inversion, schedulers, sd_pipeline
    model, s = std["model"], SD_SIZE
    img, dep = (torch.from_numpy(a).to(dev) for a in sd_fixture(s))
    x = img.permute(0, 3, 1, 2) * 2.0 - 1.0
    steps, g = STD_DEFAULTS["num_inference_steps"], STD_DEFAULTS["guidance_scale"]
    sched = schedulers.make_ddim(steps)
    cond = uncond = model.text_encode("")
    parts = {}

    def part(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        parts[name] = (time.perf_counter() - t0) * 1e3
        return out

    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        latent = part("vae_encode_ms", lambda: inversion.image_to_latent(model, x))
        part("vae_roundtrip_decode_ms", lambda: inversion.latent_to_image(model, latent))
        traj = part("ddim_inversion_ms",
                    lambda: inversion.ddim_invert_loop(model, sched, latent, cond))

    def null_text():
        u, cur, us = uncond, traj[-1], []
        for i in range(steps):
            lr = float(np.float32(1e-2 * (1.0 - i / 100.0)))
            stop = float(np.float32(1e-5 + i * 2e-5))
            u, cur = inversion.null_text_optimize_step(
                model, sched, cur, traj[steps - i - 1], int(sched.timesteps[i]), u, cond, g,
                10, lr, stop)
            us.append(u)
        return torch.stack(us)

    with UNetCalls(model) as calls:
        unconds = part("null_text_ms", null_text)
    inner = calls.grad
    inv = inversion.InversionResult(traj, unconds, None)
    with torch.no_grad(), UNetCalls(model, timed=True) as calls:
        latents = part("denoise_ms", lambda: sd_pipeline._denoise_loop(
            model, sched, inv, cond, dep, STD_DEFAULTS["scale_factor"],
            STD_DEFAULTS["direction"], False, g, steps, SD_SEED, True, None))
        n_plain, plain_ms = calls.ms("plain")
        n_stereo, stereo_ms = calls.ms("stereo")
        out = part("decode_ms", lambda: sd_pipeline._to_01(
            inversion.latent_to_image(model, latents)))
    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("Standard frame (timed parts) not finite")
    frame_ms = sum(parts.values())
    lat, prev = traj[-1], traj[-2]
    t0 = int(sched.timesteps[0])
    fwdbwd_ms = time_ms(lambda: null_text_grad(model, lat, prev, t0, sched), iters=3,
                        warmup=1)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: model.unet_apply(lat, t0, cond), iters=5)
    per_inner = (parts["null_text_ms"] - 2 * steps * fwd_ms) / max(inner, 1)
    log(f"  StereoDiffusion Standard {s}x{s} bf16, node defaults [{smi}]: {frame_ms:.1f} "
        f"ms/frame = VAE encode {parts['vae_encode_ms']:.1f} + round-trip decode "
        f"{parts['vae_roundtrip_decode_ms']:.1f} + DDIM inversion ({steps} UNet calls) "
        f"{parts['ddim_inversion_ms']:.1f} + null-text {parts['null_text_ms']:.1f} ({inner} "
        f"inner iterations, {2 * steps} more forwards) + denoising {parts['denoise_ms']:.1f} "
        f"({n_plain} CFG calls before the stereo start, {plain_ms:.1f} ms, "
        f"{plain_ms / max(n_plain, 1):.2f} ms each; {n_stereo} stereo-active, "
        f"{stereo_ms:.1f} ms, {stereo_ms / max(n_stereo, 1):.2f} ms each) + decode "
        f"{parts['decode_ms']:.1f}; one UNet forward (batch 1) {fwd_ms:.2f} ms; null-text "
        f"{per_inner:.2f} ms per inner iteration (fwd+bwd+Adam, from the loop's time less "
        f"its {2 * steps} plain forwards), one gradient alone (2 forwards, 1 backward) "
        f"{fwdbwd_ms:.2f} ms; peak device memory {peak / 2 ** 30:.2f} GiB")

    # Idle shares of one unit of each part, weighted by the parts' times.
    mode = sd_pipeline.AttentionMode(stereo=True, direction=STD_DEFAULTS["direction"])
    ctx = torch.cat([uncond] * 2 + [cond] * 2, dim=0)
    lat4 = torch.cat([lat] * 4, dim=0)
    t_s = int(sched.timesteps[-1])

    def unit(**kw):
        with torch.no_grad():
            return model.unet_apply(lat4, t_s, ctx, mode=mode, **kw)

    def nt_step():
        return inversion.null_text_optimize_step(model, sched, lat, prev, t0, uncond, cond, g,
                                                 10, 1e-2, 0.0)

    units = {
        "ddim_inversion_ms": ("inversion UNet call", lambda: model.unet_apply(lat, t0, cond)),
        "null_text_ms": ("null-text timestep (10 inner)", nt_step),
        "denoise_plain": ("CFG call", lambda: unit(stereo_active=False)),
        "denoise_stereo": ("stereo CFG call", lambda: unit(stereo_active=True)),
        "decode_ms": ("decode", lambda: inversion.latent_to_image(model, latents)),
    }
    weights = dict(parts, denoise_plain=plain_ms, denoise_stereo=stereo_ms)
    idle, total = {}, 0.0
    for key, (label, fn) in units.items():
        with torch.no_grad() if key != "null_text_ms" else contextlib.nullcontext():
            res = idle_share(f"Standard {label}", fn, 0.0, smi, iters=1)
        idle[key] = res["idle_share"]
        if res["idle_share"] is not None:
            total += res["idle_share"] * weights[key]
    covered = sum(weights[k] for k in units if idle[k] is not None)
    frame_idle = total / covered if covered else None
    log(f"  Standard frame idle share (parts' shares weighted by their times, "
        f"{covered / frame_ms:.1%} of the frame covered): "
        f"{'not measured' if frame_idle is None else f'{frame_idle:.4f}'} [{smi}]")
    return dict(parts, frame_ms=frame_ms, null_text_inner=inner, cfg_plain_calls=n_plain,
                cfg_plain_ms=plain_ms, cfg_stereo_calls=n_stereo, cfg_stereo_ms=stereo_ms,
                unet_forward_ms=fwd_ms, null_text_ms_per_inner=per_inner,
                null_text_grad_ms=fwdbwd_ms,
                max_memory_allocated=peak, idle_share_parts=idle, idle_share=frame_idle,
                node_first_call_s=std["runs"]["defaults"]["seconds"])


def phase_times(dev, launches, errs, smi: str, name: str,
                n: int = FRAMES, h: int = HEIGHT, w: int = WIDTH):
    import torch
    from comfystereo_tpu_torch import StereoConfig, stereo_pipeline
    from comfystereo_tpu_torch.kernels import (distance, gather, polylines, polylines_exact,
                                               warp_kernel)

    bw, flops, _, _ = peaks(name)
    imgs, deps = fixture_frames(n, h, w)
    image = torch.from_numpy(imgs).to(dev).float() / 255.0
    depth255 = torch.from_numpy(deps).to(dev).float()

    warp_t = warp_times(image, depth255)
    dist_t = distance_times(depth255)
    blend_t = box_blend_times(depth255)
    gather_t = gather_times(dev, n, h, w)
    poly_t = polylines_times(image * 255.0, depth255)
    ss_t = polylines_ss_times(image * 255.0, depth255)

    def entry(kname, source, replaces, ms, plain_ms, nbytes, ops, err, library_ms=None,
              redesigned=None):
        t_bytes, t_ops = nbytes / bw * 1e3, ops / flops * 1e3
        e = {"name": kname, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches[kname],
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": library_ms}
        if redesigned:
            e["redesigned"] = redesigned
        return e

    kernels = [
        entry("warp_rows", "comfystereo_tpu_torch/csrc/warp_kernel.cu",
              "comfystereo_tpu/pallas/warp_kernel.py:222", warp_t["ms"], warp_t["plain_ms"],
              warp_t["bytes"], warp_t["ops"], errs["warp_max_abs_err"],
              redesigned=REDESIGNED["warp_kernel"]),
        entry("edge_distances", "comfystereo_tpu_torch/csrc/distance.cu",
              "comfystereo_tpu/pallas/distance.py:59", dist_t["ms"], dist_t["plain_ms"],
              dist_t["bytes"], dist_t["ops"], errs["distance_max_abs_err"],
              redesigned=REDESIGNED["distance"]),
        entry("box_blend", "comfystereo_tpu_torch/csrc/box_blend.cu",
              "none (the JAX package leaves the box means to XLA)", blend_t["ms"],
              blend_t["plain_ms"], blend_t["bytes"], blend_t["ops"],
              errs["box_blend_max_abs_err"]),
        entry("bounded_take_along_w", "comfystereo_tpu_torch/csrc/gather.cu",
              "comfystereo_tpu/pallas/gather.py:100", gather_t["ms"],
              gather_t["plain_ms"], gather_t["bytes"], 0.0,
              errs["gather_max_abs_err"], gather_t["library_ms"], REDESIGNED["gather"]),
        entry("polylines_exact_rows", "comfystereo_tpu_torch/csrc/polylines_exact.cu",
              "comfystereo_tpu/pallas/polylines_exact_kernel.py:630", poly_t["ms"],
              poly_t["plain_ms"], poly_t["bytes"], poly_t["ops"],
              errs["polylines_max_abs_err"], redesigned=REDESIGNED["polylines_exact"]),
        entry("polylines_scanline", "comfystereo_tpu_torch/csrc/polylines.cu",
              "comfystereo_tpu/pallas/polylines_kernel.py:281", ss_t["ms"],
              ss_t["plain_ms"], ss_t["bytes"], ss_t["ops"],
              errs["polylines_ss_max_abs_err"], redesigned=REDESIGNED["polylines"]),
    ]
    for k in kernels:
        lib = "" if k["library_ms"] is None else f", library {k['library_ms']:.4f} ms"
        log(f"  {k['name']}: {k['ms']:.4f} ms/launch, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}, H100 peaks), plain {k['plain_ms']:.3f} ms{lib}, "
            f"{k['launches']} launches per {n}-frame chunk "
            f"({k['launches'] / n:.4f} per frame) [{smi}]")
    for k in kernels:
        if k["bound_ms"] > k["ms"]:
            raise AssertionError(f"{k['name']}: bound {k['bound_ms']} ms above its time "
                                 f"{k['ms']} ms: the count is wrong")
    log(f"  gather of [{n},3,{h},{w}] colour by a [{n},1,{h},{w}] plane: "
        f"{gather_t['plane_ms']:.4f} ms, bound {gather_t['plane_bytes'] / bw * 1e3:.4f} ms "
        f"(bytes, {gather_t['plane_bytes']:.4g}), torch.gather "
        f"{gather_t['plane_library_ms']:.4f} ms [{smi}]")
    log(f"  polylines (fused entry) soft: {poly_t['soft_ms']:.4f} ms/launch; sharp entry "
        f"taking x: {poly_t['rows_ms']:.4f} ms; sharp: pieces per pixel "
        f"{poly_t['pieces_per_px']:.3f}, row window {poly_t['window_mean']:.1f} columns, "
        f"walk {poly_t['steps_mean']:.2f} steps per column, list {poly_t['list_mean']:.3f} "
        f"entries per column (max {poly_t['list_max']}, {poly_t['over_cap']} columns over "
        f"capacity), active candidates per piece {poly_t['active_per_piece']:.3f}, "
        f"{poly_t['ops']:.4g} operations (previous design: "
        f"{PREVIOUS_OPS['polylines_exact_rows']:.4g}), {poly_t['bytes']:.4g} bytes [{smi}]")
    log(f"  supersampled polylines (fused entry) soft: {ss_t['soft_ms']:.4f} ms/launch; "
        f"sums entry taking x, sharp: {ss_t['rows_ms']:.4f} ms; sharp: {ss_t['ops']:.4g} "
        f"operations ({ss_t['ops'] / (n * h * w):.1f} per pixel; previous design: "
        f"{PREVIOUS_OPS['polylines_scanline']:.4g}), {ss_t['bytes']:.4g} bytes, found share "
        f"{ss_t['found_share']:.4f}, winners looked for and found "
        f"{ss_t['scans_per_column']:.3f} times per column, building "
        f"{ss_t['built_per_column']:.3f} candidates [{smi}]")
    log(f"  warp_rows (fused entry, the path's) float32 {warp_t['ms']:.4f} ms/launch, "
        f"bfloat16 {warp_t['bf16_ms']:.4f}; entry taking offsets {warp_t['rows_ms']:.4f}; "
        f"{warp_t['bytes']:.4g} bytes ({warp_t['bytes'] / (n * h * w):.0f} B/px), "
        f"{warp_t['ops']:.4g} operations; prefilter per column: row window "
        f"{warp_t['window_mean']:.2f} candidates, walked {warp_t['walked_mean']:.3f}, divided "
        f"{warp_t['tested_mean']:.3f} [{smi}]")
    log(f"  edge_distances: fused entry (the path's) {dist_t['ms']:.4f} ms/launch, "
        f"{dist_t['bytes']:.4g} bytes; mask entry {dist_t['masks_ms']:.4f} ms [{smi}]")
    for mod in ("warp_kernel", "distance", "box_blend", "gather", "polylines_exact",
                "polylines"):
        log(f"  {mod} build [{smi}]: {ptxas_usage(mod)}")
    log(f"  dynamic shared memory per CTA [{smi}]: warp {warp_kernel.smem_bytes(w)} B "
        f"(widest row {warp_kernel.MAX_WIDTH}); distance {distance.smem_bytes(w)} B; gather "
        f"{gather.smem_bytes(w, w, 1)} B (keys), {gather.smem_bytes(w, w, 3)} B (plane); "
        f"polylines_exact {polylines_exact.smem_bytes(w)} B; polylines "
        f"{polylines.smem_bytes(w, 8)} B")

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
    parts = blur_and_eye_parts(image, depth01, cfg)
    log("  gpu_warp blur and left eye, part by part per chunk (float32): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in parts.items()) + f" [{smi}]")
    pipeline["float32"]["parts_ms"] = parts
    pipeline["float32"].update(idle_share(
        "gpu_warp", lambda: stereo_pipeline(image, depth01, cfg),
        pipeline["float32"]["ms_per_chunk"], smi))
    pipeline["fills"] = fill_times(image, depth01, smi)
    log(f"phase 5 ok: times on {name} ({smi})")
    return kernels, pipeline


def warp_times(image, depth255):
    """The warp kernel on the left eye's rows of 12 frames at 1080p: the
    fused entry the path launches (float32, and bfloat16 colour), the entry
    taking offsets, and the fused entry's plain composition; the fused
    entry's bytes (depth 4 B, colour in and out, gap 1 B per pixel) and the
    operations it does on this input (`warp_work`)."""
    import torch
    from comfystereo_tpu_torch.kernels import warp_kernel as wk
    rows, dmin, dmax, img, kw = warp_fused_inputs(image, depth255, DIV_PCT, 0.0)
    off, nd, _, rkw = warp_rows_inputs(image, depth255, DIV_PCT, 0.0)
    img_bf16 = img.to(torch.bfloat16)
    out = {"ms": time_ms(lambda: wk.warp_rows_fused(rows, dmin, dmax, img, **kw)),
           "bf16_ms": time_ms(lambda: wk.warp_rows_fused(rows, dmin, dmax, img_bf16, **kw)),
           "rows_ms": time_ms(lambda: wk.warp_rows(off, nd, img, **rkw)),
           "plain_ms": time_ms(lambda: wk.warp_rows_fused_plain(rows, dmin, dmax, img, **kw),
                               iters=3, warmup=1),
           "bytes": 4.0 * rows.numel() + 2.0 * img.numel() * img.element_size() + rows.numel()}
    out.update(warp_work(off, nd, rkw, img.shape[-1]))
    return out


def warp_work(off, nd, kw, c: int):
    """The float and integer operations of the fused warp entry on these
    rows, counted from csrc/warp_kernel.cu and this input (the counts of
    tests/torch_warp_model.py:walk_model, the kernel's prefilter modelled):
    - per pixel: nd and the offset (12 at exponent 2), dl (1), the segment's
      interval (16), the row's offset range (2), the border search and gap
      interpolation (20) and the bilinear taps (4 per channel);
    - per group of 32 columns, per segment of the row's window it looks at
      for the warp's window: 6;
    - per candidate walked: the interval test (3);
    - per candidate inside its segment's interval: sw, frac, mstart and the
      tests (12), zz and the rule (6)."""
    from comfystereo_tpu_torch.kernels import warp_kernel as wk
    model = tests_module("torch_warp_model")
    n, w = off.shape
    _, _, walked, tested = model.walk_model(off, nd, kw["gradient_threshold"],
                                            kw["max_stretch"], kw["max_disp"])
    lo, hi = wk._window(off, kw["max_disp"])
    window = (hi - lo + 1).clamp(min=0).float()
    groups = (w + 31) // 32
    ops = (n * w * (51.0 + 4 * c) + 6.0 * float(((window + 31) * groups).sum())
           + 3.0 * float(walked.sum()) + 18.0 * float(tested.sum()))
    return {"ops": ops, "window_mean": float(window.mean()),
            "walked_mean": float(walked.float().mean()),
            "tested_mean": float(tested.float().mean())}


def distance_times(depth255):
    """The distance kernel on 12 frames of 1080p depth: the fused entry the
    blur launches, its plain composition and the mask entry on the same
    depth's masks; the fused entry's bytes (depth 4 B in, two weights 8 B
    out per pixel) and operations (about 30 per pixel: the Sobel sums 4, the
    edge strength and masks 7, and per mask the distance 4 and the weight
    5)."""
    from comfystereo_tpu_torch.kernels import distance
    n, h, w = depth255.shape
    rows = depth255.reshape(-1, w).contiguous()
    kw = dict(edge_threshold=20.0, mask_radius=20, falloff=2.0, height=h)
    ml, mr = edge_masks(depth255)
    return {"ms": time_ms(lambda: distance.edge_weights_fused(rows, **kw)),
            "plain_ms": time_ms(lambda: distance.edge_weights_plain(rows, **kw)),
            "masks_ms": time_ms(lambda: distance.edge_distances(ml, mr)),
            "bytes": 12.0 * rows.numel(), "ops": 30.0 * rows.numel()}


def box_blend_times(depth255, taps: int = 20, radius: int = 6):
    """The blur's work after the edge weights on [n, h, w] depth and its edge
    weights (the cells' window): ms of the plain composition, which every
    tree has (`ops/blur.py`'s box means, clamps and blends), and of the
    box-blend kernel where the tree has it; the kernel's bytes (depth and
    both weights in, both eyes out: 20 B/px) and operations
    (`box_blend_ops`)."""
    import importlib.util
    import torch
    from comfystereo_tpu_torch.kernels import distance
    from comfystereo_tpu_torch.ops import blur
    n, h, w = depth255.shape
    wl, wr = (t.reshape(depth255.shape) for t in distance.edge_weights_fused(
        depth255.reshape(-1, w).contiguous(), edge_threshold=20.0, mask_radius=20,
        falloff=2.0, height=h))

    def composition():
        gl = torch.clamp(blur.box_blur_h(wl, radius), 0.0, 1.0)
        gr = torch.clamp(blur.box_blur_h(wr, radius), 0.0, 1.0)
        b = blur.box_blur_w(depth255, taps)
        return gl * b + (1.0 - gl) * depth255, gr * b + (1.0 - gr) * depth255

    px = depth255.numel()
    out = {"plain_ms": time_ms(composition), "bytes": 20.0 * px,
           "ops": box_blend_ops(taps, radius) * px}
    if importlib.util.find_spec("comfystereo_tpu_torch.kernels.box_blend") is not None:
        from comfystereo_tpu_torch.kernels import box_blend
        out["ms"] = time_ms(lambda: box_blend.box_blend(depth255, wl, wr, taps=taps,
                                                         radius=radius))
    return out


def box_blend_ops(taps: int, radius: int) -> float:
    """Operations a pixel of the box-blend kernel: per weight plane 2r adds,
    a division and a clamp; the depth's n - 1 adds and a division; per eye
    the blend's two products, a difference and a sum."""
    return 2 * (2 * radius + 2) + taps + 2 * 4


def blur_and_eye_parts(image, depth01, cfg):
    """ms per chunk of the blur's parts (the fused edge-weights kernel, the
    box-blend kernel: the weights' vertical box means, the depth's
    horizontal box mean and both eyes' blends) and of the left eye's (each
    image's min and max, the fused warp kernel), each timed alone on the
    pipeline's inputs."""
    import torch
    from comfystereo_tpu_torch import pipeline as pipe
    from comfystereo_tpu_torch.kernels import box_blend, distance, warp_kernel
    from comfystereo_tpu_torch.ops import blur
    d255 = pipe._depth255(depth01)
    n, h, w = d255.shape
    rows = d255.reshape(-1, w).contiguous()
    kw = dict(edge_threshold=cfg.depth_blur_edge_threshold,
              mask_radius=int(cfg.depth_blur_strength),
              falloff=blur._f32(cfg.depth_blur_falloff), height=h)
    wl, wr = (t.reshape(d255.shape) for t in distance.edge_weights_fused(rows, **kw))
    blend_kw = dict(taps=int(round(cfg.depth_blur_strength)),
                    radius=int(cfg.depth_blur_vert_smooth))
    left_d, _ = pipe._blurred_eye_depths(d255, cfg)
    src = pipe._eye_source(image, cfg)
    eye_rows, dmin, dmax, img, fkw = warp_fused_inputs(src, left_d, cfg.eye_divergences()[0],
                                                       -cfg.separation)
    return {
        "weights_kernel": time_ms(lambda: distance.edge_weights_fused(rows, **kw)),
        "box_blend_kernel": time_ms(lambda: box_blend.box_blend(d255, wl, wr, **blend_kw)),
        "eye_min_max": time_ms(lambda: torch.aminmax(eye_rows.reshape(n, -1), dim=-1)),
        "eye_kernel": time_ms(lambda: warp_kernel.warp_rows_fused(eye_rows, dmin, dmax, img,
                                                                  **fkw)),
    }


def gather_times(dev, n: int, h: int, w: int):
    """The gather kernel, its plain version and torch.gather on the fills'
    int32 keys (the binary searches' call, the most frequent), and on
    colour planes by one index plane. Bytes: each value, index and output
    element once, 4 B each (keys: 12 B per output element; the plane: 8 B
    per output element and 4 B per index element)."""
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
        "plane_bytes": 4.0 * (2 * planes.numel() + idx_plane.numel()),
    }


# Operations that the kernels' previous designs counted on the same input
# (the exact kernel's per-piece window walks, the supersampled kernel's
# per-sample rebuilds), printed beside the recount.
PREVIOUS_OPS = {"polylines_exact_rows": 1.662e10, "polylines_scanline": 1.709e10}


def polylines_times(image255, depth255):
    """The exact polylines kernel on the left eye's rows at 1080p: the fused
    entry the route launches (sharp, the node's fill; and soft), the entry
    that takes x, and the plain composition, with the fused entry's bytes
    (offset and colour in, colour out: 4 B each per pixel and channel, 28 B
    per pixel) and the operations of the sharp call on this input
    (`polylines_work`)."""
    from comfystereo_tpu_torch.kernels import polylines_exact as pk
    x, coord, colors, max_disp = polylines_inputs(image255, depth255, DIV_PCT, 0.0)
    cl = coord.abs()
    kw = dict(max_pieces=12, max_disp=max_disp)
    ms = time_ms(lambda: pk.polylines_exact_rows_fused(coord, colors, 0.0, sharp=True, **kw))
    soft_ms = time_ms(lambda: pk.polylines_exact_rows_fused(coord, colors, 0.0, sharp=False,
                                                            **kw))
    rows_ms = time_ms(lambda: pk.polylines_exact_rows(x, cl, colors, sharp=True, **kw))
    plain_ms = time_ms(lambda: pk.polylines_exact_rows_fused_plain(coord, colors, 0.0, True, 12,
                                                                   max_disp), iters=2, warmup=1)
    work = polylines_work(x, max_disp, True, colors.shape[-1])
    nbytes = 4.0 * (coord.numel() + 2 * colors.numel())
    return {"ms": ms, "soft_ms": soft_ms, "rows_ms": rows_ms, "plain_ms": plain_ms,
            "bytes": nbytes, **work}


def polylines_ss_times(image255, depth255):
    """The supersampled polylines kernel (S = 8, K = 4) on the left eye's
    rows at 1080p: the fused entry the route launches (sharp; and soft), the
    sums entry, and the plain composition, with the fused entry's bytes (28
    B per pixel, as the exact kernel's) and the operations of the sharp call
    on this input (`polylines_ss_work`)."""
    from comfystereo_tpu_torch.kernels import polylines as pk
    x, coord, colors, max_disp = polylines_inputs(image255, depth255, DIV_PCT, 0.0)
    kw = dict(samples=8, k_candidates=4, max_disp=max_disp)
    ms = time_ms(lambda: pk.polylines_scanline_fused(coord, colors, 0.0, sharp=True, **kw))
    soft_ms = time_ms(lambda: pk.polylines_scanline_fused(coord, colors, 0.0, sharp=False, **kw))
    rows_ms = time_ms(lambda: pk.polylines_scanline(x, coord, colors, sharp=True, **kw))
    plain_ms = time_ms(lambda: pk.polylines_scanline_fused_plain(coord, colors, 0.0, sharp=True,
                                                                 **kw), iters=3, warmup=1)
    work = polylines_ss_work(x, coord, max_disp, True, colors.shape[-1])
    nbytes = 4.0 * (coord.numel() + 2 * colors.numel())
    return {"ms": ms, "soft_ms": soft_ms, "rows_ms": rows_ms, "plain_ms": plain_ms,
            "bytes": nbytes, **work}


def polylines_ss_work(x, coord, max_disp: int, sharp: bool, c: int, samples: int = 8,
                      k: int = 4):
    """The float operations (adds, products, divisions, compares, min/max)
    the fused entry of csrc/polylines.cu does on rows `x`, counted from its
    code and this input:
    - per pixel: x (3 adds) and the finish (5 per channel);
    - per slot of the W + 1: the endpoints (2), the member and order tests
      (5), sharp the flat tops (2) and their min/max (2), and the two scans'
      min/max (4);
    - per column: the two searches' compares (2 per round, and col + 1) and
      the two groups' bounds (8);
    - per column and sample: the sample position (1); per group the test of
      its kept winner (1), ip (4), covered (2) and closeness (4); the
      combine (1), the chosen group's colour (3 per channel) and the sums
      (C);
    - where a group's winner is looked for and one is hit (the first
      sample, and each sample where its first hit moves to another
      candidate: counted from this input by `hit_indices`): the rebuild with
      its denominator (8), and 10 (ends, member and order tests, the hit
      test) for each candidate built on the way, in sweep order from the
      first (downward) or from the one after the old winner (upward)."""
    import torch
    from comfystereo_tpu_torch.kernels import polylines as pk
    n, w = x.shape
    rounds = pk.search_rounds(max_disp)
    up, dn = pk.hit_indices(x, coord, sharp, samples, k, max_disp)
    scans, built, found = 0.0, 0.0, 0.0
    for idx, upward in ((up, True), (dn, False)):
        idx = idx.long()
        found += float((idx >= 0).sum())
        for t in range(samples):
            cur = idx[t]
            looked = (cur >= 0) if t == 0 else (cur >= 0) & (cur != idx[t - 1])
            start = (idx[t - 1] + 1).clamp(min=0) if upward and t > 0 else 0
            scans += float(looked.sum())
            built += float(((cur - start + 1) * looked).sum())
    del up, dn
    per_pixel = 3 + 5 * c
    per_slot = 15.0 if sharp else 11.0
    per_column = 2 * rounds + 1 + 8
    per_sample = 1 + 2 * (1 + 4 + 2 + 4) + 1 + 3 * c + c
    ops = (n * w * per_pixel + n * (w + 1) * per_slot + n * w * per_column
           + n * w * samples * per_sample + 8.0 * scans + 10.0 * built)
    return {"ops": ops, "found_share": found / (2.0 * n * w * samples),
            "scans_per_column": scans / (n * w), "built_per_column": built / (n * w)}


def polylines_work(x, max_disp: int, sharp: bool, c: int):
    """The float operations the fused entry of csrc/polylines_exact.cu does
    on rows `x`, counted from its code and this input:
    - per pixel: x and |coord| (4), m and its ranges (4), the finish (3 per
      channel);
    - the walk, per column and step of its warp's window: the source's
      points and the list tests (sharp: 2 adds and 4 compares; soft: the
      landing and list tests, 4 compares); sharp, per listed flat top, the
      landing tests of its two points (4); and 24 min/max for every point
      that lands in the row;
    - per valid piece: its geometry (6), the two sentinels' activity tests
      (4), the winner choice (1) and the accumulation (6 per channel); per
      entry of the column's candidate list its ends and activity test (4);
      a column whose list overflowed (none on the fixture) is counted by its
      list;
    - per active candidate, which alone goes on to the blend: the division
      and closeness blend (7) and the winner and fallback tests (5)."""
    import torch
    from comfystereo_tpu_torch.kernels import polylines_exact as pk
    n, w = x.shape
    hw = 0.45 if sharp else 0.0
    cols = torch.arange(w, device=x.device)
    lo, hi = pk.window(x, max_disp)                              # [n, 1]
    lengths, flats, steps = pk.candidate_lists(x, sharp, max_disp)
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
    step_ops = 6.0 if sharp else 4.0
    ops = (n * w * (8.0 + 3.0 * c) + float(steps.sum()) * step_ops + 4.0 * float(flats.sum())
           + 24.0 * landed
           + float(pieces.sum()) * (11.0 + 6.0 * c)
           + 4.0 * float((pieces * lengths).sum()) + 12.0 * float(active.sum()))
    return {"ops": ops, "pieces_per_px": float(pieces.mean()),
            "window_mean": float((hi - lo + 1).float().mean()),
            "steps_mean": float(steps.float().mean()),
            "list_mean": float(lengths.float().mean()), "list_max": int(lengths.max()),
            "over_cap": int((lengths > pk.LIST_CAP).sum()),
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


def kernel_times(dev, smi: str, root: str) -> None:
    """The flash kernel beside scaled_dot_product_attention at FLASH_SHAPES,
    the gather beside torch.gather on the keys and the plane, and both
    polylines kernels, sharp and soft, at phase 5's shapes, for the package
    under `root`: one JSON line, so that two trees (a parent's and its
    change) can be timed in turns in one call on one card."""
    import torch
    import torch.nn.functional as F
    from comfystereo_tpu_torch.kernels import _build, flash_attention as fa, gather
    _build.build([n for n in ("warp_kernel", "distance", "flash_attention", "gather",
                              "polylines_exact", "polylines", "box_blend")
                  if n in _build.SIGNATURES])
    out = {"root": root, "card": smi, "flash": {}, "gather": {}}
    for bh, nq, nk, d in FLASH_SHAPES:
        q, k, v = flash_inputs(dev, bh, nq, nk, d, seed=1)
        q4, k4, v4 = (t.reshape(2, bh // 2, -1, d) for t in (q, k, v))
        out["flash"][str((bh, nq, nk, d))] = {
            "ms": time_ms(lambda: fa.flash_attention(q, k, v, d ** -0.5), iters=20),
            "sdpa_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, scale=d ** -0.5), iters=20)}
        del q, k, v, q4, k4, v4
    keys, idx, planes, idx_plane, disp = gather_inputs(dev, FRAMES, HEIGHT, WIDTH, seed=1)
    plane64 = idx_plane.long().expand(planes.shape)
    idx64 = idx.long()
    out["gather"] = {
        "keys_ms": time_ms(lambda: gather.bounded_take_along_w(keys, idx, disp)),
        "keys_torch_gather_ms": time_ms(lambda: torch.gather(keys, -1, idx64)),
        "plane_ms": time_ms(lambda: gather.bounded_take_along_w(planes, idx_plane, disp)),
        "plane_torch_gather_ms": time_ms(lambda: torch.gather(planes, -1, plane64))}
    del keys, idx, planes, idx_plane, plane64, idx64
    out["polylines"] = polylines_kernel_times(dev)
    out.update(warp_distance_kernel_times(dev))
    _, deps = fixture_frames(FRAMES, HEIGHT, WIDTH)
    out["box_blend"] = box_blend_times(torch.from_numpy(deps).to(dev).float())
    bw, flops, _, _ = peaks(torch.cuda.get_device_name(dev))
    out["box_blend"]["bound_ms"] = 1e3 * max(out["box_blend"]["bytes"] / bw,
                                             out["box_blend"]["ops"] / flops)
    print(json.dumps({"kernel_times": out}), flush=True)


def warp_distance_kernel_times(dev):
    """ms per launch of the warp kernel on the left eye's rows of 12 frames
    at 1080p (phase 5's inputs), float32 colour, and of the distance kernel
    on the same depth: the entries that every tree has (offsets and nd; the
    two masks) and, where the tree has them, the fused entries (the depth)."""
    import torch
    from comfystereo_tpu_torch.kernels import distance, warp_kernel as wk
    imgs, deps = fixture_frames(FRAMES, HEIGHT, WIDTH)
    image = torch.from_numpy(imgs).to(dev).float() / 255.0
    depth255 = torch.from_numpy(deps).to(dev).float()
    off, nd, rows, kw = warp_rows_inputs(image, depth255, DIV_PCT, 0.0)
    ml, mr = edge_masks(depth255)
    out = {"warp": {"rows_ms": time_ms(lambda: wk.warp_rows(off, nd, rows, **kw))},
           "distance": {"masks_ms": time_ms(lambda: distance.edge_distances(ml, mr))}}
    if hasattr(wk, "warp_rows_fused"):
        d_rows, dmin, dmax, img, fkw = warp_fused_inputs(image, depth255, DIV_PCT, 0.0)
        out["warp"]["fused_ms"] = time_ms(lambda: wk.warp_rows_fused(d_rows, dmin, dmax, img,
                                                                     **fkw))
    if hasattr(distance, "edge_weights_fused"):
        d_rows = depth255.reshape(-1, WIDTH).contiguous()
        out["distance"]["fused_ms"] = time_ms(lambda: distance.edge_weights_fused(
            d_rows, edge_threshold=20.0, mask_radius=20, falloff=2.0, height=HEIGHT))
    return out


def polylines_kernel_times(dev):
    """ms per launch of both polylines kernels on the left eye's rows of 12
    frames at 1080p (phase 5's inputs), sharp and soft: the entries that
    take x (every tree has them) and, where the tree has them, the fused
    entries that take the offsets."""
    import torch
    from comfystereo_tpu_torch.kernels import polylines as ss, polylines_exact as ex
    imgs, deps = fixture_frames(FRAMES, HEIGHT, WIDTH)
    image255 = torch.from_numpy(imgs).to(dev).float()
    x, coord, colors, max_disp = polylines_inputs(
        image255, torch.from_numpy(deps).to(dev).float(), DIV_PCT, 0.0)
    cl = coord.abs()
    fused = hasattr(ex, "polylines_exact_rows_fused")
    out = {}
    for sharp, mode in ((True, "sharp"), (False, "soft")):
        kw = dict(sharp=sharp, max_pieces=12, max_disp=max_disp)
        skw = dict(sharp=sharp, samples=8, k_candidates=4, max_disp=max_disp)
        out[f"exact_{mode}_ms"] = time_ms(lambda: ex.polylines_exact_rows(x, cl, colors, **kw))
        out[f"supersampled_{mode}_ms"] = time_ms(
            lambda: ss.polylines_scanline(x, coord, colors, **skw))
        if fused:
            out[f"exact_fused_{mode}_ms"] = time_ms(
                lambda: ex.polylines_exact_rows_fused(coord, colors, 0.0, **kw))
            out[f"supersampled_fused_{mode}_ms"] = time_ms(
                lambda: ss.polylines_scanline_fused(coord, colors, 0.0, **skw))
    return out


# --- sharding, the backward-warp family, the dry run, the VR nodes ----------

SHARD_MODES = ("left-right", "top-bottom")
# Card against CPU tolerance of the backward-warp family's colours (their
# masks are bit-equal).
BW_ATOL = 1e-5


def _sharded_outputs_equal(got, want) -> bool:
    import torch
    return (all(torch.equal(g.gather(), w) for g, w in zip(got["stereo"], want["stereo"]))
            and all(torch.equal(got[k].gather(), want[k])
                    for k in ("mask", "left_depth", "right_depth")))


def _chunk_ms(fn) -> float:
    """ms per call by CUDA events on one card; with several cards, the host
    clock between synchronisations of all of them (a mesh's blocks run on
    every card)."""
    import torch
    if torch.cuda.device_count() == 1:
        return time_ms(fn)
    for _ in range(2):
        fn()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return (time.perf_counter() - t0) * 1e3 / 10


def phase_sharded(dev, smi: str, n: int = FRAMES, h: int = HEIGHT, w: int = WIDTH):
    """stereo_pipeline on sharded chunks at 1080p B=12: the default config
    (gpu_warp, blur on) on a "data" mesh over every local card and on a
    (2, 2) ("data", "seq") mesh on one card, packed left-right and
    top-bottom; every output bit-equal to the unsharded chunk, each kernel
    launched once per block as often as on the unsharded chunk (warp 2,
    distance 1); then naive and polylines_sharp on the (2, 2) mesh. Times
    the default chunk sharded beside unsharded, in turns."""
    import numpy as np
    import torch
    from comfystereo_tpu_torch import StereoConfig, stereo_pipeline
    from comfystereo_tpu_torch.parallel import make_mesh, shard_batch

    imgs, deps = fixture_frames(n, h, w)
    img_d = torch.from_numpy(imgs.astype(np.float32) / 255.0).to(dev)
    dep_d = torch.from_numpy(deps.astype(np.float32) / 255.0).to(dev)
    meshes = {"data x all cards": (make_mesh(axes=("data",)), False),
              "(2, 2) on cuda:0": (make_mesh(4, axes=("data", "seq"), shape=(2, 2),
                                             device="cuda:0"), True)}
    report = {}
    cases = [("gpu_warp", name) for name in meshes] + [
        (fill, "(2, 2) on cuda:0") for fill in ("naive", "polylines_sharp")]
    for fill, name in cases:
        mesh, rows = meshes[name]
        cfg = StereoConfig(fill_technique=fill, modes=SHARD_MODES)
        reset_launches()
        want = stereo_pipeline(img_d, dep_d, cfg)
        sync()
        base = read_launches()
        s_img, s_dep = shard_batch(img_d, dep_d, mesh, rows=rows)
        blocks = len(s_dep.blocks)
        reset_launches()
        got = stereo_pipeline(s_img, s_dep, cfg)
        sync()
        launches = read_launches()
        expect = {k: v * blocks for k, v in base.items()}
        if launches != expect:
            raise AssertionError(f"sharded {fill} on {name}: launches {launches}, "
                                 f"expected {expect}")
        if not _sharded_outputs_equal(got, want):
            raise AssertionError(f"sharded {fill} on {name} differs from the unsharded chunk")
        entry = {"blocks": blocks, "launches": launches, "bit_equal": True}
        if fill == "gpu_warp":
            cfg1 = StereoConfig()
            unsharded = lambda: stereo_pipeline(img_d, dep_d, cfg1)  # noqa: E731
            sharded = lambda: stereo_pipeline(s_img, s_dep, cfg1)  # noqa: E731
            turns = [_chunk_ms(f) for f in (unsharded, sharded, sharded, unsharded)]
            entry.update(unsharded_ms=[turns[0], turns[3]], sharded_ms=[turns[1], turns[2]])
            log(f"  sharded gpu_warp 1080p B={n} on {name}: {blocks} blocks, chunk "
                f"{turns[1]:.3f} / {turns[2]:.3f} ms against unsharded {turns[0]:.3f} / "
                f"{turns[3]:.3f} ms (in turns) [{smi}]")
        log(f"phase 3 sharded {fill} on {name}: {blocks} blocks, launches {launches}, "
            f"{'left-right and top-bottom, ' if rows or fill == 'gpu_warp' else ''}"
            "every output bit-equal to the unsharded chunk")
        report[f"{fill} {name}"] = entry
        del got, want, s_img, s_dep
    return report


def _backward_warp_family(image, depth255):
    """The six backward-warp functions on one chunk (the node's default
    exponent and convergence, divergence 4.5% of the width)."""
    from comfystereo_tpu_torch.device import true_divide
    from comfystereo_tpu_torch.ops import backward_warp as bw
    w = image.shape[2]
    args = (DIV_PCT / 100.0 * w, 0.0, 2.0, 0.5)
    out = {"backward_warp": bw.backward_warp(image, depth255, *args)}
    for mode in ("border", "zeros", "reflection"):
        out[f"padded {mode}"], out[f"valid {mode}"] = bw.backward_warp_padded(
            image, depth255, *args, fill_mode=mode)
    out["gap"] = bw.forward_gap_mask(depth255, *args)
    out["warp_and_fill"], _ = bw.warp_and_fill(image, depth255, *args)
    depth01 = true_divide(depth255, 255.0)
    src = bw._cols(w, depth255) - depth01 * args[0]
    out["disocclusions"] = bw.detect_disocclusions(depth01, src)
    out["interpolate_fill"] = bw.interpolate_fill(image, out["gap"])
    return out


def phase_backward_warp(dev, smi: str, n: int = FRAMES, h: int = HEIGHT, w: int = WIDTH):
    """The backward-warp family on the 1080p chunk: card against CPU on its
    first two frames (masks bit-equal, colours within BW_ATOL), and each
    function's ms per 12-frame chunk on the card."""
    import numpy as np
    import torch
    from comfystereo_tpu_torch.ops import backward_warp as bw
    imgs, deps = fixture_frames(n, h, w)
    image = torch.from_numpy(imgs.astype(np.float32) / 255.0)
    depth = torch.from_numpy(deps.astype(np.float32))
    cpu = _backward_warp_family(image[:2], depth[:2])
    img_d, dep_d = image.to(dev), depth.to(dev)
    card = _backward_warp_family(img_d[:2], dep_d[:2])
    errs = {}
    for k, want in cpu.items():
        got = card[k].cpu()
        if want.dtype == torch.bool:
            errs[k] = int((got != want).sum())
            if errs[k]:
                raise AssertionError(f"backward warp {k}: {errs[k]} mask values differ")
        else:
            errs[k] = float((got - want).abs().max())
            if errs[k] > BW_ATOL:
                raise AssertionError(f"backward warp {k}: card vs CPU {errs[k]}")
    args = (DIV_PCT / 100.0 * w, 0.0, 2.0, 0.5)
    gap = bw.forward_gap_mask(dep_d, *args)
    fns = {"backward_warp": lambda: bw.backward_warp(img_d, dep_d, *args),
           "backward_warp_padded reflection": lambda: bw.backward_warp_padded(
               img_d, dep_d, *args, fill_mode="reflection"),
           "forward_gap_mask": lambda: bw.forward_gap_mask(dep_d, *args),
           "warp_and_fill": lambda: bw.warp_and_fill(img_d, dep_d, *args),
           "interpolate_fill": lambda: bw.interpolate_fill(img_d, gap)}
    times = {k: time_ms(f, iters=5, warmup=1) for k, f in fns.items()}
    log("phase 4 backward-warp family card vs CPU on 2 frames of 1080p: " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items()) + f" (bound {BW_ATOL}, masks 0)")
    log(f"phase 5 backward-warp family ms per 1080p B={n} chunk: " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items()) + f" [{smi}]")
    return {"card_vs_cpu": errs, "ms_per_chunk": times}


def phase_dryrun_and_vr_nodes(dev, smi: str):
    """graft_entry.dryrun_multichip(4) on cuda:0, and the VR nodes on the
    card's gpu_warp output: with no headset the image node says the viewer
    is unavailable and returns its input, on the card."""
    import io
    import numpy as np
    import torch
    from comfystereo_tpu_torch import StereoConfig, graft_entry, stereo_pipeline
    from comfystereo_tpu_torch.nodes.native_nodes import (NativeStereoImageViewer,
                                                          NativeVRStatus)
    t0 = time.perf_counter()
    report = graft_entry.dryrun_multichip(4, device="cuda:0")
    log(f"phase 3 graft_entry.dryrun_multichip(4, device='cuda:0') in "
        f"{time.perf_counter() - t0:.1f} s: {report}")
    imgs, deps = fixture_frames(2, 270, 480)
    out = stereo_pipeline(torch.from_numpy(imgs.astype(np.float32) / 255.0).to(dev),
                          torch.from_numpy(deps.astype(np.float32)).to(dev),
                          StereoConfig())["stereo"][0]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        (passed,) = NativeStereoImageViewer().view_stereo_native(out)
        (status,) = NativeVRStatus().get_status()
    if passed is not out or passed.device.type != "cuda":
        raise AssertionError("the image viewer node did not return its card input")
    if "VR viewer unavailable" not in buf.getvalue() or "CUDA device:  cuda:" not in status:
        raise AssertionError(f"VR nodes: {buf.getvalue()!r}")
    cuda_line = [ln for ln in status.splitlines() if ln.startswith("CUDA device")][0]
    log(f"phase 3 VR nodes on the card's output: image node passed its input through "
        f"({passed.device}); status: {cuda_line}")
    return dict(report, vr_status_cuda=cuda_line)


# --- phase 6: the BASELINE lines at full size -------------------------------

# BASELINE.md's five lines and the headline (the Stereo Image node's defaults
# at 1080p, B=4): each line's (height, width, frames per call) and the
# pipeline configurations of one pass, as StereoConfig fields, in order.
BASELINE_SWEEP = ((2.0, 0.5), (4.5, 0.5), (4.5, 0.0), (7.0, 1.0))
BASELINE_LINES = {
    "headline": ((1080, 1920, 4), [dict(fill_technique="gpu_warp", modes=("left-right",))]),
    "1_512_naive_sbs": ((512, 512, 1), [dict(fill_technique="naive", modes=("left-right",),
                                             depth_map_blur=False)]),
    # The sweep with the exact renderer, then supersampled.
    "2_1080p_polylines_sweep": ((1080, 1920, 1), [
        dict(fill_technique="polylines_sharp", divergence=dv, convergence_point=cv,
             modes=("left-right",), depth_map_blur=True, polylines_exact=exact)
        for exact in (True, False) for dv, cv in BASELINE_SWEEP]),
    "3_720p_video_hybrid_edge_tb": ((720, 1280, 12), [dict(
        fill_technique="hybrid_edge", modes=("top-bottom",), depth_map_blur=True)]),
    "4_4k_warp_anaglyph_mask": ((2160, 3840, 1), [dict(
        fill_technique="gpu_warp", modes=("red-cyan-anaglyph",), depth_map_blur=True)]),
    "5_video2stereo_4k_all_fills": ((2160, 3840, 2), [
        dict(fill_technique=t, stereo_balance=b, modes=("left-right",), depth_map_blur=True)
        for t in ("gpu_warp",) + FILLS for b in (0.0, 0.5)]),
}
# Config 4's mask check: the left eye's gap mask with the blur off and all
# the divergence on it (balance 1, so the right eye is the copied source).
MASK_CHECK = dict(fill_technique="gpu_warp", modes=("left-only",), depth_map_blur=False,
                  stereo_balance=1.0)
# The CPU oracle (interpreted Python) runs at a reduced width: the mask check
# at ORACLE_WIDTH, and for the lines below the configurations at those
# indices (config 2's exact sweep) at that width, whose stereo pairs must
# differ from the oracle's in no uint8 value. The JAX bench's SSIM floors
# against the oracle (1 - 7e-13 and 1 - 1.6e-12) measured only the last bit
# of the pairs' /255, so no uint8 value off is the stronger check.
ORACLE_WIDTH = 512
ORACLE_PAIRS = {"1_512_naive_sbs": ((0,), 512), "2_1080p_polylines_sweep": ((0, 1, 2, 3), 256)}
# Launches of one pass of each line, one counter per configuration (config
# 2's exact and supersampled halves and config 4's mask check apart; config
# 5 its 22 fill x balance calls): a number is exact, ANY means at least one,
# and a kernel not listed must not launch. The gather fills (GATHER_FILLS)
# launch it once per pass of their sorts, so it is held to at least one.
ANY = "any"
BENCH_LAUNCHES = {
    "headline": {"warp_rows": 2, "edge_distances": 1, "box_blend": 1},
    "1_512_naive_sbs": {"bounded_take_along_w": ANY},
    "2_1080p_polylines_sweep": {"polylines_exact_rows": 8, "edge_distances": 4, "box_blend": 4},
    "2_1080p_polylines_sweep/supersampled": {"polylines_scanline": 8, "edge_distances": 4,
                                             "box_blend": 4},
    "3_720p_video_hybrid_edge_tb": {"bounded_take_along_w": ANY, "edge_distances": 1,
                                    "box_blend": 1},
    "4_4k_warp_anaglyph_mask": {"warp_rows": 2, "edge_distances": 1, "box_blend": 1},
    # balance 1: the right eye is the copied source, the left eye one warp.
    "4_4k_warp_anaglyph_mask/mask_check": {"warp_rows": 1},
    # gpu_warp 2 balances x 2 eyes; the exact polylines route for
    # polylines_sharp, polylines_soft and hybrid_edge_plus, 2 x 2 each.
    "5_video2stereo_4k_all_fills": {"warp_rows": 4, "edge_distances": 22, "box_blend": 22,
                                    "polylines_exact_rows": 12, "bounded_take_along_w": ANY},
}
# gpu_warp's colours against the plain pass: check_warp's bound on the
# fixture (the warp kernel's colours against its plain version's).
BENCH_WARP_ATOL = 1e-5


def baseline_inputs(name: str, h: int, w: int, batch: int):
    """A line's input: `batch` frames [B, H, W, 3] in 0-1 and depths [B, H,
    W] in 0-255, frame i the fixture rolled by 8 i columns (16 i in config
    5)."""
    import numpy as np
    from comfystereo_tpu_torch.utils import fixtures
    img = fixtures.create_test_image(h, w).astype(np.float32) / 255.0
    dm = fixtures.create_depth_map(h, w).astype(np.float32)
    shift = 16 if name.startswith("5_") else 8
    return (np.stack([np.roll(img, shift * i, axis=1) for i in range(batch)]),
            np.stack([np.roll(dm, shift * i, axis=1) for i in range(batch)]))


def scaled_inputs(img01, depth, width: int):
    """A frame and its depth downscaled to the oracle's width (bench.py's
    `_scaled_inputs`)."""
    import numpy as np
    from PIL import Image
    h, w = depth.shape
    nh = max(32, int(round(h * width / w)))
    im = Image.fromarray((img01 * 255).astype(np.uint8)).resize((width, nh), Image.BILINEAR)
    dm = Image.fromarray(depth.astype(np.float32), mode="F").resize((width, nh),
                                                                    Image.BILINEAR)
    return np.asarray(im, np.float32) / 255.0, np.asarray(dm, np.float32)


def oracle_sbs(img01, depth255, cfg, oracle):
    """The CPU oracle's stereo pair (first mode) of one frame, uint8 / 255
    (bench.py's `_oracle_sbs`)."""
    import numpy as np
    d = depth255
    if cfg.depth_map_blur and cfg.depth_blur_strength > 0:
        ld, rd = oracle.directional_motion_blur(
            d, cfg.depth_blur_strength, cfg.depth_blur_edge_threshold,
            cfg.depth_blur_strength, cfg.depth_blur_falloff, cfg.depth_blur_vert_smooth)
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
    axis = 0 if cfg.modes[0] == "top-bottom" else 1
    return np.concatenate([left, right], axis=axis) / 255.0


def _counted(fn, *args):
    """(fn(*args), the launches of each kernel during it)."""
    reset_launches()
    out = fn(*args)
    return out, read_launches()


def oracle_off(cfg, img01, depth, width: int, dev, oracle):
    """The port's stereo pair (first mode) of one frame downscaled to `width`,
    run on `dev`, on the host; and how many of its uint8 values differ from
    the oracle's pair of the same inputs."""
    import numpy as np
    import torch
    from comfystereo_tpu_torch import stereo_pipeline
    simg, sdm = scaled_inputs(img01, depth, width)
    out = stereo_pipeline(torch.tensor(simg[None], device=dev),
                          torch.tensor(sdm[None], device=dev), cfg)
    mine = out["stereo"][0][0].float().cpu().numpy()
    want = oracle_sbs(simg, sdm, cfg, oracle)
    return mine, int((np.round(mine * 255) != np.round(want * 255)).sum())


def mask_gaps(img01, depth, width: int, dev, oracle):
    """Config 4's mask check of one frame downscaled to `width`: the port's
    gap mask (`MASK_CHECK`, run on `dev`) as booleans on the host, and the
    oracle's z-buffer gaps of the same warp."""
    import torch
    from comfystereo_tpu_torch import StereoConfig, stereo_pipeline
    cfg = StereoConfig(**MASK_CHECK)
    simg, sdm = scaled_inputs(img01, depth, width)
    out = stereo_pipeline(torch.tensor(simg[None], device=dev),
                          torch.tensor(sdm[None], device=dev), cfg)
    divl = cfg.eye_divergences()[0] / 100.0 * simg.shape[1]
    _, gaps = oracle.forward_warp(simg, sdm, +divl, 0.0, cfg.stereo_offset_exponent,
                                  cfg.convergence_point)
    return out["mask"][0].cpu().numpy() > 0.5, gaps


def _check_bench_launches(label: str, got: dict) -> None:
    want = BENCH_LAUNCHES[label]
    for k, n in got.items():
        expect = want.get(k, 0)
        if (n < 1) if expect == ANY else (n != expect):
            raise AssertionError(f"phase 6 {label}: {k} launched {n} times, expected "
                                 f"{expect} (all: {got})")


def _check_bench_totals(name: str, total: dict) -> None:
    """Over the whole run of a line (its pass and the oracle's checks), every
    kernel its fills need launched and no other."""
    needed = {k for key, want in BENCH_LAUNCHES.items() if key.split("/")[0] == name
              for k in want}
    for k, n in total.items():
        if (n > 0) != (k in needed):
            raise AssertionError(f"phase 6 {name}: {k} launched {n} times in the whole "
                                 f"run of the line (needed: {sorted(needed)})")


def plain_call_sites():
    """(module, name, plain version) of every kernel wrapper that the
    pipeline's ops call, as each module imports it."""
    from comfystereo_tpu_torch.kernels import (box_blend, distance, gather, polylines,
                                               polylines_exact, warp_kernel)
    from comfystereo_tpu_torch.ops import blur, fills, warp
    from comfystereo_tpu_torch.ops import polylines as ops_polylines
    from comfystereo_tpu_torch.ops import polylines_exact as ops_exact

    def take(values, idx, max_disp):
        del max_disp
        return gather.bounded_take_along_w_plain(values, idx)

    return ((warp, "warp_rows_fused", warp_kernel.warp_rows_fused_plain),
            (blur, "edge_weights_fused", distance.edge_weights_plain),
            (blur, "box_blend", box_blend.box_blend_plain),
            (fills, "bounded_take_along_w", take),
            (ops_polylines, "bounded_take_along_w", take),
            (ops_polylines, "polylines_scanline_fused", polylines.polylines_scanline_fused_plain),
            (ops_exact, "polylines_exact_rows_fused",
             polylines_exact.polylines_exact_rows_fused_plain))


@contextlib.contextmanager
def plain_kernels():
    """Within it, every kernel wrapper that the pipeline's ops call is its
    plain version, on card tensors too."""
    sites = plain_call_sites()
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    try:
        for mod, name, plain in sites:
            setattr(mod, name, plain)
        yield
    finally:
        for mod, name, wrapper in saved:
            setattr(mod, name, wrapper)


def _output_leaves(out, path=""):
    if isinstance(out, dict):
        for k, v in out.items():
            yield from _output_leaves(v, f"{path}/{k}")
    elif isinstance(out, (list, tuple)):
        for i, v in enumerate(out):
            yield from _output_leaves(v, f"{path}/{i}")
    else:
        yield path, out


def check_bench_plain(label: str, cfgs, imgs, dms, dev) -> float:
    """One pass of a bench line (each configuration on the line's full-size
    input) with the kernels against the same pass with every kernel's plain
    version in its place (`plain_kernels`), on the same card tensors, one
    configuration at a time: gpu_warp's colours within BENCH_WARP_ATOL,
    every other output (masks, depths, every other fill's pair) bit-equal,
    all finite; the plain pass launches no kernel. Returns the max |err|."""
    import numpy as np
    import torch
    from comfystereo_tpu_torch.pipeline import stereo_pipeline
    x, d = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (imgs, dms))
    worst = 0.0
    for cfg in cfgs:
        got = stereo_pipeline(x, d, cfg)
        reset_launches()
        with plain_kernels():
            want = stereo_pipeline(x, d, cfg)
        sync()
        stray = {k: n for k, n in read_launches().items() if n}
        if stray:
            raise AssertionError(f"phase 6 {label}: the plain pass launched {stray}")
        tol = BENCH_WARP_ATOL if cfg.fill_technique == "gpu_warp" else 0.0
        what = (f"{cfg.fill_technique} balance {cfg.stereo_balance} div {cfg.divergence} "
                f"conv {cfg.convergence_point} exact {cfg.polylines_exact}")
        leaves, plain = list(_output_leaves(got)), list(_output_leaves(want))
        if [p for p, _ in leaves] != [p for p, _ in plain]:
            raise AssertionError(f"phase 6 {label} {what}: outputs {[p for p, _ in leaves]}, "
                                 f"plain {[p for p, _ in plain]}")
        for (path, a), (_, b) in zip(leaves, plain):
            if not isinstance(a, torch.Tensor):
                if a != b:
                    raise AssertionError(f"phase 6 {label} {what}: {path} {a!r} != {b!r}")
                continue
            if a.shape != b.shape or a.dtype != b.dtype or a.device != b.device:
                raise AssertionError(f"phase 6 {label} {what}: {path} is {a.dtype} "
                                     f"{tuple(a.shape)} on {a.device}, plain {b.dtype} "
                                     f"{tuple(b.shape)} on {b.device}")
            if a.is_floating_point() and not bool(torch.isfinite(a).all()):
                raise AssertionError(f"phase 6 {label} {what}: {path} is not finite")
            err = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
            if path.startswith("/stereo/") and err <= tol:
                worst = max(worst, err)
            elif not torch.equal(a, b):
                raise AssertionError(f"phase 6 {label} {what}: {path} differs from the plain "
                                     f"pass by up to {err} (bound {tol})")
        del got, want
    del x, d
    torch.cuda.empty_cache()
    return worst


def phase_baseline_lines(dev, smi: str) -> dict:
    """The BASELINE lines at full size on the card (4K included). Each
    line's pass runs with the launch counters set to 0 before each
    configuration, and each label's launches must be `BENCH_LAUNCHES`'.
    Configs 1 and 2 (the exact sweep) may differ from the CPU oracle's
    pair in no uint8 value at the oracle's width (`ORACLE_PAIRS`), and
    config 4's gap mask must equal the oracle's (`mask_gaps`). Over the
    line's whole run every kernel its fills need launched and no other. Then
    each line's pass is held against its plain pass on the same card tensors
    (`check_bench_plain`)."""
    import collections
    import torch
    from comfystereo_tpu_torch import StereoConfig, stereo_pipeline
    t0 = time.perf_counter()
    oracle = tests_module("oracle/stereo_oracle")
    totals, plain_errs = {}, {}
    for name, ((h, w, batch), fields) in BASELINE_LINES.items():
        cfgs = [StereoConfig(**f) for f in fields]
        imgs, dms = baseline_inputs(name, h, w, batch)
        x, d = (torch.from_numpy(a).to(dev) for a in (imgs, dms))
        launches = collections.defaultdict(collections.Counter)
        for cfg in cfgs:
            label = name if cfg.polylines_exact else name + "/supersampled"
            launches[label].update(_counted(stereo_pipeline, x, d, cfg)[1])
        del x, d
        total = collections.Counter()
        indices, width = ORACLE_PAIRS.get(name, ((), 0))
        for i in indices:
            (_, off), got = _counted(oracle_off, cfgs[i], imgs[0], dms[0], width, dev, oracle)
            total.update(got)
            if off:
                raise AssertionError(f"phase 6 {name}: {off} uint8 values of configuration "
                                     f"{i} at width {width} differ from the oracle's")
        if name.startswith("4_"):
            (mask, gaps), got = _counted(mask_gaps, imgs[0], dms[0], ORACLE_WIDTH, dev, oracle)
            launches[name + "/mask_check"].update(got)
            if (mask != gaps).any():
                raise AssertionError(f"phase 6 {name}: the gap mask differs from the oracle's "
                                     f"in {int((mask != gaps).sum())} of {gaps.size} pixels")
        for label, got in launches.items():
            _check_bench_launches(label, dict(got))
            total.update(got)
        totals[name] = dict(total)
        _check_bench_totals(name, totals[name])
        plain_errs[name] = check_bench_plain(name, cfgs, imgs, dms, dev)
    seconds = time.perf_counter() - t0
    log(f"phase 6 ok: the headline and the five BASELINE lines on {smi} in {seconds:.1f} s; "
        f"each line's pass equal to its plain pass (gpu_warp colours max |err| by line "
        f"{json.dumps(plain_errs)}); configs 1 and 2 no uint8 value off the oracle, config "
        f"4's gap mask equal to the oracle's; launches by line {json.dumps(totals)}")
    return {"seconds": round(seconds, 1), "launches": totals, "plain_max_abs_err": plain_errs}


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel-times", action="store_true",
                    help="only time the flash, gather and polylines kernels (one JSON line)")
    ap.add_argument("--root", default=HERE,
                    help="import comfystereo_tpu_torch from this directory "
                         "(default: beside chip_smoke.py)")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "comfystereo_tpu_torch")):
        print(f"chip_smoke: comfystereo_tpu_torch is not in {root}", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if args.kernel_times:
        kernel_times(dev, nvidia_smi(), root)
        return 0

    smi, name = phase_device()
    errs = phase_kernels(dev)
    contracts = phase_input_contracts(dev, smi)
    launches, _ = phase_main_path(dev)
    sharded = phase_sharded(dev, smi)
    dryrun = phase_dryrun_and_vr_nodes(dev, smi)
    backward = phase_backward_warp(dev, smi)
    ck = write_checkpoints()
    sd = phase_diffusion(dev)
    std = phase_standard(dev)
    launches["flash_attention"] = sd["launches"]["flash_attention"] + std["launches"]
    ck = phase_checkpoint(dev, ck)
    launches["flash_attention"] += ck["launches"]
    phase_card_vs_cpu(dev)
    phase_diffusion_card_vs_cpu(dev)
    std_cpu_errs = phase_standard_card_vs_cpu(dev)
    ckpt_cpu_errs = phase_checkpoint_card_vs_cpu(dev)
    kernels, pipeline = phase_times(dev, launches, errs, smi, name)
    for k in kernels:
        if k["name"] == "polylines_exact_rows":
            k["ms_by_max_pieces"] = contracts["exact_ms_by_max_pieces"]
        if k["name"] == "polylines_scanline":
            k["ms_by_k_candidates"] = contracts["supersampled_ms_by_k_candidates"]
    pipeline["other_inputs_ms"] = contracts["other_inputs_ms"]
    flash, pipeline["stereodiffusion_fast"] = diffusion_times(
        dev, sd, sd["launches"]["flash_attention"], errs["flash_max_abs_err"], smi, name)
    # launches: the Fast node's, both Standard node calls' and the loaded
    # bundles' node calls'.
    flash["launches"] = launches["flash_attention"]
    flash["backward"] = "recompute of reference_bf16 (autograd, no kernel)"
    flash["grad_max_abs_err"] = errs["flash_grad_max_abs_err"]
    flash["backward_ms"], flash["library_backward_ms"] = flash_backward_times(dev, smi)
    kernels.append(flash)
    pipeline["checkpoint"] = dict(
        checkpoint_times(dev, sd, ck, smi), w8_rel=ck["w8_rel"], w8_layers=ck["w8_layers"],
        flash_launches=ck["flash_launches"], node_first_call_s={
            "fast": ck["fast_node_s"], "standard_5_steps": ck["std_node_s"]},
        card_vs_cpu=ckpt_cpu_errs)
    release_checkpoint_models(ck)
    std_times = standard_times(dev, std, smi)
    pipeline["stereodiffusion_standard"] = dict(
        std_times, runs=std["runs"], null_text_grad=std["grad"], card_vs_cpu=std_cpu_errs)
    log(f"phase 5 ok: StereoDiffusion times on {name} ({smi})")
    pipeline["baseline_lines"] = phase_baseline_lines(dev, smi)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    pipeline["sharded"] = sharded
    pipeline["dryrun_multichip_4_cuda0"] = dryrun
    pipeline["backward_warp"] = backward
    log("pipeline " + json.dumps(pipeline))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
