"""Tracing, timing, and memory observability.

The reference's only instrumentation is an ad-hoc psutil/VRAM logger behind
a DEBUG_MEMORY flag (GenerateStereo.py:8-23). The port's equivalents keep
the JAX package's names and contract: `sync` fences the devices a tree of
tensors lives on (PyTorch returns before the card finishes), `stage_timer`
times a stage with CUDA events when it is given a card tensor or device and
with the host clock otherwise, `trace` records a `torch.profiler` trace with
CUDA activity where there is a GPU, and `memory_stats` reports host RSS and
the caching allocator's current and peak bytes per initialised CUDA device.

`span(name)` marks a stage of the port for a profiler: while a
`torch.profiler` records, it is `torch.profiler.record_function(name)`, a
`user_annotation` event in the same Chrome trace and on the same clock as
the device's kernels and copies; otherwise it is one shared no-op. The
check costs about 0.1 us, where `record_function` costs 12-15 us a span on
an x86 host even with no profiler running. An operator records the spans beside the kernels with
`with profiling.trace(dir): convert_video(...)`, or around a node call. The
chunk path's spans, from the entry down:

- `video.device_chunk` (`utils/video.py:device_chunk`, which runs the
  chunk a group of frames at a time), and in it `video.upload` (the first
  group's host arrays to the device, through page-locked staging on a
  card: the card's wait for its first input), `video.stage` (each later
  group's staging and copy to the device, which the card's work on the
  groups before it overlaps), per group `video.to_float` (BGR -> RGB / 255
  and the depth's luma) and `video.to_u8` (trunc(clamp(x * 255)) as uint8
  BGR), and `video.download` (the wait until every group's result is in
  page-locked host memory; on the CPU, the groups' results joined);
- `pipeline.stereo_pipeline` (the pass), and in it `pipeline.depth255`,
  `pipeline.eye_source`, `pipeline.eye` (one eye: the warp or the fill),
  `pipeline.pack` (`pack_mode` and its clamp or divide), `pipeline.mask`
  and `pipeline.depth_outputs`;
- `blur.directional` (`ops/blur.py:directional_motion_blur`), and in it
  `blur.edge_weights` (the edge-distance kernel) and `blur.box_w` (the
  box-blend kernel: the weights' vertical box means and clamps, the depth's
  horizontal box mean and both blends; before the kernel, the blur's
  `blur.box_h` and `blur.blend` spans held the first and the last of these).

The Stereo Diffusion node's Fast path: `node.stereo_diffusion` (the node
call), and in it `diffusion.warp_inpaint`, which holds `diffusion.warp`,
with an SDXL bundle `diffusion.add_cond` (its pooled embeddings and time
ids), `diffusion.vae_encode` (twice), `diffusion.unet` and
`diffusion.scheduler` (once a step each), `diffusion.vae_decode` and
`diffusion.composite` (`diffusion/sd_pipeline.py`, which counts `FRAMES`,
`UNET_CALLS`, `UNET_ROWS` and the `ADDED_COND_CALLS` that carried SDXL's
text-time conditioning). `diffusion/sd_unet.py` counts the `UNET_GRAPH_CAPTURES` of the
UNet's forward as CUDA graphs and the `UNET_GRAPH_CALLS` that a graph's
replay served (`GraphedUNet`, a bundle's `unet_apply`); on a card a
`diffusion.unet` span then holds the input copies and one
`cudaGraphLaunch`, and the profiler gives the graph's kernels that call's
correlation id.

`utils/video.py` counts `FRAMES` through `device_chunk`, the
`UPLOAD_BYTES` it moves to a CUDA device, the `DOWNLOAD_BYTES` it brings
back from one, the `STAGED_BYTES` of either that go through page-locked
memory, and the `OVERLAPPED_FRAMES` of chunks that ran on a CUDA device in
two or more groups.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, Optional, Set

import torch

DEBUG_MEMORY = os.environ.get("COMFYSTEREO_DEBUG_MEMORY", "0") == "1"

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that records `name` as a span while a
    `torch.profiler` records, and the shared no-op otherwise."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _devices(tree, out: Set[torch.device]) -> Set[torch.device]:
    """The devices of every tensor in a tree of dicts, lists, tuples and
    objects that hold tensors in `blocks` (the sharded tensors)."""
    if isinstance(tree, torch.Tensor):
        out.add(tree.device)
    elif isinstance(tree, torch.device):
        out.add(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _devices(v, out)
    elif hasattr(tree, "blocks"):
        _devices(list(tree.blocks.values()), out)
    return out


def sync(tree) -> None:
    """Wait until the work that produces every tensor of `tree` is done:
    `torch.cuda.synchronize` on each CUDA device the tree holds; nothing for
    CPU tensors."""
    for dev in _devices(tree, set()):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _cuda_device(tree) -> Optional[torch.device]:
    cuda = sorted((d for d in _devices(tree, set()) if d.type == "cuda"), key=str)
    return cuda[0] if cuda else None


@contextlib.contextmanager
def stage_timer(name: str, results: Optional[Dict[str, float]] = None,
                verbose: bool = True, device=None):
    """Time a pipeline stage in seconds. `device` (a device, a tensor or a
    tree of tensors) on the card times the stage with CUDA events on that
    device's current stream, synchronised at the end; otherwise the host
    clock times it, and the caller fences its outputs with `sync()` inside."""
    dev = _cuda_device(device) if device is not None else None
    if dev is not None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        yield
        end.record(torch.cuda.current_stream(dev))
        end.synchronize()
        dt = start.elapsed_time(end) / 1000.0
    else:
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
    if results is not None:
        results[name] = dt
    if verbose:
        print(f"[timing] {name}: {dt * 1000:.2f} ms")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A `torch.profiler` trace (CPU, and CUDA where there is a GPU) of the
    block, written to `log_dir/trace.json` (Chrome trace format) when it
    ends; yields `log_dir`. The default directory is under the temporary
    directory."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "comfystereo_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def memory_stats() -> Dict[str, float]:
    """Host RSS, and for each CUDA device this process has initialised the
    caching allocator's current and peak bytes (`allocated_bytes.all.current`
    and `.peak`), in MB, under the JAX package's key pattern
    `cuda{i}_in_use_mb`, `cuda{i}_peak_mb`."""
    stats: Dict[str, float] = {}
    try:
        import psutil

        stats["host_rss_mb"] = psutil.Process().memory_info().rss / 2 ** 20
    except ImportError:
        import resource

        stats["host_rss_mb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            ms = torch.cuda.memory_stats(i)
            if "allocated_bytes.all.current" in ms:
                stats[f"cuda{i}_in_use_mb"] = ms["allocated_bytes.all.current"] / 2 ** 20
                stats[f"cuda{i}_peak_mb"] = ms["allocated_bytes.all.peak"] / 2 ** 20
    return stats


def log_memory(label: str = "") -> None:
    """DEBUG_MEMORY-gated memory print (reference log_memory behaviour)."""
    if not DEBUG_MEMORY:
        return
    stats = memory_stats()
    pretty = ", ".join(f"{k}={v:.0f}MB" for k, v in stats.items())
    print(f"[MEM] {label}: {pretty}")
