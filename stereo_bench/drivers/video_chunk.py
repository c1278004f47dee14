"""The chunk program that `convert_video` runs, without the codec:
`comfystereo_tpu_torch.utils.video.device_chunk` on `frames_per_call`
frames of BGR uint8 and their BGR uint8 grey depth, as pageable numpy
arrays, submitted on the caller's thread. `device_chunk` returns the
packed pair on the host, in page-locked memory, once its download has
arrived; `collect` takes it as a numpy array (`.cpu().numpy()`, which
copies nothing for a host tensor), and the harness runs it on a second
thread behind a queue of the mix's `in_flight` places, as
`convert_video`'s encoder thread does behind its `write_q`. Compared: the
share of the output's uint8 values that differ from the reference's, and
the largest difference in steps of one."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from stereo_bench import scenes
from stereo_bench.reference import plain

# The mix's sizes in the harness's own tests on the CPU.
TINY = dict(height=24, width=48, frames_per_call=3, distinct=6, check_among=4, trace_calls=3)


def inputs(traffic: Dict, seed: int) -> List:
    """The mix's distinct chunks: `distinct` frames of one panned scene,
    cut into chunks of `frames_per_call`."""
    b = traffic["frames_per_call"]
    bgr, dep = scenes.video(seed, traffic["distinct"], traffic["height"], traffic["width"],
                            tuple(traffic["pan"]))
    return [(np.ascontiguousarray(bgr[k:k + b]), np.ascontiguousarray(dep[k:k + b]))
            for k in range(0, len(bgr), b)]


def _config(settings: Dict, **extra):
    from comfystereo_tpu_torch.config import StereoConfig
    kw = {k: v for k, v in settings.items() if k not in ("fill_technique", "modes")}
    return dataclasses.replace(
        StereoConfig.from_ui(settings["fill_technique"], modes=(settings["modes"],), **kw),
        **extra)


def program(settings: Dict, device) -> Callable:
    """The timed call's first half: the chunk through `device_chunk`, which
    returns its packed pair on the host."""
    from comfystereo_tpu_torch.utils.video import device_chunk
    cfg = _config(settings)
    return lambda inp: device_chunk(inp[0], inp[1], cfg, device=device)


def collect(out: torch.Tensor) -> np.ndarray:
    """The timed call's second half: the packed pair, already on the host,
    as a numpy array; no copy."""
    return out.cpu().numpy()


def control(settings: Dict, kind: str, device) -> Callable:
    """`program:color_dtype=bfloat16`: the program's own bfloat16 colour
    path; `reference:depth=bfloat16`: the reference with its depth and blur
    in bfloat16."""
    if kind == "program:color_dtype=bfloat16":
        from comfystereo_tpu_torch.utils.video import device_chunk
        cfg = _config(settings, color_dtype="bfloat16")
        return lambda inp: device_chunk(inp[0], inp[1], cfg, device=device)
    if kind == "reference:depth=bfloat16":
        return lambda inp: torch.from_numpy(
            plain.video_chunk(inp[0], inp[1], settings, device, torch.bfloat16))
    raise ValueError(f"unknown control {kind!r}")


def reference(settings: Dict, inp, device, frames: List[int]):
    """The reference's output for the chunk's `frames`."""
    return plain.video_chunk(inp[0], inp[1], settings, device, frames=frames)


def select(out: np.ndarray, frames: List[int]) -> np.ndarray:
    return out[frames]


def compare(out: np.ndarray, exp: np.ndarray) -> Dict[str, float]:
    if out.shape != exp.shape or out.dtype != exp.dtype:
        return {"u8_off_share": 1.0, "u8_max_off": 255.0}
    diff = np.abs(out.astype(np.int16) - exp.astype(np.int16))
    return {"u8_off_share": float(np.count_nonzero(diff)) / diff.size,
            "u8_max_off": float(diff.max())}
