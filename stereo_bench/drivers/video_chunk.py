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


def _unchanged(monkeypatch):
    """Each eye is the source, never warped or filled."""
    from comfystereo_tpu_torch import pipeline

    def eye(src, eye_d, div, sign, cfg, depth_range=None):
        gap = torch.zeros(eye_d.shape, dtype=torch.bool, device=eye_d.device)
        return src, (gap if cfg.fill_technique == "gpu_warp" else None)
    monkeypatch.setattr(pipeline, "_eye", eye)


def _half_batch(monkeypatch):
    """The chunk's second half of frames is not computed: it repeats the
    first half's results."""
    from comfystereo_tpu_torch.utils import video
    real = video.stereo_pipeline

    def half(image, depth, cfg):
        k = max(1, image.shape[0] // 2)
        out = real(image[:k], depth[:k], cfg)
        reps = -(-image.shape[0] // k)
        return {key: (tuple(torch.cat([t] * reps)[:image.shape[0]] for t in val)
                      if isinstance(val, tuple) else torch.cat([val] * reps)[:image.shape[0]])
                for key, val in out.items()}
    monkeypatch.setattr(video, "stereo_pipeline", half)


def _altered(monkeypatch):
    """One value of the packed pair moved by one step of 1/255 where the
    pipeline produces it."""
    from comfystereo_tpu_torch import pipeline
    real = pipeline._outputs

    def outputs(*a, **kw):
        out = real(*a, **kw)
        s = out["stereo"][0].clone()
        v = s.reshape(-1)
        v[7] = v[7] + 1.0 / 255 if v[7] < 0.5 else v[7] - 1.0 / 255
        out["stereo"] = (s,) + tuple(out["stereo"][1:])
        return out
    monkeypatch.setattr(pipeline, "_outputs", outputs)


# The faults of the chunk path, each planted underneath the timed call by
# `fault(monkeypatch)`: with any one of them a run has to read not correct.
FAULTS = (_unchanged, _half_batch, _altered)
