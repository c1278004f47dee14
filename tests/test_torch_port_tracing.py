"""The port's spans and counters on the CPU: `utils.profiling.span` is a
shared no-op without a profiler; under one, `device_chunk` records the
chunk path's span tree, every op lies inside a span, and the outputs are
those of an untraced chunk; `utils.video` counts frames and the bytes it
moves to and from a card (none here), and on the CPU returns what the chunk
program computes, with no staging."""
import contextlib
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from comfystereo_tpu_torch.config import StereoConfig
from comfystereo_tpu_torch.device import true_divide
from comfystereo_tpu_torch.pipeline import stereo_pipeline
from comfystereo_tpu_torch.utils import profiling, video

B, H, W = 2, 16, 32
# The benchmark's two configurations, built as its chunk driver builds them.
CONFIGS = ["gpu_warp_default", "polylines_sharp"]
CONFIG_DIR = Path(__file__).resolve().parent.parent / "stereo_bench" / "configs"
# Spans that hold other spans; an op directly inside one is a view or a cast
# to the dtype the tensor already has.
CONTAINERS = {"video.device_chunk", "pipeline.stereo_pipeline", "blur.directional"}
NO_COPY = {"aten::to", "aten::reshape", "aten::view"}


def _leaves(*names):
    return tuple((n, ()) for n in names)


# One group's pass, as the chunk runs it.
PASS = (*_leaves("video.to_float"),
        ("pipeline.stereo_pipeline", (
            *_leaves("pipeline.depth255"),
            ("blur.directional", _leaves("blur.edge_weights", "blur.box_w")),
            *_leaves("pipeline.eye_source", "pipeline.eye", "pipeline.eye", "pipeline.pack",
                     "pipeline.mask", "pipeline.depth_outputs"))),
        *_leaves("video.to_u8"))
CHUNK_TREE = ("video.device_chunk", (*_leaves("video.upload"), *PASS,
                                     *_leaves("video.download")))


def _grouped_tree(groups: int):
    """The span tree of a chunk run in `groups` groups: the first group's
    upload, each later group's staging, a pass per group, one download."""
    later = tuple(x for _ in range(groups - 1) for x in (*_leaves("video.stage"), *PASS))
    return ("video.device_chunk", (*_leaves("video.upload"), *PASS, *later,
                                   *_leaves("video.download")))


def _config(name: str) -> StereoConfig:
    settings = json.loads((CONFIG_DIR / f"{name}.json").read_text())["settings"]
    kw = {k: v for k, v in settings.items() if k not in ("fill_technique", "modes")}
    cfg = StereoConfig.from_ui(settings["fill_technique"], modes=(settings["modes"],), **kw)
    return dataclasses.replace(cfg, batch_size=B)


def _chunk(seed: int = 0, b: int = B):
    rng = np.random.default_rng(seed)
    bgr = rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8)
    dep = np.repeat(rng.integers(0, 256, (b, H, W, 1), dtype=np.uint8), 3, axis=-1)
    return bgr, dep


# A chunk of 5 frames run in groups of at most `frames` frames each: groups
# (0, 3), (3, 5), or (0, 2), (2, 4), (4, 5).
GROUPED = [(3, 2), (2, 3)]  # (frames a group may hold, groups)
N_GROUPED = 5


def _group_frames(monkeypatch, frames: int) -> None:
    """Groups of at most `frames` of the test's frames."""
    monkeypatch.setattr(video, "_GROUP_BYTES", frames * H * W * 3)


def _traced(fn, tmp_path):
    """fn's result and the complete events of a CPU profile around it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [e for e in events if e.get("ph") == "X"]


def _spans(events):
    return sorted((e for e in events if e.get("cat") == "user_annotation"),
                  key=lambda e: (e["ts"], -e["dur"]))


def _inside(e, s) -> bool:
    return s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]


def _tree(events):
    """The spans as nested (name, children) tuples, by containment."""
    top = []
    stack = [({"ts": -1e30, "dur": float("inf")}, top)]
    for s in _spans(events):
        while not _inside(s, stack[-1][0]):
            stack.pop()
        kids = []
        stack[-1][1].append((s["name"], kids))
        stack.append((s, kids))

    def freeze(nodes):
        return tuple((name, freeze(kids)) for name, kids in nodes)

    return freeze(top)


def test_span_is_the_shared_no_op_without_a_profiler(tmp_path):
    assert not torch._C._autograd._profiler_enabled()
    off = profiling.span("a")
    assert off is profiling.span("b")
    assert isinstance(off, contextlib.nullcontext)

    def run():
        with off:  # taken while no profiler ran: records nothing
            torch.ones(2).add_(1)
        with profiling.span("recorded"):
            torch.ones(2).add_(1)

    _, events = _traced(run, tmp_path)
    assert [s["name"] for s in _spans(events)] == ["recorded"]


@pytest.mark.parametrize("name", CONFIGS)
def test_chunk_records_the_span_tree(name, tmp_path):
    cfg = _config(name)
    bgr, dep = _chunk()

    def two_chunks():
        return [video.device_chunk(bgr, dep, cfg, device="cpu") for _ in range(2)]

    _, events = _traced(two_chunks, tmp_path)
    assert _tree(events) == (CHUNK_TREE, CHUNK_TREE)


@pytest.mark.parametrize("name", CONFIGS)
def test_every_op_of_the_chunk_lies_in_a_span(name, tmp_path):
    """Every aten op lies inside a program span, and the ops directly inside
    a span that holds others compute nothing (views and no-op casts)."""
    cfg = _config(name)
    bgr, dep = _chunk(1)
    _, events = _traced(lambda: video.device_chunk(bgr, dep, cfg, device="cpu"), tmp_path)
    spans = _spans(events)
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    assert ops
    for op in ops:
        holders = [s for s in spans if _inside(op, s)]
        assert holders, op["name"]
        innermost = max(holders, key=lambda s: s["ts"])["name"]
        assert innermost not in CONTAINERS or op["name"] in NO_COPY, (innermost, op["name"])


@pytest.mark.parametrize("name", CONFIGS)
def test_outputs_are_the_same_traced_and_untraced(name, tmp_path):
    cfg = _config(name)
    bgr, dep = _chunk(2)
    plain = video.device_chunk(bgr, dep, cfg, device="cpu")
    traced, _ = _traced(lambda: video.device_chunk(bgr, dep, cfg, device="cpu"), tmp_path)
    assert traced.dtype == torch.uint8 and torch.equal(traced, plain)


def test_counters_count_frames_and_no_upload_on_the_cpu():
    cfg = _config("gpu_warp_default")
    bgr, dep = _chunk(3)
    frames, nbytes = video.FRAMES, video.UPLOAD_BYTES
    video.device_chunk(bgr, dep, cfg, device="cpu")
    assert video.FRAMES == frames + B
    video.device_chunk(torch.from_numpy(bgr), torch.from_numpy(dep), cfg, device="cpu")
    assert video.FRAMES == frames + 2 * B
    assert video.UPLOAD_BYTES == nbytes


def _chunk_program(bgr, dep, cfg):
    """The chunk program written out: BGR -> RGB / 255, the depth's luma,
    the pass, trunc(clamp(x * 255)) as uint8 BGR."""
    img = true_divide(torch.from_numpy(bgr).flip(-1).float(), 255.0)
    d = torch.from_numpy(dep).float()
    gray = true_divide(0.2989 * d[..., 2] + 0.5870 * d[..., 1] + 0.1140 * d[..., 0], 255.0)
    sbs = stereo_pipeline(img, gray, cfg)["stereo"][0]
    return torch.trunc(torch.clamp(sbs.float() * 255.0, 0.0, 255.0)).to(torch.uint8).flip(-1)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("name", CONFIGS)
def test_cpu_chunk_is_the_chunk_program_with_no_staging(name, as_tensor):
    """On the CPU the result is the chunk program's, bit for bit, in memory
    that is not page-locked, and only `FRAMES` moves."""
    cfg = _config(name)
    bgr, dep = _chunk(4)
    args = (torch.from_numpy(bgr), torch.from_numpy(dep)) if as_tensor else (bgr, dep)
    before = (video.UPLOAD_BYTES, video.DOWNLOAD_BYTES, video.STAGED_BYTES)
    frames = video.FRAMES
    out = video.device_chunk(*args, cfg, device="cpu")
    assert out.device.type == "cpu" and out.dtype == torch.uint8 and not out.is_pinned()
    assert torch.equal(out, _chunk_program(bgr, dep, cfg))
    assert video.FRAMES == frames + B
    assert (video.UPLOAD_BYTES, video.DOWNLOAD_BYTES, video.STAGED_BYTES) == before


@pytest.mark.parametrize("n,nbytes,want", [
    (12, 12 * 1080 * 1920 * 3, [(0, 4), (4, 8), (8, 12)]),
    (7, 7 * 1080 * 1920 * 3, [(0, 4), (4, 7)]),
    (4, 4 * 1080 * 1920 * 3, [(0, 4)]),
    (1, 2160 * 3840 * 3, [(0, 1)]),
    (B, B * H * W * 3, [(0, B)]),
    (0, 0, [(0, 0)]),
])
def test_chunk_groups(n, nbytes, want):
    """Groups of equal size, each input's within about `_GROUP_BYTES`, the
    last one shorter where the frames do not divide; a frame is never
    split."""
    assert video._groups(n, nbytes) == want


@pytest.mark.parametrize("frames,groups", GROUPED)
@pytest.mark.parametrize("name", CONFIGS)
def test_grouped_chunk_records_the_span_tree(name, frames, groups, monkeypatch, tmp_path):
    """A chunk run in groups records `video.upload` and `video.download`
    once, `video.stage` for each later group, and a pass per group."""
    cfg = _config(name)
    bgr, dep = _chunk(5, N_GROUPED)
    _group_frames(monkeypatch, frames)
    assert len(video._groups(N_GROUPED, bgr.nbytes)) == groups
    _, events = _traced(lambda: video.device_chunk(bgr, dep, cfg, device="cpu"), tmp_path)
    assert _tree(events) == (_grouped_tree(groups),)


@pytest.mark.parametrize("name", CONFIGS)
def test_every_op_of_a_grouped_chunk_lies_in_a_span(name, monkeypatch, tmp_path):
    """As for one group: every aten op lies in a program span, and none that
    computes lies directly in one that holds others."""
    cfg = _config(name)
    bgr, dep = _chunk(6, N_GROUPED)
    _group_frames(monkeypatch, 2)
    _, events = _traced(lambda: video.device_chunk(bgr, dep, cfg, device="cpu"), tmp_path)
    spans = _spans(events)
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    assert ops
    for op in ops:
        holders = [s for s in spans if _inside(op, s)]
        assert holders, op["name"]
        innermost = max(holders, key=lambda s: s["ts"])["name"]
        assert innermost not in CONTAINERS or op["name"] in NO_COPY, (innermost, op["name"])


@pytest.mark.parametrize("frames,groups", GROUPED)
@pytest.mark.parametrize("name", CONFIGS)
def test_grouped_cpu_chunk_is_the_chunk_program(name, frames, groups, monkeypatch):
    """In groups the CPU's result is the whole chunk program's bit for bit,
    `FRAMES` grows by the chunk's frames, and no byte or overlapped frame
    is counted: only a CUDA device overlaps."""
    cfg = _config(name)
    bgr, dep = _chunk(7, N_GROUPED)
    _group_frames(monkeypatch, frames)
    counters = ("UPLOAD_BYTES", "DOWNLOAD_BYTES", "STAGED_BYTES", "OVERLAPPED_FRAMES")
    before = [getattr(video, c) for c in counters]
    frames_before = video.FRAMES
    out = video.device_chunk(bgr, dep, cfg, device="cpu")
    assert out.dtype == torch.uint8 and out.shape == (N_GROUPED, H, 2 * W, 3)
    assert torch.equal(out, _chunk_program(bgr, dep, cfg))
    assert video.FRAMES == frames_before + N_GROUPED
    assert [getattr(video, c) for c in counters] == before
