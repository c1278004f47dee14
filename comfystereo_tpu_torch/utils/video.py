"""Streaming video -> stereo conversion.

`device_chunk` is the uint8 -> uint8 chunk program: BGR -> RGB / 255, the
Rec.601 luma of the BGR depth frame, the pipeline, then trunc(clip(x * 255))
and RGB -> BGR, all on the device, a group of frames at a time. On a CUDA
device it moves both ways through page-locked host memory, and the card
copies and computes each group while the host stages the next: a group's
inputs are copied into page-locked staging and go up on an upload stream,
its pass runs on the current stream, and its result comes down on a
download stream into one page-locked tensor, which the call returns once
every group is on the host. `convert_video` streams a source video and its
depth video through it in `batch_size` chunks with three threads: a
producer decodes, the main thread runs the chunks, and a consumer feeds the
results to the encoder. Both queues hold at most 2 chunks.

Frames travel as uint8 both ways (`iter_frame_chunks(raw=True)`). By
default `iter_frame_chunks` yields float32 RGB in 0-1, or with `gray=True`
the Rec.601 luma, converted on the host by `native`, as the JAX package's
does. cv2 is optional: without it `convert_video` and `iter_frame_chunks`
raise, and `device_chunk` still runs on in-memory frames.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..config import StereoConfig
from ..device import DeviceLike, resolve_device, true_divide
from ..pipeline import stereo_pipeline
from .profiling import span

try:
    import cv2
    CV2_AVAILABLE = True
except ImportError:  # pragma: no cover
    cv2 = None
    CV2_AVAILABLE = False


def _require_cv2() -> None:
    if not CV2_AVAILABLE:
        raise RuntimeError("cv2 unavailable; video streaming disabled")


def iter_frame_chunks(video_path: str, chunk: int, gray: bool = False,
                      raw: bool = False) -> Iterator[Tuple[np.ndarray, float]]:
    """Yield ([n, H, W, 3] float32 RGB in 0-1, fps) in chunks of `chunk`
    frames; `gray=True` yields [n, H, W] Rec.601 luma in 0-1 instead (the
    node's depth-gray weights, reference GenerateStereo.py:135), and
    `raw=True` the decoder's [n, H, W, 3] BGR uint8 frames untouched."""
    _require_cv2()
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():  # cv2 treats a bad path as a 0-frame stream
        cap.release()
        raise RuntimeError(f"cannot open video: {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    if raw:
        convert = np.asarray
    else:
        convert = native.bgr_u8_to_gray_f32 if gray else native.bgr_u8_to_rgb_f32
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
            if len(frames) == chunk:
                yield convert(np.stack(frames)), fps
                frames = []
        if frames:
            yield convert(np.stack(frames)), fps
    finally:
        cap.release()


def video_fps(video_path: str) -> float:
    """Source frame rate (falls back to 30)."""
    _require_cv2()
    cap = cv2.VideoCapture(video_path)
    try:
        if not cap.isOpened():
            raise RuntimeError(f"cannot open video: {video_path}")
        return cap.get(cv2.CAP_PROP_FPS) or 30.0
    finally:
        cap.release()


# Frames through `device_chunk`, bytes of host inputs it moved to a CUDA
# device, bytes of results it brought back from one, and bytes of either
# that went through page-locked staging, since the process started; the
# last three stay 0 on the CPU. `OVERLAPPED_FRAMES` counts the frames of
# chunks that ran on a CUDA device in two or more groups, whose copies and
# kernels overlapped.
FRAMES = 0
UPLOAD_BYTES = 0
DOWNLOAD_BYTES = 0
STAGED_BYTES = 0
OVERLAPPED_FRAMES = 0

# About the most bytes of one input in a group of frames (`_groups`):
# `device_chunk` runs a chunk a group at a time, and on a CUDA device the
# host's staging of a group overlaps the card's copies and kernels of the
# group before it. 24 MiB is 4 frames of 1080p, which ran fastest of 1-12
# frames a group on an H100.
_GROUP_BYTES = 24 << 20


# The upload and download streams of each CUDA device (by index), made on
# first use: the caching allocator keeps the blocks freed on a stream for
# that stream, so every chunk reuses the same two.
_SIDE_STREAMS: Dict[int, Tuple[torch.cuda.Stream, torch.cuda.Stream]] = {}


def _side_streams(dev: torch.device) -> Tuple[torch.cuda.Stream, torch.cuda.Stream]:
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = (torch.cuda.Stream(index), torch.cuda.Stream(index))
    return _SIDE_STREAMS[index]


def _groups(n: int, nbytes: int) -> List[Tuple[int, int]]:
    """The [a, b) frame ranges that a chunk of `n` frames, whose inputs
    hold `nbytes` bytes each, runs in: as few groups of equal size as keep
    each within about `_GROUP_BYTES`, the last one shorter where `n` does
    not divide."""
    step = max(1, -(-n // max(1, -(-nbytes // _GROUP_BYTES))))
    return [(a, min(a + step, n)) for a in range(0, max(n, 1), step)]


class _HostGroups:
    """The groups of a chunk whose pass runs where its inputs are moved by
    `.to(dev)` (the CPU): each group taken in turn, the results joined at
    the end."""

    def __init__(self, dev: torch.device, inputs: Sequence[torch.Tensor]):
        self.inputs = [x.to(dev) for x in inputs]
        self.outs: List[torch.Tensor] = []

    def up(self, a: int, b: int) -> List[torch.Tensor]:
        return [x[a:b] for x in self.inputs]

    def down(self, out: torch.Tensor, a: int, b: int) -> None:
        self.outs.append(out)

    def result(self) -> torch.Tensor:
        return self.outs[0] if len(self.outs) == 1 else torch.cat(self.outs)


class _CardGroups:
    """The groups of a chunk whose pass runs on a CUDA device, the calling
    thread issuing everything. Each host input is copied into page-locked
    staging a group at a time and goes up on an upload stream; the current
    stream waits for the group, runs its pass, and a download stream takes
    its result into one page-locked host tensor. Each group's staging thus
    overlaps the copies and kernels of the groups before it. Inputs already
    on the card are used where they are.

    The caching allocators keep every buffer a side stream uses until that
    stream is done with it: the card copies of the inputs are allocated on
    the upload stream and marked as used on the current one, each group's
    result is marked as used on the download stream, and the non-blocking
    copies from and into page-locked memory mark their host blocks."""

    def __init__(self, dev: torch.device, inputs: Sequence[torch.Tensor]):
        global UPLOAD_BYTES, STAGED_BYTES
        self.compute = torch.cuda.current_stream(dev)
        self.upload, self.download = _side_streams(dev)
        self.inputs = []  # (host input, its staging, its place on the card)
        for x in inputs:
            if x.device.type != "cpu":
                self.inputs.append((x, None, x.to(dev)))
                continue
            with torch.cuda.stream(self.upload):
                on_card = torch.empty(x.shape, dtype=x.dtype, device=dev)
            on_card.record_stream(self.compute)
            self.inputs.append((x, torch.empty(x.shape, dtype=x.dtype, pin_memory=True),
                                on_card))
            UPLOAD_BYTES += x.nbytes
            STAGED_BYTES += x.nbytes
        self.n = inputs[0].shape[0]
        self.out: Optional[torch.Tensor] = None

    def up(self, a: int, b: int) -> List[torch.Tensor]:
        """Frames [a, b) of every input on the card, for the current
        stream."""
        staged = [(x, s, c) for x, s, c in self.inputs if s is not None]
        for x, s, _ in staged:
            s[a:b].copy_(x[a:b])
        if staged:
            with torch.cuda.stream(self.upload):
                for _, s, c in staged:
                    c[a:b].copy_(s[a:b], non_blocking=True)
            self.compute.wait_stream(self.upload)
        return [c[a:b] for _, _, c in self.inputs]

    def down(self, out: torch.Tensor, a: int, b: int) -> None:
        """Frames [a, b) of the result, once the current stream has made
        them, into the page-locked result."""
        if self.out is None:
            self.out = torch.empty((self.n,) + tuple(out.shape[1:]), dtype=out.dtype,
                                   pin_memory=True)
        self.download.wait_stream(self.compute)
        with torch.cuda.stream(self.download):
            self.out[a:b].copy_(out, non_blocking=True)
        out.record_stream(self.download)

    def result(self) -> torch.Tensor:
        """The page-locked result, once every group of it has arrived."""
        global DOWNLOAD_BYTES, STAGED_BYTES
        self.download.synchronize()
        DOWNLOAD_BYTES += self.out.nbytes
        STAGED_BYTES += self.out.nbytes
        return self.out


def _pass(bgr: torch.Tensor, dep: torch.Tensor, cfg: StereoConfig) -> torch.Tensor:
    """The chunk program on one group of frames, on their device: BGR uint8
    frames and BGR uint8 depth -> the first packed mode as BGR uint8."""
    with span("video.to_float"):
        img = true_divide(bgr.flip(-1).float(), 255.0)
        d = dep.float()
        gray = true_divide(0.2989 * d[..., 2] + 0.5870 * d[..., 1] + 0.1140 * d[..., 0],
                           255.0)
    sbs = stereo_pipeline(img, gray, cfg)["stereo"][0]
    with span("video.to_u8"):
        return torch.trunc(torch.clamp(sbs.float() * 255.0, 0.0, 255.0)).to(
            torch.uint8).flip(-1)


def device_chunk(bgr_u8, dep_bgr_u8, cfg: StereoConfig,
                 device: DeviceLike = None) -> torch.Tensor:
    """[B, H, W, 3] BGR uint8 frames and BGR uint8 depth frames (numpy or
    tensors) -> the first packed mode as BGR uint8, on the host. The pass
    runs on `device` in groups of frames (`_groups`); every frame is
    computed alone, so the result is the same in any grouping. On a CUDA
    device each group's staging overlaps the card's work on the groups
    before it (`_CardGroups`), and the result is in page-locked memory that
    no later call reuses while the caller holds it; the call returns once
    it has arrived."""
    global FRAMES, OVERLAPPED_FRAMES
    dev = resolve_device(device)
    with span("video.device_chunk"):
        with span("video.upload"):
            bgr, dep = torch.as_tensor(bgr_u8), torch.as_tensor(dep_bgr_u8)
            groups = _groups(bgr.shape[0], bgr.nbytes)
            chunk = (_CardGroups if dev.type == "cuda" else _HostGroups)(dev, (bgr, dep))
            group = chunk.up(*groups[0])
        FRAMES += bgr.shape[0]
        if dev.type == "cuda" and len(groups) > 1:
            OVERLAPPED_FRAMES += bgr.shape[0]
        for k, (a, b) in enumerate(groups):
            if k:
                with span("video.stage"):
                    group = chunk.up(a, b)
            chunk.down(_pass(*group, cfg), a, b)
        with span("video.download"):
            return chunk.result()


def convert_video(video_path: str, depth_video_path: str, out_path: str,
                  cfg: Optional[StereoConfig] = None, progress: bool = True,
                  device: DeviceLike = None) -> int:
    """Depth video + source video -> packed stereo video. Returns the frame
    count. A short last chunk is zero-padded to cfg.batch_size, so every
    chunk has one shape. `.avi` output is lossless FFV1, anything else mp4v.
    The main thread runs each chunk through `device_chunk`, whose result is
    already on the host, while the producer decodes the next chunks and the
    consumer encodes the last ones.
    """
    dev = resolve_device(device)
    _require_cv2()
    cfg = cfg or StereoConfig()
    fps = video_fps(video_path)

    chunk_q: "queue.Queue" = queue.Queue(maxsize=2)
    produce_error: list = []  # producer exception, re-raised after join

    def _produce():
        try:
            img_iter = iter_frame_chunks(video_path, cfg.batch_size, raw=True)
            dm_iter = iter_frame_chunks(depth_video_path, cfg.batch_size, raw=True)
            for (imgs, _), (deps, _) in zip(img_iter, dm_iter):
                chunk_q.put((imgs, deps))
        except Exception as exc:  # surfaced after join, not swallowed
            produce_error.append(exc)
        finally:
            chunk_q.put(None)

    write_q: "queue.Queue" = queue.Queue(maxsize=2)
    write_error: list = []  # consumer exception, re-raised after join
    written = [0]  # frames encoded so far
    writer_box: list = [None]  # cv2.VideoWriter, created on the first frame

    def _consume():
        try:
            while True:
                entry = write_q.get()
                if entry is None:
                    return
                out, n = entry
                arr = out.numpy()  # device_chunk's result is on the host
                for f in arr[:n]:
                    if writer_box[0] is None:
                        h, w = f.shape[:2]
                        ext = os.path.splitext(out_path)[1].lower()
                        fourcc = "FFV1" if ext == ".avi" else "mp4v"
                        writer_box[0] = cv2.VideoWriter(
                            out_path, cv2.VideoWriter_fourcc(*fourcc), fps,
                            (w, h))
                    writer_box[0].write(np.ascontiguousarray(f))
                written[0] += n
        except Exception as exc:
            write_error.append(exc)
            while write_q.get() is not None:  # drain; don't deadlock puts
                pass

    reader = threading.Thread(target=_produce, daemon=True)
    encoder = threading.Thread(target=_consume, daemon=True)
    reader.start()
    encoder.start()

    def pad_to_batch(x):
        if len(x) == cfg.batch_size:
            return x
        reps = np.zeros((cfg.batch_size - len(x),) + x.shape[1:], x.dtype)
        return np.concatenate([x, reps], axis=0)

    total = 0
    try:
        while True:
            item = chunk_q.get()
            if item is None:
                break
            imgs, deps = item
            n = min(len(imgs), len(deps))
            out = device_chunk(pad_to_batch(imgs[:n]), pad_to_batch(deps[:n]),
                               cfg, device=dev)
            write_q.put((out, n))
            total += n
            if progress:
                print(f"\rconverted {written[0]} frames", end="", flush=True)
    finally:
        while reader.is_alive():  # unblock a producer waiting on a full queue
            try:
                chunk_q.get(timeout=0.1)
            except queue.Empty:
                pass
        reader.join()
        write_q.put(None)
        encoder.join()
        if writer_box[0] is not None:
            writer_box[0].release()
    if produce_error:
        raise RuntimeError(
            f"video decode failed after {written[0]} frames"
        ) from produce_error[0]
    if write_error:
        raise RuntimeError(
            f"video encode failed after {written[0]} frames"
        ) from write_error[0]
    if progress:
        print(f"\rconverted {written[0]} frames")
    return total
