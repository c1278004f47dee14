"""Streaming video -> stereo conversion.

`device_chunk` is the uint8 -> uint8 chunk program: BGR -> RGB / 255, the
Rec.601 luma of the BGR depth frame, the pipeline, then trunc(clip(x * 255))
and RGB -> BGR, all on the device. On a CUDA device it moves both ways
through page-locked host memory: the host inputs are copied into it a group
of frames at a time, each group going up while the next is copied, and the
result comes back into a page-locked tensor of its own, which it returns
once it is on the host. `convert_video` streams a source video and its
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
from typing import Iterator, Optional, Tuple

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
# last three stay 0 on the CPU.
FRAMES = 0
UPLOAD_BYTES = 0
DOWNLOAD_BYTES = 0
STAGED_BYTES = 0

# The size of one staged group of frames: the host copy of a group into
# page-locked memory overlaps the DMA of the group before it.
_GROUP_BYTES = 24 << 20


def _upload(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """`x` on `dev`. A host tensor bound for a CUDA device is staged in
    page-locked memory a group of frames at a time, each group going up
    without blocking the host; its copy is done before the stream's later
    work."""
    global UPLOAD_BYTES, STAGED_BYTES
    if dev.type != "cuda" or x.device.type != "cpu":
        return x.to(dev)
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    staged = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    n = x.shape[0]
    groups = max(1, -(-x.nbytes // _GROUP_BYTES))
    step = max(1, -(-n // groups))
    for a in range(0, n, step):
        staged[a:a + step].copy_(x[a:a + step])
        out[a:a + step].copy_(staged[a:a + step], non_blocking=True)
    UPLOAD_BYTES += x.nbytes
    STAGED_BYTES += x.nbytes
    return out


def _download(x: torch.Tensor) -> torch.Tensor:
    """`x` on the host: a CUDA tensor in a page-locked host tensor of its
    own, once the copy is done. The blocking copy is a DMA and a wait for
    the stream, as a non-blocking copy and a stream wait would be, but it
    leaves the block unmarked by the stream: the caching host allocator can
    hand it out again as soon as the caller frees it, not only once the
    work queued by then is done."""
    global DOWNLOAD_BYTES, STAGED_BYTES
    if x.device.type != "cuda":
        return x
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    DOWNLOAD_BYTES += out.nbytes
    STAGED_BYTES += out.nbytes
    return out


def device_chunk(bgr_u8, dep_bgr_u8, cfg: StereoConfig,
                 device: DeviceLike = None) -> torch.Tensor:
    """[B, H, W, 3] BGR uint8 frames and BGR uint8 depth frames (numpy or
    tensors) -> the first packed mode as BGR uint8, on the host. The pass
    runs on `device`; on a CUDA device the result is in page-locked memory
    that no later call reuses while the caller holds it, and the call
    returns once it has arrived."""
    global FRAMES
    dev = resolve_device(device)
    with span("video.device_chunk"):
        with span("video.upload"):
            bgr = _upload(torch.as_tensor(bgr_u8), dev)
            dep = _upload(torch.as_tensor(dep_bgr_u8), dev)
        FRAMES += bgr.shape[0]
        with span("video.to_float"):
            img = true_divide(bgr.flip(-1).float(), 255.0)
            d = dep.float()
            gray = true_divide(0.2989 * d[..., 2] + 0.5870 * d[..., 1] + 0.1140 * d[..., 0],
                               255.0)
        sbs = stereo_pipeline(img, gray, cfg)["stereo"][0]
        with span("video.to_u8"):
            out = torch.trunc(torch.clamp(sbs.float() * 255.0, 0.0, 255.0)).to(
                torch.uint8).flip(-1)
        with span("video.download"):
            return _download(out)


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
