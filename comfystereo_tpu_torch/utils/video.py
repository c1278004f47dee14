"""Streaming video -> stereo conversion.

`device_chunk` is the uint8 -> uint8 chunk program: BGR -> RGB / 255, the
Rec.601 luma of the BGR depth frame, the pipeline, then trunc(clip(x * 255))
and RGB -> BGR, all on the device. `convert_video` streams a source video
and its depth video through it in `batch_size` chunks with three threads:
a producer decodes, the main thread enqueues device work, and a consumer
copies results back and feeds the encoder. Both queues hold at most 2 chunks.

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


# Frames through `device_chunk`, and bytes of host inputs it moved to a CUDA
# device (0 on the CPU), since the process started.
FRAMES = 0
UPLOAD_BYTES = 0


def device_chunk(bgr_u8, dep_bgr_u8, cfg: StereoConfig,
                 device: DeviceLike = None) -> torch.Tensor:
    """[B, H, W, 3] BGR uint8 frames and BGR uint8 depth frames (numpy or
    tensors) -> the first packed mode as BGR uint8, on `device`."""
    global FRAMES, UPLOAD_BYTES
    dev = resolve_device(device)
    with span("video.device_chunk"):
        with span("video.upload"):
            bgr = torch.as_tensor(bgr_u8)
            dep = torch.as_tensor(dep_bgr_u8)
            if dev.type == "cuda":
                UPLOAD_BYTES += sum(t.nbytes for t in (bgr, dep) if t.device.type == "cpu")
            bgr, dep = bgr.to(dev), dep.to(dev)
        FRAMES += bgr.shape[0]
        with span("video.to_float"):
            img = true_divide(bgr.flip(-1).float(), 255.0)
            d = dep.float()
            gray = true_divide(0.2989 * d[..., 2] + 0.5870 * d[..., 1] + 0.1140 * d[..., 0],
                               255.0)
        sbs = stereo_pipeline(img, gray, cfg)["stereo"][0]
        with span("video.to_u8"):
            return torch.trunc(torch.clamp(sbs.float() * 255.0, 0.0, 255.0)).to(
                torch.uint8).flip(-1)


def convert_video(video_path: str, depth_video_path: str, out_path: str,
                  cfg: Optional[StereoConfig] = None, progress: bool = True,
                  device: DeviceLike = None) -> int:
    """Depth video + source video -> packed stereo video. Returns the frame
    count. A short last chunk is zero-padded to cfg.batch_size, so every
    chunk has one shape. `.avi` output is lossless FFV1, anything else mp4v.
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
                out_dev, n = entry
                arr = out_dev.cpu().numpy()  # d2h; blocks this thread only
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
