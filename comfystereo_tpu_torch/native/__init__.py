"""Native (C++) host-side pixel conversions, loaded via ctypes.

The port's video loop converts its chunks on the GPU (`utils/video.py:
device_chunk`). These conversions serve host-side callers that hold numpy
frames (pixel marshalling around cv2 decode and encode, reference
GenerateStereo.py:131-171), among them `utils/video.py:iter_frame_chunks`
outside its raw mode: `hostops.cpp`, the package's own copy of the
source, partitions the pixels over std::thread workers.

Build model: `g++ -O3 -shared` at first use into `build/hostops/` at the
repository root (beside the CUDA kernels' `build/torch_kernels/`), named by
a hash of the source, so an edited source is rebuilt and a current library
is loaded as it is. Everything degrades to numpy when no compiler is
available, so the package never hard-requires the native build: this is a
host-side convenience, not a device kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "hostops.cpp"
BUILD_DIR = _SRC.parent.parent.parent / "build" / "hostops"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

DEFAULT_THREADS = min(16, os.cpu_count() or 1)


def _build() -> Optional[Path]:
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None or not _SRC.exists():
        return None
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so_path = BUILD_DIR / f"hostops_{tag}.so"
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_name(so_path.name + f".tmp{os.getpid()}")
    cmd = [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", str(_SRC),
           "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)  # atomic against concurrent builders
        return so_path
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        for name, args in (
                ("bgr_u8_to_rgb_f32", (u8p, f32p)),
                ("rgb_f32_to_bgr_u8", (f32p, u8p)),
                ("bgr_u8_to_gray_f32", (u8p, f32p))):
            fn = getattr(lib, name)
            fn.argtypes = [args[0], args[1], ctypes.c_int64, ctypes.c_int]
            fn.restype = None
        _LIB = lib
        return _LIB


def available() -> bool:
    """True when the native library built (or was built before) and loaded."""
    return _load() is not None


def _c(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def bgr_u8_to_rgb_f32(bgr: np.ndarray, threads: int = DEFAULT_THREADS) -> np.ndarray:
    """[..., 3] uint8 BGR -> [..., 3] float32 RGB in [0, 1]."""
    lib = _load()
    if lib is None:
        return bgr[..., ::-1].astype(np.float32) / 255.0
    bgr = np.ascontiguousarray(bgr, np.uint8)
    out = np.empty(bgr.shape, np.float32)
    lib.bgr_u8_to_rgb_f32(_c(bgr, ctypes.c_uint8), _c(out, ctypes.c_float),
                          bgr.size // 3, int(threads))
    return out


def rgb_f32_to_bgr_u8(rgb: np.ndarray, threads: int = DEFAULT_THREADS) -> np.ndarray:
    """[..., 3] float32 RGB (0-1) -> [..., 3] uint8 BGR; numpy-cast
    semantics (scale by 255, clamp, truncate)."""
    lib = _load()
    if lib is None:
        return np.ascontiguousarray(
            np.clip(rgb * 255.0, 0, 255).astype(np.uint8)[..., ::-1])
    rgb = np.ascontiguousarray(rgb, np.float32)
    out = np.empty(rgb.shape, np.uint8)
    lib.rgb_f32_to_bgr_u8(_c(rgb, ctypes.c_float), _c(out, ctypes.c_uint8),
                          rgb.size // 3, int(threads))
    return out


def bgr_u8_to_gray_f32(bgr: np.ndarray, threads: int = DEFAULT_THREADS) -> np.ndarray:
    """[..., 3] uint8 BGR -> [...] float32 Rec.601 luma in [0, 1]
    (the node's depth-grayscale weights, reference GenerateStereo.py:135)."""
    lib = _load()
    if lib is None:
        b = bgr.astype(np.float32)
        return (0.2989 * b[..., 2] + 0.5870 * b[..., 1] + 0.1140 * b[..., 0]) / 255.0
    bgr = np.ascontiguousarray(bgr, np.uint8)
    out = np.empty(bgr.shape[:-1], np.float32)
    lib.bgr_u8_to_gray_f32(_c(bgr, ctypes.c_uint8), _c(out, ctypes.c_float),
                           bgr.size // 3, int(threads))
    return out
