"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` is compiled on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o lib<name>_<hash>.so <name>.cu

`-fmad=false` keeps nvcc from contracting `a*b + c*d` into FMAs, so the
kernels round like the eager PyTorch plain versions and the JAX reference;
`--use_fast_math` is never used, because `frac`, `t` and the sqrt bias need
IEEE division and square root.

Libraries go to `build/torch_kernels/` at the repository root and are named
by a hash of the sources, so an edited kernel is rebuilt at first use. This
module is imported only on the CUDA branch of a wrapper: the package itself
imports without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-fmad=false", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every exported function: argtypes, with c_void_p for each
# pointer and the stream (a plain int would cut a 64-bit pointer).
SIGNATURES: Dict[str, Dict[str, list]] = {
    "distance": {
        "cs_edge_distances": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
        "cs_edge_weights": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _I, _P],
    },
    "warp_kernel": {
        "cs_warp_rows_f32": [_P] * 6 + [_I] * 4 + [_F, _I, _I, _P],
        "cs_warp_rows_bf16": [_P] * 6 + [_I] * 4 + [_F, _I, _I, _P],
        "cs_warp_rows_depth_f32": [_P] * 7 + [_I] * 5 + [_F, _F, _F, _I, _F, _F, _I, _I, _P],
        "cs_warp_rows_depth_bf16": [_P] * 7 + [_I] * 5 + [_F, _F, _F, _I, _F, _F, _I, _I, _P],
    },
    "gather": {
        "cs_gather_rows_b32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "polylines_exact": {
        "cs_polylines_exact_rows": [_P] * 5 + [_I] * 8 + [_P, _P],
        "cs_polylines_exact_coord": [_P, _F, _P, _P, _P] + [_I] * 8 + [_P, _P],
    },
    "polylines": {
        "cs_polylines_rows": [_P] * 5 + [_I] * 8 + [_P],
        "cs_polylines_coord": [_P, _F, _P, _P, _P] + [_I] * 8 + [_P],
    },
    "flash_attention": {
        "cs_flash_attention_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    },
    "box_blend": {
        "cs_box_blend": [_P] * 5 + [_I] * 5 + [_P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources(name: str):
    """The kernel's .cu file plus every shared header in csrc/."""
    return [SRC_DIR / f"{name}.cu"] + sorted(SRC_DIR.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in _sources(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one kernel; returns (process, tmp path, final path)
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ([_nvcc()] + ARCH_FLAGS + NVCC_FLAGS
           + ["-o", str(tmp), str(SRC_DIR / f"{name}.cu")])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, ctypes.CDLL]:
    """Build (all nvcc processes at once) and load the named kernels."""
    names = list(names)
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        started = {n: _start_build(n) for n in todo}
        try:
            for n, s in started.items():
                if s is not None:
                    _finish_build(n, s)
        finally:
            for s in started.values():
                if s is not None and s[0].poll() is None:
                    s[0].kill()
                    s[0].wait()
        for n in todo:
            _LIBS[n] = _load(n)
        return {n: _LIBS[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built at first use."""
    lib = _LIBS.get(name)
    return lib if lib is not None else build([name])[name]


def build_log(name: str) -> str:
    """nvcc's output (including `-Xptxas -v` resource usage) of the last
    build of `name`, or '' when the library was found already built."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C entry."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")
