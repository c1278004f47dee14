"""Model and embedding caches, and parameter save/load.

Port of `comfystereo_tpu/utils/caching.py`: the one in-process model cache
(every bundle the port loads or builds on demand: the loader's checkpoints
keyed by id, scheduler and device, the diffusers adapter's, the node's toy
model per device), the one LRU text-embedding cache (every text encoder
caches through it), and save/load of parameter state with
`torch.save` / `torch.load(weights_only=True)` in place of orbax, so
inverted-latent and unconditional-embedding state survives restarts.
"""
from __future__ import annotations

import collections
import os
import threading
from typing import Any, Callable, Dict, Hashable, Optional

import torch

_model_cache: Dict[Hashable, Any] = {}
_model_lock = threading.RLock()


def get_or_load_model(key: Hashable, loader: Callable[[], Any]) -> Any:
    """Process-wide model cache (one load per key, thread-safe). Keys carry
    the device, so one process may hold a CPU and a CUDA bundle of one
    model."""
    with _model_lock:
        if key not in _model_cache:
            _model_cache[key] = loader()
        return _model_cache[key]


def clear_model_cache() -> None:
    """Drop every cached model bundle."""
    with _model_lock:
        _model_cache.clear()


class EmbeddingCache:
    """LRU text-embedding cache (prompt -> tensor) around `encode`. The text
    encoders subclass it and override `_encode` instead (a bound method
    kept on the instance would be a reference cycle, which holds the
    encoder's model until the garbage collector runs)."""

    def __init__(self, encode: Optional[Callable[[str], Any]] = None, capacity: int = 256):
        if encode is not None:
            self._encode = encode
        self._capacity = capacity
        self._data: "collections.OrderedDict[str, Any]" = collections.OrderedDict()

    def _encode(self, text: str):
        raise NotImplementedError("give EmbeddingCache an encode, or override _encode")

    def __contains__(self, text: str) -> bool:
        return text in self._data

    def __call__(self, text: str):
        if text in self._data:
            self._data.move_to_end(text)
            return self._data[text]
        emb = self._encode(text)
        self._data[text] = emb
        if len(self._data) > self._capacity:
            self._data.popitem(last=False)
        return emb


def save_params(path: str, params) -> None:
    """Persist a state dict (or any nest of tensors, dicts and lists)."""
    torch.save(params, os.path.abspath(path))


def load_params(path: str, map_location=None):
    """Restore what `save_params` wrote (tensors only: `weights_only`)."""
    return torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)
