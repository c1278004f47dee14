"""Tensor conversion utilities (node-layer interchange formats).

Equivalents of the reference's converters (GenerateStereo.py:32-44,
:365-457): [B,H,W,C] float 0-1 arrays <-> uint8 numpy <-> PIL, channel
merge and split. They work on host numpy arrays at the node and API
boundary; a torch tensor on any device is copied to the host first.
"""
from __future__ import annotations

from typing import List, Union

import numpy as np


def to_numpy(x) -> np.ndarray:
    """Accept numpy arrays and torch tensors (on any device)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def tensor2np(tensor) -> np.ndarray:
    """float 0-1 [B,H,W,C] or [H,W,C] (or CHW) -> uint8 [H,W,C].

    Matches the reference's truncating quantization (clip(255*x).astype(u8)).
    """
    arr = to_numpy(tensor)
    if arr.ndim == 4:
        arr = arr[0]
    arr = np.clip(255.0 * arr, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
        arr = arr.transpose(1, 2, 0)
    return arr


def np2tensor(img_np: Union[np.ndarray, List[np.ndarray]]) -> np.ndarray:
    """uint8 [H,W,C] (or a list of them) -> float 0-1 [B,H,W,C]."""
    if isinstance(img_np, list):
        return np.concatenate([np2tensor(i) for i in img_np], axis=0)
    return (img_np.astype(np.float32) / 255.0)[None]


def pil2tensor(image) -> np.ndarray:
    return np2tensor(np.asarray(image))


def tensor2pil(tensor):
    from PIL import Image

    return Image.fromarray(tensor2np(tensor))


def gray_to_rgb(x: np.ndarray) -> np.ndarray:
    """[..., H, W] -> [..., H, W, 3]."""
    return np.repeat(np.asarray(x)[..., None], 3, axis=-1)


def merge_channels(red, green, blue) -> np.ndarray:
    """Three single-channel images -> [B,H,W,3] float 0-1."""
    chans = [to_numpy(c) for c in (red, green, blue)]
    chans = [c[..., 0] if c.ndim >= 3 and c.shape[-1] in (1, 3) else c
             for c in chans]
    out = np.stack(chans, axis=-1).astype(np.float32)
    if out.ndim == 3:
        out = out[None]
    return out
