"""The stereo pipeline over a device mesh (`stereo_pipeline` on sharded
tensors).

Each block runs the stages of `pipeline.stereo_pipeline` on its own device.
Three things cross blocks, and each is done here explicitly, as XLA does
it for the JAX package:

- `_depth255` tests `depth.max() <= 1` over the whole chunk: the blocks'
  maxima are all-reduced (MAX) before any block scales its depth.
- The eyes normalise each frame's depth by its min and max (the warp's
  fused entry, the fills' `normalize_depth`): the blocks of a frame's rows
  all-reduce their minima and maxima (MIN / MAX) over "seq", and every
  block normalises by the frame's extrema.
- Halo rows. The blur's vertical dependencies are the Sobel's +-1 row and
  the weights' box mean of radius `depth_blur_vert_smooth`, so a row block
  takes `vert_smooth + 1` rows of depth from each neighbour, blurs the
  widened block (its own symmetric and edge-replicate padding then touches
  only halo rows, and at a frame's true top and bottom it is the frame's
  own) and crops. The hybrid fills' 3x3 bilateral gap fill reads +-1 row of
  the splatted eye, so for them the block keeps one more halo row of depth
  and colour through the eyes. Every other stage is row-local.

With complete halos and all-reduced extrema a pixel's arithmetic is that of
the unsharded run, so every output is bit-equal to it. A top-bottom packed
output comes back with two row groups (`ShardedTensor.row_groups`): each
block's left-eye rows belong in the top half and its right-eye rows in the
bottom half.
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import pipeline as pl
from ..config import StereoConfig
from .sharding import ShardedTensor, Slot, all_slots, like

_TWO_GROUP_MODES = ("top-bottom", "bottom-top")
_HYBRID = ("hybrid_edge", "hybrid_edge_plus")


def halo_rows(cfg: StereoConfig):
    """(blur halo, fill halo): rows of depth a row block needs from each
    neighbour for the blur, and rows it keeps through the eyes for the
    hybrid fills' 3x3 gap fill."""
    blur_on = cfg.depth_map_blur and cfg.depth_blur_strength > 0
    hb = max(0, int(cfg.depth_blur_vert_smooth)) + 1 if blur_on else 0
    hf = 1 if cfg.fill_technique in _HYBRID else 0
    return hb, hf


def _halos(x: ShardedTensor, k: int):
    """{slot: (rows above, rows below)}: up to k rows of x's neighbouring
    blocks in the same frames (fewer at a frame's top and bottom)."""
    mesh, slots = x.mesh, sorted(x.blocks)
    if k == 0 or not x.rows or mesh.n_seq == 1:
        return {s: (None, None) for s in slots}
    hs = x.shape[1] // mesh.n_seq
    m = min(k, hs)
    tops = all_slots(mesh, True, {s: x.blocks[s][:, :m] for s in slots})
    bots = all_slots(mesh, True, {s: x.blocks[s][:, hs - m:] for s in slots})
    out = {}
    for d, s in slots:
        dev = x.blocks[(d, s)].device
        above = [bots[(d, j)] for j in range(max(0, s - (k + hs - 1) // hs), s)]
        below = [tops[(d, j)] for j in range(s + 1, min(mesh.n_seq, s + 1 + (k + hs - 1) // hs))]
        up = torch.cat([t.to(dev) for t in above], dim=1)[:, -k:] if above else None
        down = torch.cat([t.to(dev) for t in below], dim=1)[:, :k] if below else None
        out[(d, s)] = (up, down)
    return out


def _widen(block: torch.Tensor, halo) -> torch.Tensor:
    up, down = halo
    if up is None and down is None:
        return block
    return torch.cat([t for t in (up, block, down) if t is not None], dim=1)


def _rows(halo):
    """The halo's rows above and below its block."""
    up, down = halo
    return (0 if up is None else up.shape[1], 0 if down is None else down.shape[1])


def _global_max(depth: ShardedTensor) -> Dict[Slot, torch.Tensor]:
    """The chunk's maximum depth, all-reduced over every block, on each
    local block's device."""
    got = all_slots(depth.mesh, depth.rows,
                    {s: b.float().amax() for s, b in depth.blocks.items()})
    return {s: torch.stack([v.to(b.device) for v in got.values()]).amax()
            for s, b in depth.blocks.items()}


def _frame_extrema(mesh, rows: bool, parts: Dict[Slot, torch.Tensor]):
    """parts: {slot: [4, b] (left min, left max, right min, right max of each
    frame's rows in the block)}. Returns {slot: (left range, right range)},
    each range (min [b], max [b]) of the whole frames, all-reduced over the
    frame's blocks."""
    got = all_slots(mesh, rows, parts)
    out = {}
    for (d, s), p in parts.items():
        mine = torch.stack([v.to(p.device) for (dd, _), v in got.items() if dd == d])
        lo, hi = mine.amin(0), mine.amax(0)
        out[(d, s)] = ((lo[0].contiguous(), hi[1].contiguous()),
                       (lo[2].contiguous(), hi[3].contiguous()))
    return out


def sharded_pipeline(image: ShardedTensor, depth: ShardedTensor,
                     cfg: StereoConfig) -> Dict[str, object]:
    """`stereo_pipeline` on sharded image [B, H, W, C] and depth [B, H, W]
    (the same sharding). Returns the same dict with every output sharded
    as its input was."""
    if not isinstance(image, ShardedTensor) or not isinstance(depth, ShardedTensor) \
            or image.sharding != depth.sharding:
        raise TypeError("stereo_pipeline takes image and depth sharded alike")
    if tuple(image.shape[:3]) != tuple(depth.shape):
        raise ValueError(f"image {tuple(image.shape)} and depth {tuple(depth.shape)}")
    mesh, rows = depth.mesh, depth.rows
    hb, hf = halo_rows(cfg)
    gmax = _global_max(depth)
    depth_halo = _halos(depth, hb + hf)
    image_halo = _halos(image, hf)
    left_div, right_div = cfg.eye_divergences()

    eyes, ranges = {}, {}
    for s, blk in depth.blocks.items():
        d = _widen(blk, depth_halo[s]).float()
        d255 = torch.where(gmax[s] <= 1.0, d * 255.0, d)
        left_d, right_d = pl._blurred_eye_depths(d255, cfg)
        up, down = _rows(depth_halo[s])
        keep_up, keep_down = _rows(image_halo[s])
        # rows of the blurred block that the eyes use: the block's own and
        # the fill halo (the blur halo's rows are cropped)
        n = left_d.shape[1]
        left_d = left_d[:, up - keep_up:n - (down - keep_down)]
        right_d = right_d[:, up - keep_up:n - (down - keep_down)]
        h = blk.shape[1]
        own_l = left_d[:, keep_up:keep_up + h]
        own_r = right_d[:, keep_up:keep_up + h]
        eyes[s] = (left_d, right_d, keep_up, h)
        b = blk.shape[0]
        ranges[s] = torch.stack([*torch.aminmax(own_l.reshape(b, -1), dim=-1),
                                 *torch.aminmax(own_r.reshape(b, -1), dim=-1)])
    extrema = _frame_extrema(mesh, rows, ranges)

    outs: Dict[Slot, Dict[str, object]] = {}
    for s, img in image.blocks.items():
        left_d, right_d, keep_up, h = eyes[s]
        src = pl._eye_source(_widen(img, image_halo[s]).float(), cfg)
        left_range, right_range = extrema[s]
        left = pl._eye(src, left_d, left_div, +1.0, cfg, depth_range=left_range)
        right = pl._eye(src, right_d, right_div, -1.0, cfg, depth_range=right_range)

        def own(eye):
            colour, gap = eye
            return (colour[:, keep_up:keep_up + h],
                    None if gap is None else gap[:, keep_up:keep_up + h])

        outs[s] = pl._outputs(own(left), own(right), left_d[:, keep_up:keep_up + h],
                              right_d[:, keep_up:keep_up + h], cfg)

    def groups(mode: str) -> int:
        return 2 if rows and mode in _TWO_GROUP_MODES else 1

    mask_groups = 1 if cfg.fill_technique == "gpu_warp" else groups(cfg.modes[0])
    return {
        "stereo": tuple(like(depth, {s: o["stereo"][i] for s, o in outs.items()}, groups(m))
                        for i, m in enumerate(cfg.modes)),
        "left_depth": like(depth, {s: o["left_depth"] for s, o in outs.items()}),
        "right_depth": like(depth, {s: o["right_depth"] for s, o in outs.items()}),
        "mask": like(depth, {s: o["mask"] for s, o in outs.items()}, mask_groups),
    }
