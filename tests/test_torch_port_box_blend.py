"""The blur's box-blend kernel wrapper on the CPU (its plain version), and a
numpy model of the CUDA kernel's tiling, index clamping and tap order.

Every comparison is bit for bit: the plain version is the blur's former
composition (`box_blur_h` -> clamp -> `box_blur_w` -> blend), and the kernel
adds, divides and blends in the same order (`csrc/box_blend.cu`). The
kernel itself is held to the plain version on the card in
`tests/test_torch_port_cuda.py`.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from comfystereo_tpu_torch.kernels import box_blend as bb
from comfystereo_tpu_torch.kernels import distance as tdist
from comfystereo_tpu_torch.ops import blur as tblur
from comfystereo_tpu_torch.utils import fixtures

# (taps, radius): the cells' (20, 6), no box at all, the smallest boxes, a
# window wider than some of the shapes, and no vertical box.
TAPS_RADII = [(1, 0), (2, 1), (5, 6), (20, 6), (20, 0)]
# [N, H, W]: H < 2r + 1 and W < n, odd H and W, N of 1 and 3.
SHAPES = [(1, 5, 7), (3, 4, 3), (3, 13, 9), (1, 31, 45), (3, 21, 64)]


def _inputs(shape, seed=0):
    """Depth in 0-255 and two weight planes in [0, 1] with exact zeros and
    ones, as the edge weights have them."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 255, shape).astype(np.float32)
    d[..., : shape[-1] // 3] = np.round(d[..., : shape[-1] // 3])  # uint8-valued stretches
    wl, wr = (np.where(rng.random(shape) < 0.4, 0.0, rng.random(shape) ** 2).astype(np.float32)
              for _ in range(2))
    wl[..., ::5, :] = 1.0
    return torch.from_numpy(d), torch.from_numpy(wl), torch.from_numpy(wr)


def _composition(depth, wl, wr, taps, radius):
    """The blur's composition as it was written before the kernel."""
    if radius > 0:
        wl = torch.clamp(tblur.box_blur_h(wl, radius), 0.0, 1.0)
        wr = torch.clamp(tblur.box_blur_h(wr, radius), 0.0, 1.0)
    blurred = tblur.box_blur_w(depth, taps)
    return wl * blurred + (1.0 - wl) * depth, wr * blurred + (1.0 - wr) * depth


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("taps,radius", TAPS_RADII)
def test_plain_version_is_the_composition(taps, radius, shape):
    depth, wl, wr = _inputs(shape)
    before = bb.LAUNCHES
    got = bb.box_blend(depth, wl, wr, taps=taps, radius=radius)  # CPU: the plain version
    assert bb.LAUNCHES == before
    for g, want in zip(got, _composition(depth, wl, wr, taps, radius)):
        assert g.dtype == torch.float32 and torch.equal(g, want)


def _kernel_model(d, wl, wr, taps, radius, tile=bb.TILE, strip=bb.STRIP,
                  ring_radius=bb.RING_RADIUS):
    """csrc/box_blend.cu in numpy float32, CTA by CTA: a strip of `strip`
    rows of a `tile`-column tile; per row a stage holding the depth row with
    its halo (columns clamped one by one) and the weights' row `radius` rows
    below (clamped to the last row); a ring of the last 2r + 1 weight rows,
    primed from rows y0 - r .. y0 + r - 1, for radii up to `ring_radius`,
    and taps read straight from the planes beyond; every sum from its first
    tap in ascending order, then IEEE division, torch.clamp and the blend's
    four rounded operations."""
    f32 = np.float32
    n_img, h, w = d.shape
    lead = taps - 1 - taps // 2
    left, right = np.zeros_like(d), np.zeros_like(d)

    def clamp01(v):
        return np.where(np.isnan(v), v, np.minimum(np.maximum(v, f32(0)), f32(1)))

    def box(taps_of):
        acc = taps_of[0]
        for p in taps_of[1:]:
            acc = acc + p
        return acc

    for img in range(n_img):
        for y0 in range(0, h, strip):
            rows = min(strip, h - y0)
            for x0 in range(0, w, tile):
                j = np.arange(tile)
                live = x0 + j < w
                xc = np.minimum(x0 + j, w - 1)
                ring = []
                if 0 < radius <= ring_radius:
                    ring = [(wl[img, min(max(y0 - radius + k, 0), h - 1), xc],
                             wr[img, min(max(y0 - radius + k, 0), h - 1), xc])
                            for k in range(2 * radius)]
                for m in range(rows):
                    y = y0 + m
                    stage = d[img, y, np.clip(x0 - lead + np.arange(tile + taps - 1), 0, w - 1)]
                    if radius == 0:
                        gl, gr = wl[img, y, xc], wr[img, y, xc]
                    elif radius <= ring_radius:
                        yw = min(y + radius, h - 1)
                        ring.append((wl[img, yw, xc], wr[img, yw, xc]))
                        n_rows = f32(2 * radius + 1)
                        gl = clamp01(box([p for p, _ in ring]) / n_rows)
                        gr = clamp01(box([p for _, p in ring]) / n_rows)
                        ring.pop(0)
                    else:
                        at = [min(max(y - radius + k, 0), h - 1) for k in range(2 * radius + 1)]
                        n_rows = f32(2 * radius + 1)
                        gl = clamp01(box([wl[img, r, xc] for r in at]) / n_rows)
                        gr = clamp01(box([wr[img, r, xc] for r in at]) / n_rows)
                    dd = stage[lead + j]
                    b = box([stage[j + k] for k in range(taps)]) / f32(taps) if taps > 1 else dd
                    for out, g in ((left, gl), (right, gr)):
                        val = g * b + (f32(1) - g) * dd
                        out[img, y, (x0 + j)[live]] = val[live]
    return left, right


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("taps,radius", TAPS_RADII + [(3, 9), (20, 12)])
def test_kernel_model_bit_equal_to_plain(taps, radius, shape):
    """The model at small tiles and strips (so the shapes cross tile, strip
    and ring boundaries) and at the kernel's own, radii past the ring's
    (the instance that reads its taps from the planes) included."""
    depth, wl, wr = _inputs(shape, seed=1)
    want = bb.box_blend_plain(depth, wl, wr, taps=taps, radius=radius)
    for tile, strip, ring in ((8, 3, 4), (bb.TILE, bb.STRIP, bb.RING_RADIUS)):
        got = _kernel_model(depth.numpy(), wl.numpy(), wr.numpy(), taps, radius, tile, strip,
                            ring)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())


def test_kernel_model_at_the_kernels_tiles_across_their_edges():
    """The cells' parameters on an image of more than one strip and tile of
    the kernel's size, with NaN and -0.0 among the weights."""
    depth, wl, wr = _inputs((1, bb.STRIP + 9, bb.TILE + 21), seed=2)
    wl[0, 3, 5] = float("nan")
    wr[0, 7, 9] = -0.0
    want = bb.box_blend_plain(depth, wl, wr, taps=20, radius=6)
    got = _kernel_model(depth.numpy(), wl.numpy(), wr.numpy(), 20, 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_model_constants_are_the_kernels():
    """The wrapper's tiling constants, which the model uses, are the CUDA
    source's."""
    src = (Path(bb.__file__).resolve().parent.parent / "csrc" / "box_blend.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert {k: int(consts[k]) for k in ("kThreads", "kStrip", "kRingRadius", "kMaxTaps")} == {
        "kThreads": bb.TILE, "kStrip": bb.STRIP, "kRingRadius": bb.RING_RADIUS,
        "kMaxTaps": bb.MAX_TAPS}


def _old_directional_motion_blur(depth, blur_strength, edge_threshold, blur_mask_width,
                                 falloff_exponent, vert_smooth_px):
    """ops/blur.py:directional_motion_blur as it was before the kernel."""
    n = int(round(blur_strength))
    depth = depth.float()
    h, w = depth.shape[-2:]
    wl, wr = tdist.edge_weights_fused(depth.reshape(-1, w).contiguous(),
                                      edge_threshold=edge_threshold,
                                      mask_radius=int(blur_mask_width),
                                      falloff=float(np.float32(falloff_exponent)), height=h)
    wl, wr = wl.reshape(depth.shape), wr.reshape(depth.shape)
    if vert_smooth_px > 0:
        wl = torch.clamp(tblur.box_blur_h(wl, int(vert_smooth_px)), 0.0, 1.0)
        wr = torch.clamp(tblur.box_blur_h(wr, int(vert_smooth_px)), 0.0, 1.0)
    blurred = tblur.box_blur_w(depth, n)
    return wl * blurred + (1.0 - wl) * depth, wr * blurred + (1.0 - wr) * depth


@pytest.mark.parametrize("shape", [(2, 48, 64), (3, 13, 9), (1, 5, 7), (40, 33)])
@pytest.mark.parametrize("taps,radius", TAPS_RADII)
def test_directional_motion_blur_unchanged_on_the_cpu(taps, radius, shape):
    """The blur through the wrapper equals its former composition bit for
    bit, on fixture depth and on 2-D depth."""
    n_img = shape[0] if len(shape) == 3 else 1
    _, dep = fixtures.batch_fixture(n_img, *shape[-2:], seed=3)
    d = torch.from_numpy((dep * 255.0).astype(np.float32)).reshape(shape)
    kw = dict(blur_strength=taps, edge_threshold=20, blur_mask_width=20, falloff_exponent=2.0,
              vert_smooth_px=radius)
    got = tblur.directional_motion_blur(d, **kw)
    for g, want in zip(got, _old_directional_motion_blur(d, **kw)):
        assert g.shape == d.shape and torch.equal(g, want)


def test_wrapper_checks_its_inputs():
    depth, wl, wr = _inputs((2, 8, 12))
    kw = dict(taps=5, radius=2)
    with pytest.raises(TypeError):
        bb.box_blend(depth.double(), wl.double(), wr.double(), **kw)
    with pytest.raises(TypeError):
        bb.box_blend(depth, wl.half(), wr, **kw)
    with pytest.raises(ValueError, match=r"\[N, H, W\]"):
        bb.box_blend(depth[0], wl[0], wr[0], **kw)
    with pytest.raises(ValueError, match=r"\[N, H, W\]"):
        bb.box_blend(depth[None], wl[None], wr[None], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        bb.box_blend(depth[:, :, ::2], wl[:, :, ::2], wr[:, :, ::2], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        bb.box_blend(depth, wl.transpose(1, 2).contiguous().transpose(1, 2), wr, **kw)
    with pytest.raises(ValueError, match="shape"):
        bb.box_blend(depth, wl[:, :, :6].contiguous(), wr, **kw)


def test_wrapper_takes_card_shapes_and_refuses_wide_windows():
    """Meta tensors stand for the card's: any H and W reach the device check
    ("unsupported device meta"), and a window over MAX_TAPS raises first;
    neither launches."""
    before = bb.LAUNCHES
    for shape in ((12, 1080, 1920), (1, 1, 1), (3, 2, 100000)):
        t = torch.empty(shape, device="meta")
        with pytest.raises(ValueError, match="unsupported device meta"):
            bb.box_blend(t, t, t, taps=bb.MAX_TAPS, radius=40)
    t = torch.empty((1, 4, 4), device="meta")
    with pytest.raises(ValueError, match=f"{bb.MAX_TAPS} taps"):
        bb.box_blend(t, t, t, taps=bb.MAX_TAPS + 1, radius=0)
    assert bb.LAUNCHES == before


def test_wrapper_takes_no_window_as_the_depth():
    """taps <= 1 and radius <= 0 leave the depth and the weights as they
    are: each eye is w * d + (1 - w) * d."""
    depth, wl, wr = _inputs((1, 6, 10))
    for taps, radius in ((0, -3), (1, 0)):
        left, right = bb.box_blend(depth, wl, wr, taps=taps, radius=radius)
        assert torch.equal(left, wl * depth + (1.0 - wl) * depth)
        assert torch.equal(right, wr * depth + (1.0 - wr) * depth)
