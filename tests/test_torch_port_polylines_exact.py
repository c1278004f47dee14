"""Port's exact polylines (plain version on the CPU) vs the JAX package's XLA
path (`apply_polylines_exact(impl="xla")`), which the JAX package's own tests
hold bit-equal to its Pallas kernel.

Stated tolerance: uint8 bit-equal, sharp and soft, on fixture, fold-heavy
and uniform-noise depth (measured: bit-equal in every case).

The CUDA kernel scans, per piece, a per-column candidate list (the segments
with x0 < col + 1 and x1 >= col within its warp's window) instead of the
row window. Its invariants are checked here on the plain version's
tensors: every candidate active at a valid piece center passes that filter
and lies in that window, and a float32 model of the kernel's column loop
(`_kernel_model`) gives the plain version's bits, with lists of every
capacity down to none (all columns then scan their range of sources).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfystereo_tpu.ops import depth as jdepth
from comfystereo_tpu.ops import polylines_exact as jpe
from comfystereo_tpu.utils import fixtures
from comfystereo_tpu_torch.kernels import _common
from comfystereo_tpu_torch.kernels import polylines_exact as tkpe
from comfystereo_tpu_torch.ops import depth as tdepth
from comfystereo_tpu_torch.ops import polylines_exact as tpe


def _depth(kind, h, w, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "fixture":
        return fixtures.create_depth_map(h, w).astype(np.float32)
    if kind == "fold":  # tests/test_polylines_exact_kernel.py's fold-heavy depth
        return (np.where(np.arange(w)[None, :] % 13 < 6, 255.0, 40.0) * np.ones((h, 1))
                + rng.uniform(0, 40, (h, w))).astype(np.float32)
    return rng.uniform(0, 255, (h, w)).astype(np.float32)


def _run_both(h, w, sharp, div, sep, depth):
    img = fixtures.create_test_image(h, w).astype(np.float32)[None]
    div_px, sep_px = (div / 100.0) * w, (sep / 100.0) * w
    jnd = jdepth.normalize_depth(jnp.asarray(depth[None])) - 0.5
    want = np.asarray(jpe.apply_polylines_exact(jnp.asarray(img), jnd, div_px, sep_px,
                                                2.0, sharp=sharp, impl="xla"))
    tnd = tdepth.normalize_depth(torch.from_numpy(depth[None])) - 0.5
    got = tpe.apply_polylines_exact(torch.from_numpy(img), tnd, div_px, sep_px, 2.0,
                                    sharp=sharp)
    assert got.shape == (1, h, w, 3) and got.dtype == torch.float32
    return got.numpy().astype(np.uint8), want.astype(np.uint8)


@pytest.mark.parametrize("sharp", [True, False])
@pytest.mark.parametrize("div,sep,kind", [(4.5, 0.0, "fixture"), (-4.5, 0.0, "fixture"),
                                          (7.0, 1.5, "fold"), (-7.0, 1.5, "noise")])
def test_exact_bit_equal_to_xla_24x56(sharp, div, sep, kind):
    got, want = _run_both(24, 56, sharp, div, sep, _depth(kind, 24, 56))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sharp", [True, False])
def test_exact_bit_equal_to_xla_48x64(sharp):
    got, want = _run_both(48, 64, sharp, 4.5, 1.5, _depth("fold", 48, 64, seed=1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sharp", [True, False])
def test_row_windows_match_whole_window(sharp):
    """Rows of flat, fold-heavy and ramp depth in one frame: the per-row
    windows of the plain version (and the kernel) are narrower than the XLA
    path's 64-row window, and the output is the same."""
    h, w = 12, 64
    depth = _depth("fold", h, w, seed=3)
    depth[:4] = 128.0
    depth[8:] = np.linspace(0, 255, w, dtype=np.float32)[None]
    got, want = _run_both(h, w, sharp, 7.0, 0.0, depth)
    np.testing.assert_array_equal(got, want)
    nd = tdepth.normalize_depth(torch.from_numpy(depth[None])) - 0.5
    x = (torch.arange(w, dtype=torch.float32) + 0.5
         + tdepth.signed_power(nd, 2.0)[0] * (0.07 * w))
    lo, hi = tkpe.window(x, int(np.ceil(0.07 * w)) + 4)
    assert int((hi - lo).min()) < int(hi.max() - lo.min())


def test_plain_skips_no_piece_a_pixel_reaches():
    """Skipping pieces that no pixel reaches leaves the result unchanged:
    the same rows rendered with 12 and with 40 pieces agree."""
    depth = _depth("noise", 6, 48, seed=4)
    nd = tdepth.normalize_depth(torch.from_numpy(depth[None])) - 0.5
    img = torch.from_numpy(fixtures.create_test_image(6, 48).astype(np.float32)[None])
    a = tpe.apply_polylines_exact(img, nd, 3.0, 0.0, 2.0, sharp=True, max_pieces=12)
    b = tpe.apply_polylines_exact(img, nd, 3.0, 0.0, 2.0, sharp=True, max_pieces=40)
    assert torch.equal(a, b)


def test_wrapper_rejects_bad_arguments():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        tkpe.polylines_exact_rows(x, x, torch.zeros(2, 7, 3), sharp=True,
                                  max_pieces=12, max_disp=4)
    with pytest.raises(TypeError):
        tkpe.polylines_exact_rows(x, x, torch.zeros(2, 8, 3, dtype=torch.float64),
                                  sharp=True, max_pieces=12, max_disp=4)


def _rows(h, w, div, sep, kind, seed=0):
    """The kernel's row arguments as the route forms them: (coord, x, cl,
    colours, sep_px, max_disp)."""
    depth = _depth(kind, h, w, seed)[None]
    div_px, sep_px = (div / 100.0) * w, (sep / 100.0) * w
    nd = tdepth.normalize_depth(torch.from_numpy(depth)) - 0.5
    coord = (tdepth.signed_power(nd, 2.0) * div_px)[0].contiguous()
    x = _common.point_x(coord, sep_px)
    colors = torch.from_numpy(fixtures.create_test_image(h, w).astype(np.float32))
    max_disp = int(np.ceil(abs(div_px) + abs(sep_px))) + 4
    return coord, x, coord.abs(), colors, sep_px, max_disp


ROW_CASES = [(24, 56, 4.5, 0.0, "fixture"), (24, 56, -4.5, 1.0, "fixture"),
             (48, 64, 7.0, 1.5, "fold"), (40, 56, -7.0, 1.5, "noise"),
             (12, 300, 4.5, -1.0, "noise")]


@pytest.mark.parametrize("sharp", [True, False])
@pytest.mark.parametrize("h,w,div,sep,kind", ROW_CASES)
def test_active_candidates_pass_list_filter(h, w, div, sep, kind, sharp):
    """Every segment active (x0 < center <= x1) at a valid piece center of a
    column has x0 < col + 1 and x1 >= col and lies in the column's warp
    window: the kernel's candidate lists leave out no segment that the
    winner scan can take."""
    _, x, _, _, _, max_disp = _rows(h, w, div, sep, kind)
    hw = 0.45 if sharp else 0.0
    centers, _, valids = tkpe.piece_geometry(x, sharp, 12, max_disp)
    lo, hi = tkpe.window(x, max_disp)
    dl, dh = tkpe.warp_windows(x, max_disp)
    assert bool(((dl >= lo) | (dl > dh)).all()) and bool(((dh <= hi) | (dl > dh)).all())
    cols = torch.arange(w)
    colsf = cols.float()
    r = max_disp + 5
    xp = torch.nn.functional.pad(x, (r, r + 1))
    n_active = 0
    for center, valid in zip(centers, valids):
        valid = valid > 0.5
        assert bool(((center >= colsf) & (center <= colsf + 1.0) | ~valid).all())
        for d in range(int(lo.min()), int(hi.max()) + 1):
            cur, nxt = xp[:, r + d:r + d + w], xp[:, r + d + 1:r + d + 1 + w]
            ok = valid & (d >= lo) & (d <= hi) & (cols + d >= 0) & (cols + d <= w - 1)
            segs = [(cur + hw, nxt - hw, ok & (cols + d <= w - 2))]
            if sharp:
                segs.append((cur - hw, cur + hw, ok))
            for x0, x1, cand in segs:
                active = cand & (x0 < center) & (x1 >= center)
                n_active += int(active.sum())
                listed = (x0 < colsf + 1.0) & (x1 >= colsf) & (d >= dl) & (d <= dh)
                assert not bool((active & ~listed).any()), (d, sharp)
    assert n_active > 0


def _kernel_model(x, cl, colors, sharp, max_disp, list_cap):
    """csrc/polylines_exact.cu's column loop in float32 scalars: one walk
    over the warp's window collecting the candidate list (soft: and the
    breakpoints), the sharp breakpoints from the listed flat tops, then per
    valid piece the winner scan over the sentinels and the list (past
    list_cap, over the sources from the first listed to the last). Returns
    (output, columns over list_cap)."""
    f = np.float32
    n, w = x.shape
    c = colors.shape[-1]
    hw, eps = (f(0.45) if sharp else f(0.0)), f(1e-7)
    dls, dhs = (t.numpy() for t in tkpe.warp_windows(torch.from_numpy(x), max_disp))
    out = np.zeros(colors.shape, np.float32)
    overflow = 0

    def consider(st, center, x0, x1, cl0, cl1, ident, flat):
        if not (x0 < center and x1 >= center):
            return
        denom = x1 - x0
        ip = (center - x0) / (f(1.0) if denom == 0 else denom)
        clp = (f(1.0) - ip) * cl0 + ip * cl1
        if f(0.0) < ip < f(1.0) and clp > st["best_cl"]:
            st["best_cl"], st["best"] = clp, (ident, ip, flat)
        if x0 < st["fb_x0"]:
            st["fb_x0"], st["fb"] = x0, (ident, ip, flat)

    def consider_source(st, center, xr, clr, cp, flat):
        x0 = xr[cp] - hw if flat else xr[cp] + hw
        x1 = xr[cp] + hw if flat else xr[cp + 1] - hw
        consider(st, center, x0, x1, clr[cp], clr[cp] if flat else clr[cp + 1], cp, flat)

    for row in range(n):
        xr, clr, img = x[row], cl[row], colors[row]
        sent_l, sent_r = f(-w), f(2 * w)
        for col in range(w):
            colf = f(col)
            colp1 = colf + f(1.0)
            slots = [sent_r] * 12

            def insert(pv):
                if not (colf <= pv < colp1):
                    return
                carry = pv
                for j in range(12):
                    slots[j], carry = min(slots[j], carry), max(slots[j], carry)

            lst = []
            cp0, cp1 = max(col + int(dls[row, col]), 0), min(col + int(dhs[row, col]), w - 1)
            prev_hi = f(0.0)
            for cp in range(cp0, min(cp1 + 1, w - 1) + 1):
                lo_pt, hi_pt = xr[cp] - hw, xr[cp] + hw
                if cp > cp0 and prev_hi < colp1 and lo_pt >= colf:
                    lst.append((cp - 1, False))
                prev_hi = hi_pt
                if cp > cp1:
                    break
                if sharp:
                    if lo_pt < colp1 and hi_pt >= colf:
                        lst.append((cp, True))
                else:
                    insert(xr[cp])
            if len(lst) > list_cap:
                overflow += 1
                span = range(lst[0][0], lst[-1][0] + 1)
                lst = [(cp, flat) for cp in span for flat in (True, False)
                       if (sharp or not flat) and (flat or cp <= w - 2)]
            for cp, flat in lst:  # sharp: the breakpoints from the flat tops
                if sharp and flat:
                    insert(xr[cp] - hw)
                    insert(xr[cp] + hw)
            acc = [f(0.5)] * c
            for k in range(12):
                if k == 0:
                    fk = colf + eps
                else:
                    if not slots[k - 1] < colp1:
                        break
                    fk = max(colf, slots[k - 1]) + eps
                sig = (min(colp1, slots[k]) - eps) - fk
                center = fk + f(0.5) * sig
                st = {"best_cl": -eps, "best": (-1, f(0.0), True), "fb_x0": f(1e30),
                      "fb": (-1, f(0.0), True)}
                consider(st, center, sent_l, xr[0] - hw, f(0.0), clr[0], 0, True)
                consider(st, center, xr[w - 1] + hw, sent_r, clr[w - 1], f(0.0), w - 1, True)
                for cp, flat in lst:
                    consider_source(st, center, xr, clr, cp, flat)
                ident, ip, flat = st["best"] if st["best_cl"] > -eps else st["fb"]
                for ch in range(c):
                    cval = f(0.0)
                    if ident >= 0:
                        cval = img[ident, ch] if flat else \
                            img[ident, ch] * (f(1.0) - ip) + img[ident + 1, ch] * ip
                    acc[ch] = acc[ch] + cval * sig
            out[row, col] = [np.trunc(min(max(a, f(0.0)), f(255.0))) for a in acc]
    return out, overflow


@pytest.mark.parametrize("sharp", [True, False])
@pytest.mark.parametrize("h,w,div,sep,kind", ROW_CASES[:4])
def test_kernel_model_matches_plain(h, w, div, sep, kind, sharp):
    """The kernel's design, modelled column by column in float32, is
    bit-equal to the plain version with lists of capacity 16 (the kernel's),
    2 and 0, and the model's overflowed columns are those `candidate_lists`
    counts."""
    _, x, cl, colors, _, max_disp = _rows(h, w, div, sep, kind)
    want = tkpe.polylines_exact_rows_plain(x, cl, colors, sharp, 12, max_disp).numpy()
    lengths = tkpe.candidate_lists(x, sharp, max_disp)[0]
    for cap in (tkpe.LIST_CAP, 2, 0):
        got, overflow = _kernel_model(x.numpy(), cl.numpy(), colors.numpy(), sharp,
                                      max_disp, cap)
        np.testing.assert_array_equal(got, want)
        assert overflow == int((lengths > cap).sum())


@pytest.mark.parametrize("sharp", [True, False])
@pytest.mark.parametrize("h,w,div,sep,kind", ROW_CASES)
def test_fused_entry_equals_route_composition(h, w, div, sep, kind, sharp):
    """The fused entry's plain version (and its wrapper on the CPU) is
    bit-equal to the route's former composition: x and |coord| formed in
    PyTorch, then `polylines_exact_rows`. The CPU wrapper counts overflowed
    columns as the kernel does."""
    coord, x, cl, colors, sep_px, max_disp = _rows(h, w, div, sep, kind)
    want = tkpe.polylines_exact_rows(
        (torch.arange(w, dtype=torch.float32) + 0.5 + coord + sep_px).contiguous(),
        coord.abs().contiguous(), colors, sharp=sharp, max_pieces=12, max_disp=max_disp)
    overflow = torch.zeros(1, dtype=torch.int32)
    got = tkpe.polylines_exact_rows_fused(coord, colors, sep_px, sharp=sharp, max_pieces=12,
                                          max_disp=max_disp, list_cap=3, overflow=overflow)
    assert torch.equal(got, want)
    assert torch.equal(tkpe.polylines_exact_rows_fused_plain(coord, colors, sep_px, sharp, 12,
                                                             max_disp), want)
    assert int(overflow) == int((tkpe.candidate_lists(x, sharp, max_disp)[0] > 3).sum())
    b_want = tpe._exact_core(colors[None], coord[None], sep_px, sharp, 12, max_disp)
    assert torch.equal(b_want[0], want)


@pytest.mark.parametrize("sharp", [True, False])
@pytest.mark.parametrize("div,sep,kind", [(4.5, 1.0, "fixture"), (-4.5, -1.0, "noise"),
                                          (7.0, -1.5, "fold")])
def test_fused_route_bit_equal_to_xla_with_separation(sharp, div, sep, kind):
    """Through `apply_polylines_exact`, which now calls the fused entry, with
    a separation of either sign: uint8 bit-equal to JAX's XLA path."""
    got, want = _run_both(24, 56, sharp, div, sep, _depth(kind, 24, 56, seed=2))
    np.testing.assert_array_equal(got, want)


def test_fused_wrapper_rejects_bad_arguments():
    coord = torch.zeros(2, 8)
    kw = dict(sharp=True, max_pieces=12, max_disp=4)
    with pytest.raises(ValueError):
        tkpe.polylines_exact_rows_fused(coord, torch.zeros(2, 7, 3), 0.0, **kw)
    with pytest.raises(TypeError):
        tkpe.polylines_exact_rows_fused(coord.double(), torch.zeros(2, 8, 3), 0.0, **kw)
    with pytest.raises(ValueError):
        tkpe.polylines_exact_rows_fused(coord.t(), torch.zeros(8, 2, 3), 0.0, **kw)
