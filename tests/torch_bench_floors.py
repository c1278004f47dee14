"""The accuracy floors of chip_smoke.py's bench phase, from the repository's
bench.py (JAX on the CPU):

    JAX_PLATFORMS=cpu python tests/torch_bench_floors.py [oracle width]

For config 1 (naive), config 2's exact mode (polylines_sharp at 4.5% / 0.5,
oracle width at most 256) and config 4 (the gpu_warp mask check), on the
inputs that `comfystereo_tpu_torch.bench` builds, it prints one JSON line:
bench.py's `_validate` SSIM unrounded, the count of uint8 values of JAX's
stereo pair that differ from the oracle's, config 4's mask parity, and the
least and most that one uint8 value one LSB off (20 seeded places) moves
each SSIM by. About 15 s.
"""
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
import comfystereo_tpu as cs  # noqa: E402
from comfystereo_tpu_torch import bench as tbench  # noqa: E402
from tests.oracle import stereo_oracle as oracle  # noqa: E402


def _jax_config(cfg):
    return cs.StereoConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(cs.StereoConfig)})


def _pair(cfg, img01, depth, width):
    """(JAX's stereo pair, its mask, the oracle's pair) at `width`."""
    simg, sdm = bench._scaled_inputs(img01, depth, width)
    out = cs.stereo_pipeline(jnp.asarray(simg[None]), jnp.asarray(sdm[None]), cfg)
    return (np.asarray(out["stereo"][0][0]), np.asarray(out["mask"][0]),
            bench._oracle_sbs(simg, sdm, cfg, oracle))


def _one_lsb(mine, want, mask, seed=0):
    """(least, most) |change| of the fill-region SSIM when one uint8 value of
    `mine` moves by one LSB, over 20 seeded places."""
    if mask.shape != mine.shape[:2]:
        mask = np.ones(mine.shape[:2])
    base = bench._fill_region_ssim(mine, want, mask)
    rng = np.random.default_rng(seed)
    moved = []
    for _ in range(20):
        y, x, c = (int(rng.integers(0, n)) for n in mine.shape)
        p = mine.copy()
        p[y, x, c] += 1 / 255 if p[y, x, c] < 0.5 else -1 / 255
        moved.append(abs(bench._fill_region_ssim(p, want, mask) - base))
    return min(moved), max(moved)


def main(width: int = 512) -> dict:
    res = {"oracle_width": width}
    for n, key, w in ((1, "1", width), (2, "2_exact", min(width, 256))):
        h, wd, _ = tbench.FULL_SHAPES[n]
        cfgs, imgs, dms = tbench.config_cases(n, h, wd, 1)
        cfg = _jax_config(cfgs[0] if n == 1 else cfgs[1])
        res[f"{key}_ssim"], _ = bench._validate(cfg, imgs[0], dms[0], w)
        mine, mask, want = _pair(cfg, imgs[0], dms[0], w)
        u8 = (lambda a: np.round(a * 255).astype(np.int32))
        res[f"{key}_u8_off_oracle"] = int((u8(mine) != u8(want)).sum())
        res[f"{key}_one_lsb_moves_ssim"] = _one_lsb(mine, want, mask)
    h, wd, _ = tbench.FULL_SHAPES[4]
    _, imgs, dms = tbench.config_cases(4, h, wd, 1)
    cfg = cs.StereoConfig(fill_technique="gpu_warp", modes=("left-only",),
                          depth_map_blur=False, stereo_balance=1.0)
    simg, sdm = bench._scaled_inputs(imgs[0], dms[0], width)
    out = cs.stereo_pipeline(jnp.asarray(simg[None]), jnp.asarray(sdm[None]), cfg)
    divl = cfg.eye_divergences()[0] / 100.0 * simg.shape[1]
    _, gap = oracle.forward_warp(simg, sdm, +divl, 0.0, cfg.stereo_offset_exponent,
                                 cfg.convergence_point)
    res["4_mask_parity"] = float(((np.asarray(out["mask"][0]) > 0.5) == gap).mean())
    return res


if __name__ == "__main__":
    print(json.dumps(main(*(int(a) for a in sys.argv[1:]))))
