"""Entry points: the flagship pipeline's forward step and a self-checked
multi-device dry run (the port's twin of the repository's
`__graft_entry__.py`).

    python -m comfystereo_tpu_torch.graft_entry [N] [DEVICE]

runs `dryrun_multichip(N, DEVICE)` (default 4 slots on the local CUDA
devices; pass `cpu` or `cuda:0` to put every slot on one device).
"""
from __future__ import annotations

import contextlib
import sys
from typing import Dict

import torch


def entry(device=None):
    """(fn, example_args): the flagship pipeline's forward step (gpu_warp,
    left-right) on `device` (None: CUDA), and host numpy example args, so
    that building them touches no device."""
    from . import StereoConfig, stereo_pipeline
    from .device import as_float_tensor, resolve_device
    from .utils import fixtures

    cfg = StereoConfig(modes=("left-right",), fill_technique="gpu_warp")

    def fn(image, depth):
        dev = resolve_device(device)
        return stereo_pipeline(as_float_tensor(image, dev), as_float_tensor(depth, dev), cfg)

    imgs, depths = fixtures.batch_fixture(2, 96, 128)
    return fn, (imgs, depths)


@contextlib.contextmanager
def _no_tf32():
    """float32 products and convolutions in float32 on the card, so that a
    batch split over devices changes only the summation order."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _rel_l2(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> float:
    return float((got.double() - want.double()).norm() / scale.double().norm().clamp_min(1e-30))


def dryrun_multichip(n_devices: int, device=None) -> Dict[str, float]:
    """Run the batched pipeline and one diffusion training-style step over an
    n-slot ("data", "seq") mesh on tiny shapes, each held against a run on
    one device; raises AssertionError on a mismatch. Returns the measured
    differences.

    Follows `__graft_entry__.py`: gpu_warp over left-right and top-bottom
    with frames on "data" and rows on "seq" (bit-equal to one device: the
    halos and extrema are exchanged exactly), the naive fill without the
    blur (bit-equal), one null-text optimisation step data-parallel over the
    latent batch with the toy model replicated per device (u within 1e-2 of
    its update, relative L2, and the next latent within 1e-3 of one
    device's), and a TINY SD UNet forward data-parallel over the batch
    (within 1e-4, relative L2). device: as `parallel.make_mesh` takes it
    (None: the local CUDA devices)."""
    from . import StereoConfig, stereo_pipeline
    from .diffusion import inversion, make_toy_model, schedulers
    from .diffusion.porting import build_sd_model
    from .diffusion.sd_unet import TINY_SD_UNET_CONFIG
    from .diffusion.sd_vae import TINY_SD_VAE_CONFIG
    from .parallel import data_parallel as dp
    from .parallel import frame_sharding, make_mesh, shard_batch, shard_tensor
    from .parallel.sharding import replicate
    from .utils import fixtures

    # 2-axis mesh: frames over 'data', rows over 'seq'.
    d_ax = max(1, n_devices // 2)
    s_ax = n_devices // d_ax
    mesh = make_mesh(d_ax * s_ax, axes=("data", "seq"), shape=(d_ax, s_ax), device=device)
    slots = mesh.block_slots(False)  # the data-parallel blocks' slots
    one = mesh.device(slots[0])
    report: Dict[str, float] = {}

    b, h, w = d_ax * 2, s_ax * 32, 128
    imgs, depths = fixtures.batch_fixture(b, h, w)
    s_imgs, s_deps = shard_batch(imgs, depths, mesh, rows=True)
    imgs1, deps1 = torch.from_numpy(imgs).to(one), torch.from_numpy(depths).to(one)

    cfg = StereoConfig(modes=("left-right", "top-bottom"), fill_technique="gpu_warp")
    out = stereo_pipeline(s_imgs, s_deps, cfg)
    if tuple(out["stereo"][0].shape) != (b, h, 2 * w, 3) \
            or tuple(out["stereo"][1].shape) != (b, 2 * h, w, 3):
        raise AssertionError(f"sharded shapes {out['stereo'][0].shape}, {out['stereo'][1].shape}")
    ref = stereo_pipeline(imgs1, deps1, cfg)
    for got, want, name in [(out["stereo"][0], ref["stereo"][0], "sbs"),
                            (out["stereo"][1], ref["stereo"][1], "tb"),
                            (out["mask"], ref["mask"], "mask"),
                            (out["left_depth"], ref["left_depth"], "left_depth"),
                            (out["right_depth"], ref["right_depth"], "right_depth")]:
        g = got.gather().to(one)
        if not torch.equal(g, want):
            delta = float((g.float() - want.float()).abs().max())
            raise AssertionError(f"sharded-vs-one-device mismatch on {name}: max |d|={delta}")
    report["gpu_warp_max_abs_err"] = 0.0

    # The CPU-parity fill path under the same sharding (scatter + scans).
    cfg2 = StereoConfig(fill_technique="naive", depth_map_blur=False)
    out2 = stereo_pipeline(s_imgs, s_deps, cfg2)["stereo"][0].gather().to(one)
    if tuple(out2.shape) != (b, h, 2 * w, 3) or not torch.equal(
            out2, stereo_pipeline(imgs1, deps1, cfg2)["stereo"][0]):
        raise AssertionError("naive-fill sharded output differs from one device")
    report["naive_max_abs_err"] = 0.0

    # Null-text optimisation (gradients + Adam) data-parallel over the latent
    # batch, the toy model replicated per device.
    frames = frame_sharding(mesh)
    models = replicate(mesh, lambda dev: make_toy_model(image_size=32, device=dev), slots)
    model1 = models[slots[0]]
    sched = schedulers.make_ddim(4)
    nb = d_ax * s_ax * 2
    gen = torch.Generator().manual_seed(0)
    lat = torch.randn((nb, model1.latent_channels, 4, 4), generator=gen)
    prev = lat + 0.1 * torch.randn(lat.shape, generator=gen)
    cond = model1.text_encode("prompt").repeat(nb, 1, 1).cpu()
    uncond = model1.text_encode("").repeat(nb, 1, 1).cpu()
    t = int(sched.timesteps[0])
    kw = dict(guidance_scale=7.5, num_inner_steps=2, lr=1e-2, stop_eps=1e-6)
    with _no_tf32():
        u_opt, lat_next = dp.null_text_optimize_step(
            models, sched, shard_tensor(lat, frames), shard_tensor(prev, frames), t,
            shard_tensor(uncond, frames), shard_tensor(cond, frames), **kw)
        u_ref, lat_ref = inversion.null_text_optimize_step(
            model1, sched, lat.to(one), prev.to(one), t, uncond.to(one), cond.to(one), **kw)
    u_got, lat_got = u_opt.gather().to(one), lat_next.gather().to(one)
    if tuple(lat_got.shape) != tuple(lat.shape):
        raise AssertionError(f"null-text latent shape {tuple(lat_got.shape)}")
    report["null_text_u_rel"] = _rel_l2(u_got, u_ref, u_ref - uncond.to(one))
    report["null_text_latent_rel"] = _rel_l2(lat_got, lat_ref, lat_ref)
    if report["null_text_u_rel"] > 1e-2 or report["null_text_latent_rel"] > 1e-3:
        raise AssertionError(f"data-parallel null-text step vs one device: {report}")

    # SD-architecture UNet (TINY config, SD 1.5's topology) under the mesh: a
    # CFG-batched forward data-parallel with replicated parameters.
    sdms = replicate(mesh, lambda dev: build_sd_model(
        TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, device=dev), slots)
    sdm1 = sdms[slots[0]]
    lat2 = torch.randn((nb, 4, 8, 8), generator=gen)
    ctx2 = torch.randn((nb, 77, TINY_SD_UNET_CONFIG.cross_attention_dim), generator=gen)
    with torch.no_grad(), _no_tf32():
        eps = dp.map_blocks(lambda s, lb, cb: sdms[s].unet_apply(lb, 10, cb),
                            shard_tensor(lat2, frames), shard_tensor(ctx2, frames))
        eps_ref = sdm1.unet_apply(lat2.to(one), 10, ctx2.to(one))
    eps_got = eps.gather().to(one)
    if tuple(eps_got.shape) != tuple(lat2.shape) or not bool(torch.isfinite(eps_got).all()):
        raise AssertionError(f"UNet eps {tuple(eps_got.shape)} not finite")
    report["unet_rel"] = _rel_l2(eps_got, eps_ref, eps_ref)
    if report["unet_rel"] > 1e-4:
        raise AssertionError(f"data-parallel UNet vs one device: {report['unet_rel']}")
    return report


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    dev = sys.argv[2] if len(sys.argv) > 2 else None
    fn, args = entry(dev)
    print(tuple(fn(*args)["stereo"][0].shape))
    print(dryrun_multichip(n, dev))
    print("dryrun ok")
