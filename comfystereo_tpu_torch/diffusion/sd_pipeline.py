"""StereoDiffusion generation pipelines: Standard (DDIM) and Fast (warp +
inpaint).

Port of `comfystereo_tpu/diffusion/sd_pipeline.py`. Two paths:

1. `text2stereo`, the Standard path: DDIM inversion with optional null-text
   optimisation (`inversion.py`), then a CFG denoising loop in which every
   self-attention runs Bilateral-Neighbor attention from 20% of the steps
   on, the left latent is depth-shifted to seed the right latent at that
   step (holes optionally refilled with fresh noise, "deblur"), and the
   shift is re-applied inside its mask every further 20% of the steps.
2. `warp_inpaint`, the Fast path: backward-warp the right eye, detect
   disocclusions (warped-depth comparison, 3x3 dilation, out-of-bounds),
   prefill the gaps by horizontal border interpolation, diffusion-inpaint
   the masked region with PNDM, and recomposite inside the mask only.

The JAX package's scanned device programs become plain host loops over the
timestep lists; the frames of a Fast batch run together.

Random draws: `torch.Generator`s on the CPU, so a seed gives the same noise
on every device (the values are not `jax.random`'s): one per frame, seeded
`seed + frame_idx` by the node, for the Fast path; one seeded `seed` for the
Standard path's deblur noise. Each path takes its noise as an argument too
(`noise=`), so tests can feed the JAX package's draws.

The Fast path's stages are spans (`utils.profiling.span`), one per stage:
`diffusion.warp_inpaint` around the frames' whole pass, and in it
`diffusion.warp` (the backward warp, its mask and the prefill),
`diffusion.vae_encode` (each of the two encodes), `diffusion.unet` (each
UNet call of the inpainting loop), `diffusion.scheduler` (each step's
guidance and PNDM step), `diffusion.vae_decode` and `diffusion.composite`.
With a bundle whose UNet takes SDXL's text-time conditioning,
`diffusion.add_cond` (in `diffusion.warp_inpaint`, before the encodes)
builds the pooled text embeddings and the time ids for both halves of the
guidance, which every UNet call of the loop takes. The module counts the
`FRAMES` through `warp_inpaint`, and the `UNET_CALLS` of the inpainting
loop with their latent `UNET_ROWS`, the guidance's doubling included, and
the `ADDED_COND_CALLS` among them that carried text-time conditioning.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import depth as depth_ops
from ..ops import scan as scan_ops
from ..utils.profiling import span
from . import schedulers
from .adapters import detect_model_type
from .attention import AttentionMode
from .inversion import image_to_latent, invert, latent_to_image
from .models import DiffusionModel
from .stereo_latent import stereo_shift_with_mask

# (init_noise [B, C, h, w], step_noise [n, B, C, h, w] or None)
Noise = Tuple[torch.Tensor, Optional[torch.Tensor]]

FRAMES = 0  # frames through warp_inpaint
UNET_CALLS = 0  # UNet calls of the inpainting loop
UNET_ROWS = 0  # latent rows through them (both halves of the guidance's batch)
ADDED_COND_CALLS = 0  # those of them that carried text-time conditioning (SDXL)


class StereoResult(NamedTuple):
    left: torch.Tensor     # [B, H, W, 3] float 0-1
    right: torch.Tensor


def _to_01(img_nchw: torch.Tensor) -> torch.Tensor:
    return torch.clamp(img_nchw.permute(0, 2, 3, 1) / 2.0 + 0.5, 0, 1)


def _nan_guard(x: torch.Tensor) -> torch.Tensor:
    """Scrub NaN/inf from decoded images, as the reference does."""
    return torch.nan_to_num(x, nan=0.0, posinf=1.0, neginf=0.0)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, C, H', W'] -> [B, C, h, w], antialiased when it downsamples, as
    `jax.image.resize(..., "bilinear")` is; the identity at the same size."""
    if tuple(x.shape[-2:]) == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=True)


def text2stereo(model: DiffusionModel, image_nchw: torch.Tensor, depth: torch.Tensor,
                prompt: str = "", scale_factor: float = 5.0, direction: str = "uni",
                deblur: bool = True, guidance_scale: float = 7.5,
                num_inference_steps: int = 50, null_text_optimization: bool = False,
                num_inner_steps: int = 10, seed: int = 0, use_cfg: bool = True,
                scheduler: str = "auto",
                noise: Optional[torch.Tensor] = None) -> StereoResult:
    """Standard (DDIM-inversion) StereoDiffusion for one frame.

    image_nchw: [1, 3, H, W] in [-1, 1]; depth: [1, H, W] (any scale).
    scheduler: "auto" picks Euler for SD2-family models (1024-d context)
    and DDIM otherwise, or pass "ddim" / "euler". Inversion is always DDIM;
    for Euler the inverted latent is moved to sigma space at loop entry.
    `noise`: the deblur noise [1, C, h, w] to use instead of the draw from
    a CPU generator seeded `seed`. Returns [1, H, W, 3] images in [0, 1].
    A bundle with text-time conditioning (SDXL) raises NotImplementedError:
    the inversion and its null-text backward do not carry it; such a bundle
    runs the Fast path.
    """
    if model.pooled_encode is not None:
        raise NotImplementedError(
            "Standard (DDIM) mode does not run a UNet with text-time conditioning (SDXL): "
            "its inversion and null-text optimisation do not carry the pooled embedding "
            "and time ids; use Fast (Warp + Inpaint) mode")
    if scheduler == "auto":
        scheduler = "euler" if detect_model_type(model) == "SD2" else "ddim"
    sched = (schedulers.make_euler(num_inference_steps) if scheduler == "euler"
             else schedulers.make_ddim(num_inference_steps))
    inv = invert(model, image_nchw, prompt, num_ddim_steps=num_inference_steps,
                 guidance_scale=guidance_scale, num_inner_steps=num_inner_steps,
                 null_text_optimization=null_text_optimization)
    cond = model.text_encode(prompt)
    with torch.no_grad():
        latents = _denoise_loop(model, sched, inv, cond, depth, scale_factor, direction,
                                deblur, guidance_scale, num_inference_steps, seed, use_cfg,
                                noise)
        images = _nan_guard(_to_01(latent_to_image(model, latents)))
    return StereoResult(left=images[:1], right=images[1:])


def _denoise_loop(model, sched, inv, cond, depth, scale_factor, direction, deblur,
                  guidance_scale, num_steps, seed, use_cfg, noise):
    """The Standard path's CFG denoising loop over [left, right] latents."""
    lh, lw = inv.latents.shape[-2:]
    depth_lat = resize_bilinear(depth.float()[:, None], lh, lw)[:, 0]
    shift_every = max(int(num_steps * 0.2), 1)
    start_step = shift_every
    mode = AttentionMode(stereo=True, direction=direction, use_cfg=use_cfg)

    latents = torch.cat([inv.latents[-1]] * 2, dim=0)            # [2, C, h, w]
    if sched.sigmas is not None:
        # DDIM-inverted latent -> Euler's sigma parameterisation.
        latents = schedulers.to_sigma_space(sched, latents, int(sched.timesteps[0]))
    if deblur and noise is None:
        gen = torch.Generator().manual_seed(int(seed))
        noise = torch.randn(tuple(latents[:1].shape), generator=gen)
    if deblur:
        noise = noise.to(latents.device)
    n_u = inv.uncond_embeddings.shape[0]
    mask = None
    for i in range(num_steps):
        t = int(sched.timesteps[i])
        stereo_active = i >= start_step
        if stereo_active and i % shift_every == 0:
            left = latents[:1]
            shifted, hit = stereo_shift_with_mask(left, depth_lat, float(scale_factor))
            if i == start_step:
                mask = hit[:, None].float()
                right = torch.where(mask > 0.5, shifted, noise) if deblur else shifted
            else:
                right = torch.where(mask > 0.5, shifted, latents[1:])
            latents = torch.cat([left, right], dim=0)
        u = inv.uncond_embeddings[min(i, n_u - 1)]
        ctx = torch.cat([u.repeat_interleave(2, dim=0), cond.repeat_interleave(2, dim=0)],
                        dim=0)
        lat_in = schedulers.scale_model_input(sched, torch.cat([latents] * 2, dim=0), t)
        eps = model.unet_apply(lat_in, t, ctx, mode=mode, stereo_active=stereo_active)
        eps_u, eps_c = eps.chunk(2, dim=0)
        eps = eps_u + guidance_scale * (eps_c - eps_u)
        latents = schedulers.scheduler_step(sched, eps, t, latents)
    return latents


def backward_warp_right(image_nhwc: torch.Tensor, depth: torch.Tensor,
                        divergence: float, exponent: float = 1.0,
                        convergence: float = 0.5):
    """Backward linear warp for the right eye plus the disocclusion mask:
    warped-depth comparison (threshold 0.05), 3x3 max dilation, and
    out-of-bounds union. image [B, H, W, C], depth [B, H, W]."""
    b, h, w, c = image_nhwc.shape
    nd = depth_ops.normalize_depth(depth)
    off = depth_ops.pixel_offsets(nd, (divergence / 100.0) * w, 0.0, exponent,
                                  convergence, prenormalized=True)
    cols = torch.arange(w, dtype=torch.float32, device=image_nhwc.device)
    src_x = cols + off                       # right eye samples at x + offset
    oob = (src_x < 0) | (src_x > w - 1)
    src_c = torch.clamp(src_x, 0.0, w - 1.0)
    i0 = torch.floor(src_c).long()
    i1 = torch.clamp(i0 + 1, max=w - 1)
    fr = src_c - i0.float()

    def take(t, idx):
        return torch.gather(t, 2, idx)

    i0c, i1c = (i[..., None].expand(b, h, w, c) for i in (i0, i1))
    frc = fr[..., None]
    warped = take(image_nhwc, i0c) * (1 - frc) + take(image_nhwc, i1c) * frc
    nd_w = take(nd, i0) * (1 - fr) + take(nd, i1) * fr
    disocc = (nd_w - nd) > 0.05
    dilated = F.max_pool2d(disocc.float()[:, None], 3, stride=1, padding=1)[:, 0] > 0.5
    return warped, dilated | oob


def border_prefill(image_nhwc: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Horizontal border-interpolation prefill of masked pixels: each masked
    pixel blends the nearest valid pixels to its left and right by distance."""
    b, h, w, c = image_nhwc.shape
    valid = ~mask
    chans = image_nhwc.permute(3, 0, 1, 2)                   # [C, B, H, W]
    valid_c = valid[None].expand(chans.shape)
    (lv,), has_l = scan_ops.forward_fill((chans,), valid_c)
    (rv,), has_r = scan_ops.backward_fill((chans,), valid_c)
    has_l, has_r = has_l[0], has_r[0]
    cols = torch.arange(w, dtype=torch.float32, device=image_nhwc.device)
    ld = cols - scan_ops.nearest_true_left(valid).float()
    rd = scan_ops.nearest_true_right(valid).float() - cols
    t = ld / torch.clamp(ld + rd, min=1.0)
    t = torch.where(~has_l, 1.0, t)
    t = torch.where(~has_r, 0.0, t)
    fill = lv * (1 - t) + rv * t
    out = torch.where(mask[None], fill, chans)
    return out.permute(1, 2, 3, 0)


def frame_noise(seeds: Sequence[int], shape, n_steps: int, device) -> Noise:
    """Per-frame noise chains: frame i draws its init noise, then (when
    `n_steps` > 0) one draw per step, from a CPU generator seeded seeds[i]."""
    inits, steps = [], []
    for s in seeds:
        gen = torch.Generator().manual_seed(int(s))
        inits.append(torch.randn(shape, generator=gen))
        steps.append([torch.randn(shape, generator=gen) for _ in range(n_steps)])
    init = torch.stack(inits).to(device)
    if not n_steps:
        return init, None
    return init, torch.stack([torch.stack(s) for s in zip(*steps)]).to(device)


def _inpaint_loop(model: DiffusionModel, sched, ts: Sequence[int], nine_ch: bool,
                  lat0, mask_lat, extra, ctx, init_noise, step_noise,
                  guidance_scale: float, added: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The PLMS inpainting loop over `ts` (host loop, all frames batched).
    `added`: the text-time conditioning of the guidance's two halves
    (`text_embeds` and `time_ids`, each [2, ...]), which every UNet call
    takes; empty for a UNet without it."""
    global UNET_CALLS, UNET_ROWS, ADDED_COND_CALLS
    b = lat0.shape[0]
    latents = schedulers.add_noise(sched, lat0, init_noise, ts[0])
    ctx_b = ctx.repeat_interleave(b, dim=0)                  # [u x B | c x B]
    added_b = {k: v.repeat_interleave(b, dim=0) for k, v in added.items()}
    ets = torch.zeros((4,) + tuple(lat0.shape), dtype=lat0.dtype, device=lat0.device)
    cur = torch.zeros_like(lat0)
    # The known content's noise level is the UPCOMING timestep (-1: clean).
    ts_next = list(ts[1:]) + [-1]
    for i, (t, t_next) in enumerate(zip(ts, ts_next)):
        lat_in = torch.cat([latents] * 2, dim=0)
        if nine_ch:  # [latents | mask | masked-image latents]
            lat_in = torch.cat([lat_in, torch.cat([extra] * 2, dim=0)], dim=1)
        with span("diffusion.unet"):
            eps = model.unet_apply(lat_in, t, ctx_b, **added_b)
        UNET_CALLS += 1
        UNET_ROWS += lat_in.shape[0]
        ADDED_COND_CALLS += bool(added_b)
        with span("diffusion.scheduler"):
            eps_u, eps_c = eps.chunk(2, dim=0)
            eps = eps_u + guidance_scale * (eps_c - eps_u)
            latents, ets, cur = schedulers.pndm_scan_step(sched, i, t, ets, cur, eps,
                                                          latents)
            if not nine_ch:
                known = (schedulers.add_noise(sched, lat0, step_noise[i], t_next)
                         if t_next >= 0 else lat0)
                latents = torch.where(mask_lat, latents, known)
    return latents


def diffusion_inpaint(model: DiffusionModel, image_nchw: torch.Tensor,
                      mask_nchw: torch.Tensor, prompt: str = "",
                      num_inference_steps: int = 20, strength: float = 0.75,
                      guidance_scale: float = 7.5,
                      seed: Union[int, Sequence[int]] = 0,
                      noise: Optional[Noise] = None,
                      original_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inpainting with two model-dependent paths:

    * 9-channel SD-inpainting UNets (`model.unet_in_channels == 2*C + 1`):
      each step's UNet input is [latents | mask | masked-image latents];
    * any other latent diffusion model: masked-latent blending, with the
      known content re-imposed outside the mask at the upcoming noise level
      after every step.

    mask_nchw: [B,1,H,W], 1 = region to regenerate. seed: one int for every
    frame or one per frame. `noise`: (init, steps) to use instead of the
    seeded draws (steps only for the blending path). PNDM (PLMS) with its
    strength-based step skipping. Returns the decoded [-1, 1] NCHW image.

    A bundle with text-time conditioning (SDXL, `model.pooled_encode`)
    gives every UNet call the pooled embeddings of "" and the prompt and
    the time ids (original height and width, crop 0 and 0, target height
    and width), the target being the image's size and the original
    `original_size` (the image's size where it is None), as diffusers'
    SDXL pipelines default them, for both halves of the guidance.
    """
    sched = schedulers.make_pndm(num_inference_steps)
    ctx = torch.cat([model.text_encode(""), model.text_encode(prompt)], dim=0)
    nine_ch = model.unet_in_channels == 2 * model.latent_channels + 1
    added = {}
    if model.pooled_encode is not None:
        with span("diffusion.add_cond"):
            added = _text_time(model, prompt, tuple(image_nchw.shape[-2:]),
                               original_size)

    with span("diffusion.vae_encode"):
        lat0 = image_to_latent(model, image_nchw)
    lh, lw = lat0.shape[-2:]
    mask_lat = resize_bilinear(mask_nchw, lh, lw) > 0.1
    extra = None
    if nine_ch:
        # Masked-image latents: the known content with the hole zeroed out.
        hole = resize_bilinear(mask_nchw, *image_nchw.shape[-2:]) > 0.5
        with span("diffusion.vae_encode"):
            masked_lat0 = image_to_latent(model,
                                          image_nchw * (1.0 - hole.to(image_nchw.dtype)))
        extra = torch.cat([mask_lat.to(lat0.dtype), masked_lat0], dim=1)

    ts = [int(t) for t in schedulers.pndm_skip_timesteps(sched, strength)]
    if noise is None:
        b = lat0.shape[0]
        seeds = np.broadcast_to(np.asarray(seed, np.uint64), (b,))
        noise = frame_noise(seeds, tuple(lat0.shape[1:]), 0 if nine_ch else len(ts),
                            lat0.device)
    latents = _inpaint_loop(model, sched, ts, nine_ch, lat0, mask_lat, extra, ctx,
                            noise[0], noise[1], float(guidance_scale), added)
    with span("diffusion.vae_decode"):
        return latent_to_image(model, latents)


def _text_time(model: DiffusionModel, prompt: str, target: Tuple[int, int],
               original: Optional[Tuple[int, int]]) -> Dict[str, torch.Tensor]:
    """SDXL's added conditioning of the guidance's halves ("" then the
    prompt): `text_embeds` [2, pooled] and `time_ids` [2, 6] float32 on the
    bundle's device."""
    oh, ow = original if original is not None else target
    ids = torch.tensor([[float(oh), float(ow), 0.0, 0.0, float(target[0]),
                         float(target[1])]] * 2, dtype=torch.float32, device=model.device)
    pooled = torch.cat([model.pooled_encode(""), model.pooled_encode(prompt)], dim=0)
    return {"text_embeds": pooled.float(), "time_ids": ids}


def _composite(inpainted: torch.Tensor, prefilled: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """The decoded [-1, 1] NCHW inpainting, as [0, 1] NHWC, inside the mask
    [B, H, W]; the prefilled warp outside it."""
    with span("diffusion.composite"):
        return torch.where(mask[..., None], _nan_guard(_to_01(inpainted)), prefilled)


def warp_inpaint(model: DiffusionModel, image_nhwc: torch.Tensor,
                 depth: torch.Tensor, prompt: str = "",
                 divergence: float = 5.0, num_inference_steps: int = 20,
                 strength: float = 0.75, guidance_scale: float = 7.5,
                 seed: Union[int, Sequence[int]] = 0,
                 noise: Optional[Noise] = None,
                 original_size: Optional[Tuple[int, int]] = None) -> StereoResult:
    """Fast path: warp the right eye, inpaint disocclusions, recomposite in
    pixel space inside the mask only. image [B,H,W,C] in [0, 1], depth
    [B,H,W]; `seed` is one int or one per frame; `original_size`, the
    frames' (height, width) before any resize to the model's size, enters
    SDXL's time ids (`diffusion_inpaint`)."""
    global FRAMES
    with span("diffusion.warp_inpaint"):
        with span("diffusion.warp"):
            warped, mask = backward_warp_right(image_nhwc, depth, divergence)
            prefilled = border_prefill(warped, mask)
            img_nchw = prefilled.permute(0, 3, 1, 2) * 2.0 - 1.0
        inpainted = diffusion_inpaint(
            model, img_nchw, mask[:, None].float(), prompt, num_inference_steps,
            strength, guidance_scale, seed, noise, original_size)
        right = _composite(inpainted, prefilled, mask)
    FRAMES += image_nhwc.shape[0]
    return StereoResult(left=image_nhwc, right=right)
