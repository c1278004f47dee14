"""The Stereo Diffusion node's Fast path (warp and inpaint), as a ComfyUI
user queues it one image at a time: `StereoDiffusionNode().generate_stereo`
on one frame and its grey depth map (IMAGE tensors, [1, H, W, 3] float32 in
[0, 1] on the host), with the configuration's node settings, on a model
bundle built once at set-up through the program's checkpoint path: the
state dicts normalised (`porting.normalize_state_dict`), checked against the
modules' own (`porting.check_port`) and assembled by
`porting.build_sd_model` in the configuration's dtype, as
`load_sd_from_diffusers_dir` does with a checkpoint on disk. The node takes
the bundle ready-made and returns CPU float32 tensors (the pair, the left
eye, the right eye), so `collect` is the identity.

The weights are data, drawn in float32 from the configuration's
`weight_seed` (`weights`) in the published checkpoint's layout: the keys and
shapes of the plain reference's modules (`reference/sd_plain.py`), which
use the diffusers names; matrix and convolution weights N(0, 1/fan_in),
biases 0, norm scales 1. The program and the reference get the same
tensors. The text conditioning is drawn too (`conditioning`: one [1, 77,
width] embedding per prompt), behind the program's `EmbeddingCache`.

Compared, for the call's frame: `left_max_off`, the largest difference of
the left eye (alone and in the pair) from the input; `mask_off_share`, the
share of pixels where the right eye's gap mask, read from the output as the
pixels that differ from the reference's prefilled warp, differs from the
reference's; `outside_max_off`, the largest difference of the right eye
from the reference's outside the reference's mask; `right_rel_l2`, the
right eye's relative L2 distance from the reference's inside that mask.
The right eye is read alone and from the pair, and each number is the
larger of the two."""
from __future__ import annotations

import math
import sys
import time
import zlib
from typing import Callable, Dict, List

import numpy as np
import torch

from stereo_bench import scenes
from stereo_bench.reference import sd_plain

# The mix's sizes in the harness's own tests on the CPU.
TINY = dict(size=64, distinct=4, frames_per_call=1, check_among=4, trace_calls=2)
# The tiny model: the program's TINY_SD_UNET_CONFIG with 9 input channels
# and TINY_SD_VAE_CONFIG, at the frame size of TINY.
TINY_SETTINGS = dict(
    unet=dict(in_channels=9, out_channels=4, block_out_channels=[32, 64], layers_per_block=1,
              cross_attention_dim=64, attention_head_dim=4, norm_num_groups=8),
    vae=dict(in_channels=3, out_channels=3, latent_channels=4, block_out_channels=[16, 32],
             layers_per_block=1, norm_num_groups=8),
    sample_size=64)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
NODE_ARGS = ("pipeline_mode", "scale_factor", "num_inference_steps", "denoise_strength",
             "guidance_scale", "prompt")
CONTEXT_TOKENS = 77


def inputs(traffic: Dict, seed: int) -> List:
    """`distinct` scenes from one generator seeded `seed`, each as the
    node's IMAGE pair (image, grey depth as three equal channels), with
    its index, which picks the node's seed."""
    rng = np.random.default_rng(seed)
    s = traffic["size"]
    out = []
    for k in range(traffic["distinct"]):
        rgb, dep = scenes.scene(rng, s, s)
        image = torch.from_numpy(rgb).float()[None] / 255.0
        depth = torch.from_numpy(dep).float()[None, ..., None].expand(1, s, s, 3) / 255.0
        out.append((image, depth.contiguous(), k))
    return out


def weights(settings: Dict, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The UNet's and the VAE's float32 state dicts, drawn on `device` from
    a generator seeded with the configuration's `weight_seed`, in the
    reference modules' key order: N(0, 1/fan_in) for every weight of two
    or more axes, 0 for biases, 1 for norm scales. On the meta device the
    tensors have their shapes and hold nothing."""
    device = torch.device(device)
    gen = (None if device.type == "meta" else
           torch.Generator(device=device).manual_seed(int(settings["weight_seed"])))
    out = {}
    for key, cls in (("unet", sd_plain.UNet), ("vae", sd_plain.VAE)):
        state = {}
        for name, shape in sd_plain.state_keys(cls, settings[key]).items():
            if len(shape) >= 2:
                std = 1.0 / math.sqrt(math.prod(shape[1:]))
                state[name] = torch.randn(shape, generator=gen, device=device) * std
            elif name.endswith("bias"):
                state[name] = torch.zeros(shape, device=device)
            else:
                state[name] = torch.ones(shape, device=device)
        out[key] = state
    return out


def conditioning(settings: Dict, text: str, device) -> torch.Tensor:
    """The prompt's text embedding, [1, 77, cross-attention width] float32
    N(0, 1) (of the order of CLIP's final layer norm), from a CPU generator
    seeded with `weight_seed` and the prompt's crc32."""
    seed = int(settings["weight_seed"]) * 2 ** 32 + zlib.crc32(text.encode("utf-8"))
    gen = torch.Generator().manual_seed(seed)
    width = int(settings["unet"]["cross_attention_dim"])
    return torch.randn((1, CONTEXT_TOKENS, width), generator=gen).to(device)


def _bundle(settings: Dict, device):
    """The program's model bundle from the drawn weights, through its
    checkpoint path."""
    from comfystereo_tpu_torch.diffusion import porting
    from comfystereo_tpu_torch.diffusion.sd_unet import SDUNet, SDUNetConfig
    from comfystereo_tpu_torch.diffusion.sd_vae import SDVAE, SDVAEConfig
    from comfystereo_tpu_torch.utils.caching import EmbeddingCache

    def config(cls, d):
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})

    t0 = time.perf_counter()
    drawn = weights(settings, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    unet_cfg = config(SDUNetConfig, settings["unet"])
    vae_cfg = config(SDVAEConfig, settings["vae"])
    unet_sd = porting.normalize_state_dict(drawn.pop("unet"))
    vae_sd = porting.normalize_state_dict(drawn.pop("vae"))
    porting.check_port(porting._meta_state(SDUNet, unet_cfg), unet_sd)
    porting.check_port(porting._meta_state(SDVAE, vae_cfg), vae_sd)
    dtype = DTYPES[settings["dtype"]]
    bundle = porting.build_sd_model(
        unet_cfg, vae_cfg, dtype=dtype, device=device, unet_state=unet_sd, vae_state=vae_sd,
        text_encode=EmbeddingCache(lambda text: conditioning(settings, text, device)))
    del unet_sd, vae_sd
    bundle.sample_size = int(settings["sample_size"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    print(f"stereo_diffusion_node: weights drawn in {t1 - t0:.3f} s, bundle built in "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)
    return bundle


def _node_call(settings: Dict, device, bundle) -> Callable:
    from comfystereo_tpu_torch.nodes.stereodiffusion import StereoDiffusionNode
    node = StereoDiffusionNode()
    kw = {k: settings[k] for k in NODE_ARGS}

    def submit(inp):
        image, depth, k = inp
        return node.generate_stereo(image, depth, model=bundle, device=device,
                                    seed=int(settings["seed"]) + k, **kw)
    return submit


def program(settings: Dict, device) -> Callable:
    """The timed call: the node on the frame, with the bundle built here."""
    return _node_call(settings, device, _bundle(settings, device))


def collect(out):
    """The node's outputs, already CPU tensors."""
    return out


E4M3_MAX = 448.0  # the largest finite float8 e4m3 value


def _e4m3(t: torch.Tensor, dims) -> torch.Tensor:
    """`t` rounded to float8 e4m3 at a scale that puts the absmax over
    `dims` at the format's largest value, and scaled back."""
    scale = t.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _e4m3_operands_(module: torch.nn.Module) -> torch.nn.Module:
    """Every linear layer and convolution below `module` computing from
    float8 e4m3 operands, as fp8 inference runs them: its weight rounded
    once at a scale per output channel, its input at each call at one
    scale for the tensor; products and sums stay float32."""
    def rounded_input(layer, args):
        x = args[0]
        return (_e4m3(x, tuple(range(x.dim()))), *args[1:])

    for layer in module.modules():
        if isinstance(layer, (torch.nn.Linear, torch.nn.Conv2d)):
            w = layer.weight
            w.copy_(_e4m3(w, tuple(range(1, w.dim()))))
            layer.register_forward_pre_hook(rounded_input)
    return module


def control(settings: Dict, kind: str, device) -> Callable:
    """`reference:operands=float8_e4m3`: the plain reference in the
    program's place, computed one precision below the configuration's
    bf16: every linear layer and convolution of its UNet and VAE takes
    float8 e4m3 operands (`_e4m3_operands_`); the attention products, the
    norms, the scheduler, the warp and the composite stay float32. It
    returns the node's outputs: the pair, the left eye (the input) and the
    right eye."""
    if kind != "reference:operands=float8_e4m3":
        raise ValueError(f"unknown control {kind!r}")
    drawn = weights(settings, device)
    unet = _e4m3_operands_(sd_plain.loaded(sd_plain.UNet, settings["unet"], drawn["unet"]))
    vae = _e4m3_operands_(sd_plain.loaded(sd_plain.VAE, settings["vae"], drawn["vae"]))
    del drawn

    def submit(inp):
        image, depth, k = inp
        got = sd_plain.fast_path(unet, vae, lambda text: conditioning(settings, text, device),
                                 image.to(device), depth.to(device), settings,
                                 int(settings["seed"]) + k)
        right = got["right"].cpu()
        return torch.cat([image, right], dim=2), image, right
    return submit


def reference(settings: Dict, inp, device, frames: List[int]) -> Dict[str, torch.Tensor]:
    """The reference's Fast path on the call's frame, on the host: the input
    image, the right eye, its gap mask and its prefilled warp. The weights
    are drawn again from the seed: the same tensors as the program's."""
    image, depth, k = inp
    drawn = weights(settings, device)
    unet = sd_plain.loaded(sd_plain.UNet, settings["unet"], drawn["unet"])
    vae = sd_plain.loaded(sd_plain.VAE, settings["vae"], drawn["vae"])
    got = sd_plain.fast_path(unet, vae, lambda text: conditioning(settings, text, device),
                             image.to(device), depth.to(device), settings,
                             int(settings["seed"]) + k)
    out = {name: t.cpu()[frames] for name, t in got.items()}
    out["image"] = image[frames]
    return out


def select(out, frames: List[int]):
    return tuple(t[frames] for t in out)


def _finite(x: float, worst: float) -> float:
    return x if math.isfinite(x) else worst


def compare(out, exp: Dict[str, torch.Tensor]) -> Dict[str, float]:
    pair, left, right = out
    image, mask = exp["image"], exp["mask"]
    w = image.shape[2]
    worst = {"left_max_off": 1e9, "mask_off_share": 1.0, "outside_max_off": 1e9,
             "right_rel_l2": 1e9}
    if (tuple(left.shape) != tuple(image.shape) or tuple(right.shape) != tuple(image.shape)
            or tuple(pair.shape) != (image.shape[0], image.shape[1], 2 * w, image.shape[3])):
        return worst
    numbers = {"left_max_off": max(float((left - image).abs().max()),
                                   float((pair[:, :, :w] - image).abs().max()))}
    inside = mask[..., None].expand(exp["right"].shape)
    ref_in = exp["right"][inside].double()
    for eye in (right, pair[:, :, w:]):
        read = {
            "mask_off_share": float(((eye != exp["prefilled"]).any(-1) != mask).float().mean()),
            "outside_max_off": float((eye - exp["right"])[~inside].abs().max())
            if bool((~inside).any()) else 0.0,
            "right_rel_l2": float((eye[inside].double() - ref_in).norm() / ref_in.norm())
            if ref_in.numel() else 0.0}
        for k, v in read.items():
            numbers[k] = max(numbers.get(k, v), v)
    return {k: _finite(v, worst[k]) for k, v in numbers.items()}


def _eps_left_out(monkeypatch):
    """The third UNet call's eps left out of its step: the PNDM step reuses
    the eps of the call before."""
    from comfystereo_tpu_torch.diffusion import schedulers
    real = schedulers.pndm_scan_step
    last = {}

    def step(sched, i, t, ets, cur, eps, sample):
        if int(i) == 2:
            eps = last["eps"]
        last["eps"] = eps
        return real(sched, i, t, ets, cur, eps, sample)
    monkeypatch.setattr(schedulers, "pndm_scan_step", step)


def _prefill_returned(monkeypatch):
    """The inpainting left out: the right eye is the prefilled warp."""
    from comfystereo_tpu_torch.diffusion import sd_pipeline
    monkeypatch.setattr(sd_pipeline, "diffusion_inpaint", lambda model, image, *a, **kw: image)


def _composite_everywhere(monkeypatch):
    """The composite applied outside the mask too: the inpainted image over
    the whole right eye."""
    from comfystereo_tpu_torch.diffusion import sd_pipeline
    real = sd_pipeline._composite
    monkeypatch.setattr(sd_pipeline, "_composite",
                        lambda inpainted, prefilled, mask: real(inpainted, prefilled,
                                                                torch.ones_like(mask)))


# The faults of the Fast path, each planted underneath the timed call by
# `fault(monkeypatch)`: with any one of them a run has to read not correct.
FAULTS = (_eps_left_out, _prefill_returned, _composite_everywhere)
