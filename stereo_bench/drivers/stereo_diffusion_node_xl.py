"""The Stereo Diffusion node's Fast path (warp and inpaint) with an
SDXL-inpainting model, as a ComfyUI user queues it one image at a time:
`StereoDiffusionNode().generate_stereo` on one frame and its grey depth map,
with the configuration's node settings, on a model bundle built once at
set-up through the program's checkpoint path, as
`stereo_diffusion_node.py` builds SD 1.5's: the state dicts normalised
(`porting.normalize_state_dict`), checked against the modules' own
(`porting.check_port`) and assembled by `porting.build_sd_model` in the
configuration's dtype (the bundle takes SDXL's latent scale from its
UNet). The node returns CPU float32 tensors (the pair, the left eye, the
right eye).

The weights are data, drawn in float32 from the configuration's
`weight_seed` (`weights`) by the SD driver's convention (matrix and
convolution weights N(0, 1/fan_in), biases 0, norm scales 1) in the keys and
shapes of the plain reference's modules (`reference/sdxl_plain.py`), which
use the diffusers names. The text conditioning is drawn too
(`conditioning`: per prompt a [1, 77, 2048] embedding and a [1, 1280]
pooled embedding, N(0, 1)), behind the program's `EmbeddingCache`s. The
program and the reference get the same tensors.

The inputs, the numbers compared and three of the faults are the SD
driver's (`stereo_diffusion_node.py`); two faults more break what SDXL
adds: its text-time conditioning zeroed, and its deep transformer stacks
cut to their first block."""
from __future__ import annotations

import math
import sys
import time
import zlib
from typing import Callable, Dict, List, Tuple

import torch

from stereo_bench.drivers.stereo_diffusion_node import (  # noqa: F401
    CONTEXT_TOKENS, DTYPES, NODE_ARGS, _composite_everywhere, _e4m3_operands_,
    _eps_left_out, _prefill_returned, collect, compare, inputs, select)
from stereo_bench.reference import sdxl_plain

# The mix's sizes in the harness's own tests on the CPU: a 128x128 frame,
# so that a level with attention has the 1,024 tokens the flash route takes.
TINY = dict(size=128, distinct=4, frames_per_call=1, check_among=4, trace_calls=2)
# The tiny model: SDXL's topology (no attention on the first level, a
# transformer depth of 1 and 2 on the others, linear projections, the
# text-time embedding, 9 input channels) at tiny widths, 16-d heads, and
# the SD driver's tiny VAE.
TINY_SETTINGS = dict(
    unet=dict(in_channels=9, out_channels=4, block_out_channels=[32, 64, 64],
              layers_per_block=2, cross_attention_dim=32, attention_head_dim=[2, 4, 4],
              norm_num_groups=8,
              down_block_types=["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
              transformer_layers_per_block=[1, 1, 2], use_linear_projection=True,
              addition_embed_type="text_time", addition_time_embed_dim=8,
              projection_class_embeddings_input_dim=64),
    vae=dict(in_channels=3, out_channels=3, latent_channels=4, block_out_channels=[16, 32],
             layers_per_block=1, norm_num_groups=8),
    sample_size=128)

TIME_IDS = 6


def pooled_width(unet: Dict) -> int:
    """The pooled text embedding's width: `add_embedding`'s input less the
    six time ids' sinusoids (1280 for SDXL)."""
    return (unet["projection_class_embeddings_input_dim"]
            - TIME_IDS * unet["addition_time_embed_dim"])


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
    for key, cls in (("unet", sdxl_plain.UNet), ("vae", sdxl_plain.VAE)):
        state = {}
        for name, shape in sdxl_plain.state_keys(cls, settings[key]).items():
            if len(shape) >= 2:
                std = 1.0 / math.sqrt(math.prod(shape[1:]))
                state[name] = torch.randn(shape, generator=gen, device=device) * std
            elif name.endswith("bias"):
                state[name] = torch.zeros(shape, device=device)
            else:
                state[name] = torch.ones(shape, device=device)
        out[key] = state
    return out


def conditioning(settings: Dict, text: str, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prompt's text embedding, [1, 77, cross-attention width], and its
    pooled embedding, [1, pooled width], float32 N(0, 1), in that order from
    a CPU generator seeded with `weight_seed` and the prompt's crc32."""
    seed = int(settings["weight_seed"]) * 2 ** 32 + zlib.crc32(text.encode("utf-8"))
    gen = torch.Generator().manual_seed(seed)
    unet = settings["unet"]
    ctx = torch.randn((1, CONTEXT_TOKENS, int(unet["cross_attention_dim"])), generator=gen)
    pooled = torch.randn((1, pooled_width(unet)), generator=gen)
    return ctx.to(device), pooled.to(device)


def _bundle(settings: Dict, device):
    """The program's model bundle from the drawn weights, through its
    checkpoint path."""
    from comfystereo_tpu_torch.diffusion import porting
    from comfystereo_tpu_torch.diffusion.sd_unet import SDUNet, SDUNetConfig
    from comfystereo_tpu_torch.diffusion.sd_vae import SDVAE, SDVAEConfig
    from comfystereo_tpu_torch.utils.caching import EmbeddingCache

    def config(cls, d):
        return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})

    # The configurations first: a program whose UNet lacks SDXL's fields
    # stops here, before any weight is drawn.
    unet_cfg = config(SDUNetConfig, settings["unet"])
    vae_cfg = config(SDVAEConfig, settings["vae"])
    t0 = time.perf_counter()
    drawn = weights(settings, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    unet_sd = porting.normalize_state_dict(drawn.pop("unet"))
    vae_sd = porting.normalize_state_dict(drawn.pop("vae"))
    porting.check_port(porting._meta_state(SDUNet, unet_cfg), unet_sd)
    porting.check_port(porting._meta_state(SDVAE, vae_cfg), vae_sd)
    bundle = porting.build_sd_model(
        unet_cfg, vae_cfg, dtype=DTYPES[settings["dtype"]], device=device, unet_state=unet_sd,
        vae_state=vae_sd,
        text_encode=EmbeddingCache(lambda text: conditioning(settings, text, device)[0]),
        pooled_encode=EmbeddingCache(lambda text: conditioning(settings, text, device)[1]))
    del unet_sd, vae_sd
    bundle.sample_size = int(settings["sample_size"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    print(f"stereo_diffusion_node_xl: weights drawn in {t1 - t0:.3f} s, bundle built in "
          f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)
    return bundle


def program(settings: Dict, device) -> Callable:
    """The timed call: the node on the frame, with the bundle built here."""
    from comfystereo_tpu_torch.nodes.stereodiffusion import StereoDiffusionNode
    bundle = _bundle(settings, device)
    node = StereoDiffusionNode()
    kw = {k: settings[k] for k in NODE_ARGS}

    def submit(inp):
        image, depth, k = inp
        return node.generate_stereo(image, depth, model=bundle, device=device,
                                    seed=int(settings["seed"]) + k, **kw)
    return submit


def _fast_path(settings: Dict, inp, device, unet, vae) -> Dict[str, torch.Tensor]:
    image, depth, k = inp
    return sdxl_plain.fast_path(unet, vae, lambda text: conditioning(settings, text, device),
                                image.to(device), depth.to(device), settings,
                                int(settings["seed"]) + k)


def _reference_models(settings: Dict, device, operands_e4m3: bool = False):
    drawn = weights(settings, device)
    models = [sdxl_plain.loaded(cls, settings[key], drawn.pop(key))
              for key, cls in (("unet", sdxl_plain.UNet), ("vae", sdxl_plain.VAE))]
    return [_e4m3_operands_(m) for m in models] if operands_e4m3 else models


def control(settings: Dict, kind: str, device) -> Callable:
    """`reference:operands=float8_e4m3`: the plain reference in the
    program's place, computed one precision below the configuration's
    bf16: every linear layer and convolution of its UNet (the text-time
    embedding's included) and VAE takes float8 e4m3 operands
    (`_e4m3_operands_`); the attention products, the norms, the scheduler,
    the warp and the composite stay float32. It returns the node's outputs:
    the pair, the left eye (the input) and the right eye."""
    if kind != "reference:operands=float8_e4m3":
        raise ValueError(f"unknown control {kind!r}")
    unet, vae = _reference_models(settings, device, operands_e4m3=True)

    def submit(inp):
        right = _fast_path(settings, inp, device, unet, vae)["right"].cpu()
        return torch.cat([inp[0], right], dim=2), inp[0], right
    return submit


def reference(settings: Dict, inp, device, frames: List[int]) -> Dict[str, torch.Tensor]:
    """The reference's Fast path on the call's frame: the input image, the
    right eye, its gap mask and its prefilled warp. The weights are drawn
    again from the seed: the same tensors as the program's."""
    unet, vae = _reference_models(settings, device)
    got = _fast_path(settings, inp, device, unet, vae)
    out = {name: t.cpu()[frames] for name, t in got.items()}
    out["image"] = inp[0][frames]
    return out


def _added_cond_zeroed(monkeypatch):
    """SDXL's text-time conditioning left out: the pooled embeddings and the
    time ids that every UNet call of the inpainting loop takes are zeros."""
    from comfystereo_tpu_torch.diffusion import sd_pipeline
    real = sd_pipeline._text_time
    monkeypatch.setattr(sd_pipeline, "_text_time", lambda *a: {
        k: torch.zeros_like(v) for k, v in real(*a).items()})


def _stacks_cut(monkeypatch):
    """The deep transformer stacks cut: each spatial transformer runs only
    its first transformer block."""
    from comfystereo_tpu_torch.diffusion import sd_unet
    real = sd_unet.Transformer2D.forward

    def first_block_only(self, x, context, **kw):
        blocks = self.transformer_blocks
        self.transformer_blocks = blocks[:1]
        try:
            return real(self, x, context, **kw)
        finally:
            self.transformer_blocks = blocks
    monkeypatch.setattr(sd_unet.Transformer2D, "forward", first_block_only)


# The faults of the Fast path, each planted underneath the timed call by
# `fault(monkeypatch)`: with any one of them a run has to read not correct.
FAULTS = (_eps_left_out, _prefill_returned, _composite_everywhere, _added_cond_zeroed,
          _stacks_cut)
