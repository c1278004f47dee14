"""A plain float32 reference of the Stereo Diffusion node's Fast path (warp
and inpaint) with Stable Diffusion XL-inpainting: plain PyTorch, importing
nothing of the program and no kernel, so that the program's outputs can be
judged against it on the same weights and inputs.

- The UNet (diffusers/stable-diffusion-xl-1.0-inpainting-0.1
  `unet/config.json`: UNet2DConditionModel, 9 input channels, blocks
  320/640/1280, 2 layers a block, DownBlock2D then two
  CrossAttnDownBlock2D and the mirror going up, transformer depths 1/2/10
  with the mid block 10, 64-d heads (5/10/20 heads), cross-attention width
  2048, `use_linear_projection`, GroupNorm 32), written from diffusers'
  `UNet2DConditionModel` and `Transformer2DModel`: each spatial transformer
  is GroupNorm, a linear proj_in on the H*W tokens, its depth of transformer
  blocks (self-attention, cross-attention over the 77 context tokens, GEGLU
  feed-forward; `sd_plain`'s blocks), a linear proj_out and the input
  added. The text-time conditioning (`addition_embed_type` "text_time",
  `addition_time_embed_dim` 256, `projection_class_embeddings_input_dim`
  2816): the six time ids each through the 256-d sinusoid (flip_sin_to_cos,
  no frequency shift), flattened after the pooled text embedding [B, 1280],
  through `add_embedding` (linear 2816 -> 1280, SiLU, linear 1280 -> 1280)
  and added to the timestep embedding.
- The VAE is `sd_plain`'s AutoencoderKL (`vae/config.json`: blocks
  128/256/512/512, 4 latent channels); latents scaled by the settings'
  `latent_scale`, SDXL's `scaling_factor` 0.13025.
- The scheduler, the warp, its mask, the prefill and the composite are
  `sd_plain`'s (PLMS and the node's Fast path).

Parameter names are the diffusers checkpoint's, key for key (`state_keys`
builds the modules on the meta device). Departures from the published
pipeline (diffusers' `StableDiffusionXLInpaintPipeline`), besides
`sd_plain`'s, each the Stereo Diffusion node's own choice:

- the scheduler is the node's PNDM (PLMS) with its strength skipping, in
  place of the repository's EulerDiscreteScheduler;
- the text conditioning is given as embeddings, a [1, 77, 2048] sequence
  and a [1, 1280] pooled embedding per prompt, with no text encoder here;
  the unconditional half of the guidance takes the embeddings of "" (the
  node's conditioning), not diffusers' zeroed negative embeddings;
- the time ids are (frame height, frame width, 0, 0, height, width): the
  frame comes at the model's sample size, its own original size, with no
  crop, and both halves of the guidance take them.

TF32 is turned off at import (here and in `sd_plain`), so float32 products run in
float32 on a card.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereo_bench.reference import sd_plain
from stereo_bench.reference.sd_plain import (BasicTransformerBlock, Downsample2D,
                                             ResnetBlock2D, TimestepEmbedding, Upsample2D,
                                             timestep_embedding)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# The UNet
# ---------------------------------------------------------------------------

class Transformer2D(nn.Module):
    """diffusers' Transformer2DModel with `use_linear_projection`: GroupNorm,
    linear proj_in on the H*W tokens, `depth` transformer blocks, linear
    proj_out, back to NCHW, plus the input."""

    def __init__(self, dim: int, heads: int, context_dim: int, groups: int, depth: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, dim, 1e-6)
        self.proj_in = nn.Linear(dim, dim)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(dim, heads, context_dim) for _ in range(depth)])
        self.proj_out = nn.Linear(dim, dim)

    def forward(self, x, context):
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        for blk in self.transformer_blocks:
            t = blk(t, context)
        return self.proj_out(t).reshape(b, h, w, c).permute(0, 3, 1, 2) + x


def _attention_levels(cfg: Dict) -> list:
    return [kind == "CrossAttnDownBlock2D" for kind in cfg["down_block_types"]]


class _UNetBlock(nn.Module):
    """A down or up block: its resnets, its transformers where the level has
    attention, and its down- or upsampler."""

    def __init__(self, ins: Sequence[int], dim: int, cfg: Dict, level: int, temb_dim: int,
                 sampler: str):
        super().__init__()
        groups = cfg["norm_num_groups"]
        self.resnets = nn.ModuleList([ResnetBlock2D(c, dim, groups, 1e-5, temb_dim) for c in ins])
        if _attention_levels(cfg)[level]:
            self.attentions = nn.ModuleList([
                Transformer2D(dim, cfg["attention_head_dim"][level], cfg["cross_attention_dim"],
                              groups, cfg["transformer_layers_per_block"][level]) for _ in ins])
        if sampler == "down":
            self.downsamplers = nn.ModuleList([Downsample2D(dim)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([Upsample2D(dim)])

    def layer(self, i, x, temb, context):
        x = self.resnets[i](x, temb)
        return self.attentions[i](x, context) if hasattr(self, "attentions") else x


class _UNetMid(nn.Module):
    """UNetMidBlock2DCrossAttn: resnet, the deepest level's transformer
    depth, resnet."""

    def __init__(self, dim: int, cfg: Dict, temb_dim: int):
        super().__init__()
        groups = cfg["norm_num_groups"]
        self.resnets = nn.ModuleList([ResnetBlock2D(dim, dim, groups, 1e-5, temb_dim)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2D(dim, cfg["attention_head_dim"][-1], cfg["cross_attention_dim"],
                          groups, cfg["transformer_layers_per_block"][-1])])

    def forward(self, x, temb, context):
        return self.resnets[1](self.attentions[0](self.resnets[0](x, temb), context), temb)


class UNet(nn.Module):
    """UNet2DConditionModel of SDXL: cross-attention on the levels that
    `down_block_types` names, mirrored going up, each transformer its
    level's depth; `layers_per_block` resnets down and one more up, each up
    layer taking the matching skip; the text-time embedding added to the
    timestep embedding; eps out. `cfg` holds the published keys
    (in_channels, out_channels, block_out_channels, layers_per_block,
    cross_attention_dim, attention_head_dim: the head counts,
    norm_num_groups, down_block_types, transformer_layers_per_block,
    addition_time_embed_dim, projection_class_embeddings_input_dim)."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        chans, n, layers = list(cfg["block_out_channels"]), len(cfg["block_out_channels"]), \
            cfg["layers_per_block"]
        temb_dim = 4 * chans[0]
        self.time_embedding = TimestepEmbedding(chans[0], temb_dim)
        self.add_embedding = TimestepEmbedding(cfg["projection_class_embeddings_input_dim"],
                                               temb_dim)
        self.conv_in = nn.Conv2d(cfg["in_channels"], chans[0], 3, padding=1)
        skips, prev = [chans[0]], chans[0]
        self.down_blocks = nn.ModuleList()
        for i, ch in enumerate(chans):
            last = i == n - 1
            self.down_blocks.append(_UNetBlock([prev] + [ch] * (layers - 1), ch, cfg, i,
                                               temb_dim, "" if last else "down"))
            skips += [ch] * (layers + (0 if last else 1))
            prev = ch
        self.mid_block = _UNetMid(chans[-1], cfg, temb_dim)
        self.up_blocks = nn.ModuleList()
        for i, ch in enumerate(reversed(chans)):
            ins = []
            for _ in range(layers + 1):
                ins.append(prev + skips.pop())
                prev = ch
            self.up_blocks.append(_UNetBlock(ins, ch, cfg, n - 1 - i, temb_dim,
                                             "up" if i < n - 1 else ""))
        self.conv_norm_out = nn.GroupNorm(cfg["norm_num_groups"], chans[0], 1e-5)
        self.conv_out = nn.Conv2d(chans[0], cfg["out_channels"], 3, padding=1)

    def forward(self, x, t: int, context, text_embeds, time_ids):
        chans, b = self.cfg["block_out_channels"], x.shape[0]
        tt = torch.full((b,), float(t), dtype=torch.float32, device=x.device)
        temb = self.time_embedding(timestep_embedding(tt, chans[0]))
        ids = timestep_embedding(time_ids.reshape(-1), self.cfg["addition_time_embed_dim"])
        temb = temb + self.add_embedding(torch.cat([text_embeds, ids.reshape(b, -1)], dim=-1))
        x = self.conv_in(x)
        skips = [x]
        for blk in self.down_blocks:
            for i in range(len(blk.resnets)):
                x = blk.layer(i, x, temb, context)
                skips.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                skips.append(x)
        x = self.mid_block(x, temb, context)
        for blk in self.up_blocks:
            for i in range(len(blk.resnets)):
                x = blk.layer(i, torch.cat([x, skips.pop()], dim=1), temb, context)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


VAE = sd_plain.VAE
state_keys = sd_plain.state_keys
loaded = sd_plain.loaded


# ---------------------------------------------------------------------------
# The node's Fast path
# ---------------------------------------------------------------------------

@torch.no_grad()
def inpaint(unet: UNet, vae: VAE, context: torch.Tensor, pooled: torch.Tensor,
            time_ids: torch.Tensor, image: torch.Tensor, mask: torch.Tensor, steps: int,
            strength: float, guidance: float, seed: int, scale: float) -> torch.Tensor:
    """The masked region of one frame generated anew: image [1, H, W, 3] in
    [0, 1] (the prefilled warp), mask [1, H, W]; context [2, 77, width],
    pooled [2, pooled width] and time_ids [2, 6] (unconditional,
    conditional); latents scaled by `scale`. Returns the decoded image in
    [0, 1]."""
    x = image.permute(0, 3, 1, 2) * 2.0 - 1.0
    m = mask[:, None].float()
    lat = vae.encode(x) * scale
    lh, lw = lat.shape[-2:]
    m_lat = (F.interpolate(m, size=(lh, lw), mode="bilinear", align_corners=False,
                           antialias=True) > 0.1).float()
    masked = vae.encode(x * (1.0 - (m > 0.5).float())) * scale
    extra = torch.cat([m_lat, masked], dim=1)
    sched = sd_plain.PLMS(steps)
    ts = sched.strength_timesteps(steps, strength)
    latents = sched.add_noise(lat, sd_plain.frame_noise(seed, lat.shape[1:], lat.device)[None],
                              ts[0])
    for t in ts:
        inp = torch.cat([torch.cat([latents] * 2), torch.cat([extra] * 2)], dim=1)
        eps_u, eps_c = unet(inp, t, context, pooled, time_ids).chunk(2)
        latents = sched.step(eps_u + guidance * (eps_c - eps_u), t, latents)
    out = vae.decode(latents / scale)
    return torch.clamp(out.permute(0, 2, 3, 1) / 2.0 + 0.5, 0.0, 1.0)


def time_ids(size: Tuple[int, int], device) -> torch.Tensor:
    """[2, 6]: (height, width, 0, 0, height, width) for both halves."""
    h, w = size
    return torch.tensor([[h, w, 0.0, 0.0, h, w]] * 2, dtype=torch.float32, device=device)


@torch.no_grad()
def fast_path(unet: UNet, vae: VAE, embed: Callable[[str], Tuple[torch.Tensor, torch.Tensor]],
              image: torch.Tensor, depth_map: torch.Tensor, settings: Dict,
              seed: int) -> Dict[str, torch.Tensor]:
    """The node's Fast path on one frame: image and depth_map [1, H, W, 3]
    in [0, 1], at the model's sample size; `embed` gives a prompt's
    ([1, 77, width], [1, pooled width]) embeddings. Returns the right eye,
    its gap mask and its prefilled warp."""
    warped, mask = sd_plain.backward_warp(image, sd_plain.luma(depth_map),
                                          float(settings["scale_factor"]))
    filled = sd_plain.prefill(warped, mask)
    (ctx_u, pool_u), (ctx_c, pool_c) = embed(""), embed(settings["prompt"])
    new = inpaint(unet, vae, torch.cat([ctx_u, ctx_c]), torch.cat([pool_u, pool_c]),
                  time_ids(tuple(image.shape[1:3]), image.device), filled, mask,
                  int(settings["num_inference_steps"]), float(settings["denoise_strength"]),
                  float(settings["guidance_scale"]), seed, float(settings["latent_scale"]))
    right = torch.where(mask[..., None], new, filled)
    return {"right": right, "mask": mask, "prefilled": filled}
