"""A plain float32 reference of the Stereo Diffusion node's Fast path (warp
and inpaint) with Stable Diffusion 1.5-inpainting: plain PyTorch, importing
nothing of the program and no kernel, so that the program's outputs can be
judged against it on the same weights and inputs.

- The UNet (runwayml/stable-diffusion-inpainting `unet/config.json`:
  UNet2DConditionModel, 9 input channels, blocks 320/640/1280/1280, 2
  layers a block, 8 heads, cross-attention width 768, GroupNorm 32):
  ResNet blocks, spatial transformers with self- and cross-attention
  written out as softmax(Q K^T / sqrt(d)) V, GEGLU feed-forward, strided
  convolutions down and nearest 2x then a convolution up.
- The VAE (`vae/config.json`: AutoencoderKL, blocks 128/256/512/512, 4
  latent channels), its encoder giving the latent mean and its decoder,
  each with its single-head mid attention; latents scaled by 0.18215.
- PNDM in its PLMS form (`scheduler/scheduler_config.json`: scaled-linear
  betas 0.00085-0.012, `skip_prk_steps`, `steps_offset` 1,
  `set_alpha_to_one` false), the published `step_plms` with its list of
  past eps, and the inpainting pipeline's strength skipping: the last
  int(steps * strength) + 1 timesteps of the PLMS list.
- The node's Fast path: the depth map's luma (0.2989, 0.5870, 0.1140), the
  right eye's backward warp at x + offset (depth normalised per image,
  offset (d - 0.5) * divergence% of the width), its disocclusion mask (the
  warped depth above the depth by more than 0.05, dilated 3x3, with the
  samples outside the frame), each masked pixel prefilled from the nearest
  unmasked pixels on its row by distance, the masked region inpainted with
  classifier-free guidance, and the composite inside the mask only.

Parameter names are the diffusers checkpoint's, key for key (`state_keys`
builds the modules on the meta device). Departures from the published
pipelines, each the Stereo Diffusion node's own choice:

- the masked-image latents are the VAE's latent mean, not a sample of it;
- the mask is brought to the latent size by antialiased bilinear
  resampling and taken where it exceeds 0.1 (diffusers' inpainting
  pipeline resamples it by nearest neighbour);
- the pixel-space hole of the masked image is the mask itself (the mask
  above 0.5), and the decoded image is scaled to [0, 1] and clamped;
- each frame's initial noise is drawn from a CPU `torch.Generator` seeded
  with the frame's seed, the latent's shape without the batch;
- the text conditioning is given as embeddings ([1, 77, width] per prompt),
  with no text encoder here.

TF32 is turned off at import, so float32 products run in float32 on a card.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LATENT_SCALE = 0.18215
LUMA = (0.2989, 0.5870, 0.1140)
DISOCCLUSION = 0.05  # warped depth above the depth by more than this (normalised)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """softmax(Q K^T / sqrt(d)) V per head; q [B, N, C], k and v [B, M, C]."""
    b, n, c = q.shape
    d = c // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2)

    w = torch.softmax(torch.matmul(split(q), split(k).transpose(-1, -2)) / math.sqrt(d), dim=-1)
    return torch.matmul(w, split(v)).transpose(1, 2).reshape(b, n, c)


class ResnetBlock2D(nn.Module):
    """GroupNorm, SiLU, 3x3 conv, plus the time embedding's projection;
    GroupNorm, SiLU, 3x3 conv; a 1x1 shortcut where the width changes."""

    def __init__(self, cin: int, cout: int, groups: int, eps: float, temb_dim: int = 0):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        if temb_dim:
            self.time_emb_proj = nn.Linear(temb_dim, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int = 0):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(context_dim or dim, dim, bias=False)
        self.to_v = nn.Linear(context_dim or dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        return self.to_out[0](attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx),
                                        self.heads))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm, 1x1 conv in, one transformer block over the H*W tokens,
    1x1 conv out, plus the input."""

    def __init__(self, dim: int, heads: int, context_dim: int, groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, dim, 1e-6)
        self.proj_in = nn.Conv2d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(dim, heads, context_dim)])
        self.proj_out = nn.Conv2d(dim, dim, 1)

    def forward(self, x, context):
        b, c, h, w = x.shape
        t = self.proj_in(self.norm(x)).permute(0, 2, 3, 1).reshape(b, h * w, c)
        t = self.transformer_blocks[0](t, context)
        return self.proj_out(t.reshape(b, h, w, c).permute(0, 3, 1, 2)) + x


class Downsample2D(nn.Module):
    """3x3 stride-2 conv: padded 1 on every side (the UNet) or 0 before and
    1 after on each axis (the VAE encoder)."""

    def __init__(self, dim: int, pad=(1, 1, 1, 1)):
        super().__init__()
        self.pad = pad
        self.conv = nn.Conv2d(dim, dim, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, self.pad))


class Upsample2D(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' sinusoid with `flip_sin_to_cos` and no frequency shift:
    [cos | sin] of t * exp(-ln(10000) * i / (dim / 2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


# ---------------------------------------------------------------------------
# The UNet
# ---------------------------------------------------------------------------

class _UNetBlock(nn.Module):
    """A down or up block: its resnets, its transformers where the level has
    attention, and its down- or upsampler."""

    def __init__(self, ins: Sequence[int], dim: int, cfg: Dict, temb_dim: int, attn: bool,
                 sampler: str):
        super().__init__()
        groups = cfg["norm_num_groups"]
        self.resnets = nn.ModuleList([ResnetBlock2D(c, dim, groups, 1e-5, temb_dim) for c in ins])
        if attn:
            self.attentions = nn.ModuleList([
                Transformer2D(dim, cfg["attention_head_dim"], cfg["cross_attention_dim"], groups)
                for _ in ins])
        if sampler == "down":
            self.downsamplers = nn.ModuleList([Downsample2D(dim)])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([Upsample2D(dim)])

    def layer(self, i, x, temb, context):
        x = self.resnets[i](x, temb)
        return self.attentions[i](x, context) if hasattr(self, "attentions") else x


class _UNetMid(nn.Module):
    def __init__(self, dim: int, cfg: Dict, temb_dim: int):
        super().__init__()
        groups = cfg["norm_num_groups"]
        self.resnets = nn.ModuleList([ResnetBlock2D(dim, dim, groups, 1e-5, temb_dim)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2D(dim, cfg["attention_head_dim"], cfg["cross_attention_dim"], groups)])

    def forward(self, x, temb, context):
        return self.resnets[1](self.attentions[0](self.resnets[0](x, temb), context), temb)


class UNet(nn.Module):
    """UNet2DConditionModel of SD 1.x: cross-attention on every level but the
    deepest, `layers_per_block` resnets down and one more up, each up layer
    taking the matching skip; eps out. `cfg` holds the published keys
    (in_channels, out_channels, block_out_channels, layers_per_block,
    cross_attention_dim, attention_head_dim: the head count, norm_num_groups)."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        chans, n, layers = list(cfg["block_out_channels"]), len(cfg["block_out_channels"]), \
            cfg["layers_per_block"]
        temb_dim = 4 * chans[0]
        self.time_embedding = TimestepEmbedding(chans[0], temb_dim)
        self.conv_in = nn.Conv2d(cfg["in_channels"], chans[0], 3, padding=1)
        skips, prev = [chans[0]], chans[0]
        self.down_blocks = nn.ModuleList()
        for i, ch in enumerate(chans):
            last = i == n - 1
            self.down_blocks.append(_UNetBlock([prev] + [ch] * (layers - 1), ch, cfg, temb_dim,
                                               not last, "" if last else "down"))
            skips += [ch] * (layers + (0 if last else 1))
            prev = ch
        self.mid_block = _UNetMid(chans[-1], cfg, temb_dim)
        self.up_blocks = nn.ModuleList()
        for i, ch in enumerate(reversed(chans)):
            ins = []
            for _ in range(layers + 1):
                ins.append(prev + skips.pop())
                prev = ch
            self.up_blocks.append(_UNetBlock(ins, ch, cfg, temb_dim, i > 0,
                                             "up" if i < n - 1 else ""))
        self.conv_norm_out = nn.GroupNorm(cfg["norm_num_groups"], chans[0], 1e-5)
        self.conv_out = nn.Conv2d(chans[0], cfg["out_channels"], 3, padding=1)

    def forward(self, x, t: int, context):
        chans = self.cfg["block_out_channels"]
        tt = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
        temb = self.time_embedding(timestep_embedding(tt, chans[0]))
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


# ---------------------------------------------------------------------------
# The VAE
# ---------------------------------------------------------------------------

class VAEAttention(nn.Module):
    """Single-head self-attention over the H*W positions, plus the input."""

    def __init__(self, dim: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, dim, 1e-6)
        self.to_q = nn.Linear(dim, dim)
        self.to_k = nn.Linear(dim, dim)
        self.to_v = nn.Linear(dim, dim)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        out = self.to_out[0](attention(self.to_q(t), self.to_k(t), self.to_v(t), 1))
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _VAEMid(nn.Module):
    def __init__(self, dim: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(dim, dim, groups, 1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(dim, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _VAEBlock(nn.Module):
    def __init__(self, cin: int, dim: int, layers: int, groups: int, sampler: str):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(cin if j == 0 else dim, dim, groups, 1e-6)
                                      for j in range(layers)])
        if sampler == "down":
            self.downsamplers = nn.ModuleList([Downsample2D(dim, pad=(0, 1, 0, 1))])
        elif sampler == "up":
            self.upsamplers = nn.ModuleList([Upsample2D(dim)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class _Encoder(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        chans, g = list(cfg["block_out_channels"]), cfg["norm_num_groups"]
        n = len(chans)
        self.conv_in = nn.Conv2d(cfg["in_channels"], chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            _VAEBlock(chans[max(i - 1, 0)], ch, cfg["layers_per_block"], g,
                      "down" if i < n - 1 else "") for i, ch in enumerate(chans)])
        self.mid_block = _VAEMid(chans[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, chans[-1], 1e-6)
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg["latent_channels"], 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(self.mid_block(x))))


class _Decoder(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        rev, g = list(reversed(cfg["block_out_channels"])), cfg["norm_num_groups"]
        n = len(rev)
        self.conv_in = nn.Conv2d(cfg["latent_channels"], rev[0], 3, padding=1)
        self.mid_block = _VAEMid(rev[0], g)
        self.up_blocks = nn.ModuleList([
            _VAEBlock(rev[max(i - 1, 0)], ch, cfg["layers_per_block"] + 1, g,
                      "up" if i < n - 1 else "") for i, ch in enumerate(rev)])
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], 1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg["out_channels"], 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAE(nn.Module):
    """AutoencoderKL: `encode` gives the latent mean (unscaled), `decode`
    the [-1, 1] image. `cfg` holds the published keys (in_channels,
    out_channels, latent_channels, block_out_channels, layers_per_block,
    norm_num_groups)."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        z = cfg["latent_channels"]
        self.encoder = _Encoder(cfg)
        self.decoder = _Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * z, 2 * z, 1)
        self.post_quant_conv = nn.Conv2d(z, z, 1)

    def encode(self, x):
        return self.quant_conv(self.encoder(x))[:, :self.cfg["latent_channels"]]

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


def state_keys(cls, cfg: Dict) -> Dict[str, torch.Size]:
    """The module's parameter names (the diffusers checkpoint's) and shapes,
    from the module built on the meta device."""
    with torch.device("meta"):
        return {k: v.shape for k, v in cls(cfg).state_dict().items()}


def loaded(cls, cfg: Dict, state: Dict[str, torch.Tensor]) -> nn.Module:
    """The module holding the given float32 tensors as its parameters."""
    with torch.device("meta"):
        module = cls(cfg)
    module.load_state_dict(state, strict=True, assign=True)
    return module.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# The scheduler: PNDM as PLMS
# ---------------------------------------------------------------------------

class PLMS:
    """PNDMScheduler with `skip_prk_steps`, epsilon prediction: the
    published `set_timesteps`, `step_plms` and `add_noise`."""

    def __init__(self, steps: int, train_steps: int = 1000, beta_start: float = 0.00085,
                 beta_end: float = 0.012, steps_offset: int = 1):
        betas = torch.linspace(beta_start ** 0.5, beta_end ** 0.5, train_steps,
                               dtype=torch.float32) ** 2
        self.alphas_cumprod = torch.cumprod(1.0 - betas, dim=0)
        self.final_alpha_cumprod = self.alphas_cumprod[0]
        self.ratio = train_steps // steps
        ts = np.arange(0, steps) * self.ratio + steps_offset
        self.timesteps = [int(t) for t in
                          np.concatenate([ts[:-1], ts[-2:-1], ts[-1:]])[::-1]]
        self.ets: List[torch.Tensor] = []
        self.cur_sample = None
        self.counter = 0

    def strength_timesteps(self, steps: int, strength: float) -> List[int]:
        """The inpainting pipeline's skipping: the timesteps from
        steps - int(steps * strength) on."""
        return self.timesteps[steps - min(int(steps * strength), steps):]

    def _alpha(self, t: int) -> float:
        return float(self.alphas_cumprod[t] if t >= 0 else self.final_alpha_cumprod)

    def add_noise(self, x, noise, t: int):
        a = self._alpha(t)
        return a ** 0.5 * x + (1.0 - a) ** 0.5 * noise

    def step(self, eps, t: int, sample):
        prev_t = t - self.ratio
        if self.counter != 1:
            self.ets = self.ets[-3:] + [eps]
        else:
            prev_t, t = t, t + self.ratio
        if len(self.ets) == 1 and self.counter == 0:
            out = eps
            self.cur_sample = sample
        elif len(self.ets) == 1 and self.counter == 1:
            out = (eps + self.ets[-1]) / 2
            sample, self.cur_sample = self.cur_sample, None
        elif len(self.ets) == 2:
            out = (3 * self.ets[-1] - self.ets[-2]) / 2
        elif len(self.ets) == 3:
            out = (23 * self.ets[-1] - 16 * self.ets[-2] + 5 * self.ets[-3]) / 12
        else:
            out = (1 / 24) * (55 * self.ets[-1] - 59 * self.ets[-2] + 37 * self.ets[-3]
                              - 9 * self.ets[-4])
        self.counter += 1
        a_t, a_prev = self._alpha(t), self._alpha(prev_t)
        coeff = (a_prev / a_t) ** 0.5
        denom = a_t * (1 - a_prev) ** 0.5 + (a_t * (1 - a_t) * a_prev) ** 0.5
        return coeff * sample - (a_prev - a_t) * out / denom


# ---------------------------------------------------------------------------
# The node's Fast path
# ---------------------------------------------------------------------------

def luma(depth_map: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> [B, H, W], the node's weights in its order."""
    return (LUMA[0] * depth_map[..., 0] + LUMA[1] * depth_map[..., 1]
            + LUMA[2] * depth_map[..., 2])


def backward_warp(image: torch.Tensor, depth: torch.Tensor, divergence: float):
    """The right eye sampled at x + offset (linear between the two nearest
    columns, clamped to the frame), and its gap mask. image [B, H, W, C],
    depth [B, H, W]."""
    b, h, w, c = image.shape
    lo = depth.amin(dim=(-2, -1), keepdim=True)
    span = depth.amax(dim=(-2, -1), keepdim=True) - lo
    nd = torch.where(span > 1e-6, (depth - lo) / torch.clamp(span, min=1e-6), 0.0)
    x = nd - 0.5
    off = torch.sign(x) * torch.pow(torch.abs(x), 1.0) * ((divergence / 100.0) * w) + 0.0
    src = torch.arange(w, dtype=torch.float32, device=image.device) + off
    outside = (src < 0) | (src > w - 1)
    src = torch.clamp(src, 0.0, w - 1.0)
    i0 = torch.floor(src).long()
    i1 = torch.clamp(i0 + 1, max=w - 1)
    f = src - i0.float()
    warped = (image.gather(2, i0[..., None].expand(b, h, w, c)) * (1 - f[..., None])
              + image.gather(2, i1[..., None].expand(b, h, w, c)) * f[..., None])
    nd_w = nd.gather(2, i0) * (1 - f) + nd.gather(2, i1) * f
    gap = (nd_w - nd) > DISOCCLUSION
    near = F.pad(gap, (1, 1, 1, 1))
    grown = torch.zeros_like(gap)
    for dy in range(3):
        for dx in range(3):
            grown |= near[:, dy:dy + h, dx:dx + w]
    return warped, grown | outside


def prefill(image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each masked pixel from the nearest unmasked pixels left and right on
    its row, weighted by distance (the one side where the other has none;
    a row with none at all keeps its first or last pixel's value)."""
    b, h, w, c = image.shape
    cols = torch.arange(w, device=image.device)
    valid = ~mask
    left = torch.cummax(torch.where(valid, cols, -1), dim=-1).values
    right = torch.cummin(torch.where(valid, cols, w).flip(-1), dim=-1).values.flip(-1)

    def take(idx):
        return image.gather(2, idx[..., None].expand(b, h, w, c))

    lv, rv = take(left.clamp(min=0)), take(right.clamp(max=w - 1))
    colf = cols.float()
    ld, rd = colf - left.float(), right.float() - colf
    t = ld / torch.clamp(ld + rd, min=1.0)
    t = torch.where(left < 0, 1.0, t)
    t = torch.where(right >= w, 0.0, t)
    t = t[..., None]
    return torch.where(mask[..., None], lv * (1 - t) + rv * t, image)


def frame_noise(seed: int, shape, device) -> torch.Tensor:
    """A frame's initial latent noise, from a CPU generator seeded `seed`."""
    return torch.randn(tuple(shape), generator=torch.Generator().manual_seed(int(seed))).to(device)


@torch.no_grad()
def inpaint(unet: UNet, vae: VAE, context: torch.Tensor, image: torch.Tensor,
            mask: torch.Tensor, steps: int, strength: float, guidance: float,
            seed: int) -> torch.Tensor:
    """The masked region of one frame generated anew: image [1, H, W, 3] in
    [0, 1] (the prefilled warp), mask [1, H, W]; context [2, 77, width]
    (unconditional, conditional). Returns the decoded image in [0, 1]."""
    x = image.permute(0, 3, 1, 2) * 2.0 - 1.0
    m = mask[:, None].float()
    lat = vae.encode(x) * LATENT_SCALE
    lh, lw = lat.shape[-2:]
    m_lat = (F.interpolate(m, size=(lh, lw), mode="bilinear", align_corners=False,
                           antialias=True) > 0.1).float()
    masked = vae.encode(x * (1.0 - (m > 0.5).float())) * LATENT_SCALE
    extra = torch.cat([m_lat, masked], dim=1)
    sched = PLMS(steps)
    ts = sched.strength_timesteps(steps, strength)
    latents = sched.add_noise(lat, frame_noise(seed, lat.shape[1:], lat.device)[None], ts[0])
    for t in ts:
        inp = torch.cat([torch.cat([latents] * 2), torch.cat([extra] * 2)], dim=1)
        eps_u, eps_c = unet(inp, t, context).chunk(2)
        latents = sched.step(eps_u + guidance * (eps_c - eps_u), t, latents)
    out = vae.decode(latents / LATENT_SCALE)
    return torch.clamp(out.permute(0, 2, 3, 1) / 2.0 + 0.5, 0.0, 1.0)


@torch.no_grad()
def fast_path(unet: UNet, vae: VAE, embed: Callable[[str], torch.Tensor],
              image: torch.Tensor, depth_map: torch.Tensor, settings: Dict,
              seed: int) -> Dict[str, torch.Tensor]:
    """The node's Fast path on one frame: image and depth_map [1, H, W, 3]
    in [0, 1], at the model's sample size. Returns the right eye, its gap
    mask and its prefilled warp."""
    warped, mask = backward_warp(image, luma(depth_map), float(settings["scale_factor"]))
    filled = prefill(warped, mask)
    prompt = settings["prompt"]
    context = torch.cat([embed(""), embed(prompt)], dim=0)
    new = inpaint(unet, vae, context, filled, mask, int(settings["num_inference_steps"]),
                  float(settings["denoise_strength"]), float(settings["guidance_scale"]), seed)
    right = torch.where(mask[..., None], new, filled)
    return {"right": right, "mask": mask, "prefilled": filled}
