"""Stable-Diffusion UNet (UNet2DConditionModel) in PyTorch.

Port of `comfystereo_tpu/diffusion/sd_unet.py`. Parameter names follow the
diffusers state-dict layout key for key (``down_blocks.0.resnets.1.conv1``),
so the JAX package's flax tree carries across with
`porting.state_dict_from_jax`. NCHW throughout; every self-attention goes
through `bn_attention`, so the StereoDiffusion coupling applies with the
`mode` and `stereo_active` values threaded through the layers. The config
covers SD 1.x and 2.x (attention on every level but the deepest, one
transformer block each, 1x1-conv projections) and SDXL (attention per
level, deep transformer stacks, linear projections, and the text-time
conditioning of a pooled text embedding and six time ids added to the
timestep embedding).

Numerics follow the flax modules under mixed precision: group and layer
norms take their statistics in f32 (mean and E[x^2] - mean^2) and normalise
in f32 before one rounding to the activation dtype; the timestep embedding
MLP, and SDXL's added embedding MLP, run in f32 and their sum is cast to
the activation dtype afterwards; GELU is the exact (erf) form.

`GraphedUNet`, a bundle's `unet_apply`, replays each call on a card that
needs no gradient as one captured CUDA graph of `SDUNet.forward`, in place
of its thousands of eager launches; the forward copies nothing from the
host (the timestep comes as a device tensor, the sinusoid's frequencies
are held on the device) and waits for nothing, so it can be captured, and
it launches the same kernels either way.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels import flash_attention as fa
from .attention import AttentionMode, bn_attention

# SDXL's time ids: (original height, original width, crop top, crop left,
# target height, target width).
TIME_IDS = 6


@dataclasses.dataclass(frozen=True)
class SDUNetConfig:
    """SD-family UNet2DConditionModel hyperparameters, under diffusers'
    names and semantics: `attention_head_dim` is the per-block head COUNT;
    `down_block_types` says which levels have attention (None: every level
    but the deepest, SD 1.x and 2.x), and the up blocks mirror it;
    `transformer_layers_per_block` is each level's transformer depth, which
    the up blocks take mirrored and the mid block takes from the deepest
    level; `use_linear_projection` makes the spatial transformers' proj_in
    and proj_out linear layers on the tokens; `addition_embed_type`
    "text_time" (SDXL) adds to the timestep embedding the `add_embedding`
    MLP of the pooled text embedding and the sinusoids of six time ids."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: Union[int, Tuple[int, ...]] = 8
    norm_num_groups: int = 32
    down_block_types: Optional[Tuple[str, ...]] = None
    transformer_layers_per_block: Union[int, Tuple[int, ...]] = 1
    use_linear_projection: bool = False
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: Optional[int] = None
    projection_class_embeddings_input_dim: Optional[int] = None

    def heads_for_block(self, i: int) -> int:
        if isinstance(self.attention_head_dim, tuple):
            return self.attention_head_dim[i]
        return self.attention_head_dim

    def has_attention(self, i: int) -> bool:
        if self.down_block_types is None:
            return i < len(self.block_out_channels) - 1
        return self.down_block_types[i] == "CrossAttnDownBlock2D"

    def depth_for_block(self, i: int) -> int:
        if isinstance(self.transformer_layers_per_block, tuple):
            return self.transformer_layers_per_block[i]
        return self.transformer_layers_per_block

    @property
    def text_time(self) -> bool:
        return self.addition_embed_type == "text_time"

    @property
    def pooled_dim(self) -> int:
        """The pooled text embedding's width: what `add_embedding` takes
        besides the six time ids' sinusoids."""
        return self.projection_class_embeddings_input_dim - TIME_IDS * self.addition_time_embed_dim


# SD 1.x (runwayml/stable-diffusion-v1-5 unet/config.json)
SD15_UNET_CONFIG = SDUNetConfig()
# SD 1.5 inpainting: 9-channel input = latents + mask + masked-image latents
SD15_INPAINT_UNET_CONFIG = SDUNetConfig(in_channels=9)
# SD 2.x (stabilityai/stable-diffusion-2-1): 1024-d context, 64-d heads
SD21_UNET_CONFIG = SDUNetConfig(cross_attention_dim=1024,
                                attention_head_dim=(5, 10, 20, 20))
# Tiny config exercising every block type (tests)
TINY_SD_UNET_CONFIG = SDUNetConfig(block_out_channels=(32, 64),
                                   layers_per_block=1, cross_attention_dim=64,
                                   attention_head_dim=4, norm_num_groups=8)
# SDXL inpainting (diffusers/stable-diffusion-xl-1.0-inpainting-0.1
# unet/config.json, the SDXL base UNet with 9 input channels): no attention
# at 320 channels, transformer depths 1 / 2 / 10 (the mid block 10), 64-d
# heads, 2048-d context, linear projections, text-time conditioning of a
# 1280-d pooled embedding and six time ids of 256-d sinusoids.
SDXL_INPAINT_UNET_CONFIG = SDUNetConfig(
    in_channels=9, block_out_channels=(320, 640, 1280), cross_attention_dim=2048,
    attention_head_dim=(5, 10, 20),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
    transformer_layers_per_block=(1, 2, 10), use_linear_projection=True,
    addition_embed_type="text_time", addition_time_embed_dim=256,
    projection_class_embeddings_input_dim=2816)


def _normalize(x: torch.Tensor, xg: torch.Tensor, groups_to_channels, weight,
               bias, eps: float, shape) -> torch.Tensor:
    """flax's `_compute_stats` + `_normalize`: statistics of `xg` (x in f32,
    reduced over its last axis) as mean and max(E[x^2] - mean^2, 0), then
    (x - mean) * (rsqrt(var + eps) * weight) + bias in f32, rounded once."""
    mu = xg.mean(dim=-1)
    var = torch.clamp((xg * xg).mean(dim=-1) - mu * mu, min=0.0)
    mu, var = groups_to_channels(mu), groups_to_channels(var)
    mul = torch.rsqrt(var + eps) * weight.float().reshape(shape)
    y = (x.float() - mu) * mul + bias.float().reshape(shape)
    return y.to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm over NCHW with flax's numerics (see `_normalize`)."""

    def __init__(self, num_groups: int, channels: int, eps: float):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        b, c = x.shape[:2]
        ones = (1,) * (x.dim() - 2)
        per = c // self.num_groups

        def to_channels(t):  # [B, G] -> [B, C, 1, 1], each group's value per channel
            return t[:, :, None].expand(b, self.num_groups, per).reshape((b, c) + ones)

        xg = x.float().reshape(b, self.num_groups, -1)
        return _normalize(x, xg, to_channels, self.weight, self.bias,
                          self.eps, (1, c) + ones)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with flax's numerics."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return _normalize(x, x.float(), lambda t: t[..., None], self.weight,
                          self.bias, self.eps, (-1,))


_FREQS: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def timestep_freqs(dim: int, device) -> torch.Tensor:
    """The sinusoid's dim // 2 frequencies exp(-ln(10000) * i / half),
    computed in f32 on the host and held on `device`, once per (dim,
    device): a forward copies nothing to the device for them, so a CUDA
    graph can capture it."""
    key = (dim, torch.device(device))
    freqs = _FREQS.get(key)
    if freqs is None:
        half = dim // 2
        log10k = torch.log(torch.tensor(10000.0, dtype=torch.float32))
        freqs = torch.exp(-log10k * torch.arange(half, dtype=torch.float32) / half)
        freqs = _FREQS[key] = freqs.to(key[1])
    return freqs


def sd_timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers get_timestep_embedding with flip_sin_to_cos=True,
    downscale_freq_shift=0: [B] -> [B, dim] as [cos | sin], in f32."""
    args = t.float()[:, None] * timestep_freqs(dim, t.device)[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    """linear_1 -> silu -> linear_2, in f32 whatever the parameter dtype (as
    flax promotes the f32 sinusoid with bf16 parameters)."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, temb):
        def dense(lin, x):
            return F.linear(x, lin.weight.float(), lin.bias.float())
        return dense(self.linear_2, F.silu(dense(self.linear_1, temb.float())))


class CrossAttention(nn.Module):
    """Q/K/V attention with the BN stereo coupling on self-attention."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, context, *, mode: AttentionMode, stereo_active: bool):
        is_cross = context is not None
        ctx = context if is_cross else x
        b = x.shape[0]

        def split(t):
            return t.reshape(b, -1, self.heads, self.dim_head).transpose(1, 2)

        out = bn_attention(split(self.to_q(x)), split(self.to_k(ctx)),
                           split(self.to_v(ctx)), scale=self.dim_head ** -0.5,
                           is_cross=is_cross, mode=mode, active=stereo_active)
        out = out.transpose(1, 2).reshape(b, -1, self.heads * self.dim_head)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim, dim_out * 2)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    """net.0 = GEGLU, net.2 = output Linear (diffusers indices)."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(),
                                  nn.Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, *, mode, stereo_active):
        h = x + self.attn1(self.norm1(x), None, mode=mode,
                           stereo_active=stereo_active)
        h = h + self.attn2(self.norm2(h), context, mode=mode,
                           stereo_active=stereo_active)
        return h + self.ff(self.norm3(h))


class Transformer2D(nn.Module):
    """Spatial transformer: GroupNorm, proj_in, `depth` transformer blocks
    over the H*W tokens, proj_out, plus the input. The projections are 1x1
    convolutions on NCHW (SD 1.x), or with `linear` (diffusers'
    use_linear_projection, SDXL) linear layers on the tokens."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 norm_groups: int, depth: int = 1, linear: bool = False):
        super().__init__()
        self.linear = linear
        proj = (lambda: nn.Linear(channels, channels)) if linear else \
            (lambda: nn.Conv2d(channels, channels, 1))
        self.norm = GroupNorm(norm_groups, channels, 1e-6)
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, channels // heads,
                                  context_dim) for _ in range(depth)])
        self.proj_out = proj()

    def forward(self, x, context, *, mode, stereo_active):
        b, c, h, w = x.shape
        if self.linear:
            tokens = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            y = self.proj_in(self.norm(x))
            tokens = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for blk in self.transformer_blocks:
            tokens = blk(tokens, context, mode=mode, stereo_active=stereo_active)
        if self.linear:
            return self.proj_out(tokens).reshape(b, h, w, c).permute(0, 3, 1, 2) + x
        y = tokens.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(y) + x


class ResnetBlock2D(nn.Module):
    """GN -> silu -> conv1 (+ time_emb_proj(silu(temb))) -> GN -> silu ->
    conv2, plus a 1x1 shortcut when the channel count changes. The time
    projection exists when `use_temb` and `temb_dim` (the embedding's width,
    which flax infers) is given."""

    def __init__(self, in_ch: int, out_channels: int, norm_groups: int,
                 temb_dim: Optional[int] = None, eps: float = 1e-5, use_temb: bool = True):
        super().__init__()
        out_ch = out_channels
        self.norm1 = GroupNorm(norm_groups, in_ch, eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        if use_temb and temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = GroupNorm(norm_groups, out_ch, eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and hasattr(self, "time_emb_proj"):
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """3x3 stride-2 conv; `padding` = ((top, bottom), (left, right)), as
    flax's: ((1, 1), (1, 1)) in the UNet, ((0, 1), (0, 1)) in the VAE."""

    def __init__(self, channels: int, padding=((1, 1), (1, 1))):
        super().__init__()
        (top, bottom), (left, right) = padding
        self.pad = (left, right, top, bottom)  # F.pad's order
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, self.pad))


class Upsample2D(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _DownBlock(nn.Module):
    """CrossAttnDownBlock2D / DownBlock2D (when has_attn=False)."""

    def __init__(self, in_ch, out_ch, num_layers, heads, context_dim,
                 norm_groups, temb_dim, has_attn, add_downsample, depth=1,
                 linear=False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, norm_groups,
                          temb_dim) for i in range(num_layers)])
        if has_attn:
            self.attentions = nn.ModuleList([
                Transformer2D(out_ch, heads, context_dim, norm_groups, depth, linear)
                for _ in range(num_layers)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(out_ch)])

    def forward(self, x, temb, context, *, mode, stereo_active):
        residuals = []
        for i, res in enumerate(self.resnets):
            x = res(x, temb)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context, mode=mode,
                                       stereo_active=stereo_active)
            residuals.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
            residuals.append(x)
        return x, residuals


class _UpBlock(nn.Module):
    """CrossAttnUpBlock2D / UpBlock2D (when has_attn=False)."""

    def __init__(self, in_chs, out_ch, heads, context_dim, norm_groups,
                 temb_dim, has_attn, add_upsample, depth=1, linear=False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(ic, out_ch, norm_groups, temb_dim) for ic in in_chs])
        if has_attn:
            self.attentions = nn.ModuleList([
                Transformer2D(out_ch, heads, context_dim, norm_groups, depth, linear)
                for _ in in_chs])
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_ch)])

    def forward(self, x, skips, temb, context, *, mode, stereo_active):
        for i, res in enumerate(self.resnets):
            x = res(torch.cat([x, skips.pop()], dim=1), temb)
            if hasattr(self, "attentions"):
                x = self.attentions[i](x, context, mode=mode,
                                       stereo_active=stereo_active)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class _MidBlock(nn.Module):
    def __init__(self, channels, heads, context_dim, norm_groups, temb_dim,
                 depth=1, linear=False):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, norm_groups, temb_dim)
            for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2D(channels, heads, context_dim, norm_groups, depth, linear)])

    def forward(self, x, temb, context, *, mode, stereo_active):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context, mode=mode,
                               stereo_active=stereo_active)
        return self.resnets[1](x, temb)


class SDUNet(nn.Module):
    """UNet2DConditionModel-equivalent:
    forward(latents [B,C,h,w], t, context [B,77,ctx]) -> eps [B,C,h,w].

    Cross-attention on the levels `cfg.has_attention` names (SD1.x: every
    level except the deepest), each spatial transformer
    `cfg.depth_for_block` blocks deep; layers_per_block resnets down,
    layers_per_block+1 up; mid = resnet / transformer / resnet. With
    text-time conditioning (`cfg.text_time`, SDXL) the forward also takes
    `text_embeds` [B, pooled] and `time_ids` [B, 6].
    """

    def __init__(self, cfg: SDUNetConfig = SD15_UNET_CONFIG):
        super().__init__()
        if cfg.addition_embed_type not in (None, "text_time"):
            raise ValueError(f"SDUNet: addition_embed_type {cfg.addition_embed_type!r} "
                             "is not supported (None or 'text_time')")
        self.cfg = cfg
        chans = cfg.block_out_channels
        n = len(chans)
        temb_dim = chans[0] * 4
        groups, ctx = cfg.norm_num_groups, cfg.cross_attention_dim
        linear = cfg.use_linear_projection
        self.time_embedding = TimestepEmbedding(chans[0], temb_dim)
        if cfg.text_time:
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb_dim)
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)

        skip_chs = [chans[0]]
        self.down_blocks = nn.ModuleList()
        in_ch = chans[0]
        for i, ch in enumerate(chans):
            last = i == n - 1
            self.down_blocks.append(_DownBlock(
                in_ch, ch, cfg.layers_per_block, cfg.heads_for_block(i), ctx,
                groups, temb_dim, has_attn=cfg.has_attention(i), add_downsample=not last,
                depth=cfg.depth_for_block(i), linear=linear))
            skip_chs.extend([ch] * (cfg.layers_per_block + (0 if last else 1)))
            in_ch = ch

        self.mid_block = _MidBlock(chans[-1], cfg.heads_for_block(n - 1), ctx,
                                   groups, temb_dim, cfg.depth_for_block(n - 1), linear)

        self.up_blocks = nn.ModuleList()
        x_ch = chans[-1]
        for i in range(n):
            j = n - 1 - i  # mirrored down-block index
            in_chs = []
            for _ in range(cfg.layers_per_block + 1):
                in_chs.append(x_ch + skip_chs.pop())
                x_ch = chans[j]
            self.up_blocks.append(_UpBlock(
                in_chs, chans[j], cfg.heads_for_block(j), ctx, groups,
                temb_dim, has_attn=cfg.has_attention(j), add_upsample=j > 0,
                depth=cfg.depth_for_block(j), linear=linear))

        self.conv_norm_out = GroupNorm(groups, chans[0], 1e-5)
        self.conv_out = nn.Conv2d(chans[0], cfg.out_channels, 3, padding=1)

    def forward(self, latents, t, context, *,
                mode: AttentionMode = AttentionMode(),
                stereo_active: bool = False,
                text_embeds: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None):
        t = torch.as_tensor(t, device=latents.device)
        if t.dim() == 0:
            t = t.expand(latents.shape[0])
        temb = self.time_embedding(
            sd_timestep_embedding(t, self.cfg.block_out_channels[0]))
        if self.cfg.text_time:
            temb = temb + self.add_embedding(self._text_time(text_embeds, time_ids))
        elif text_embeds is not None or time_ids is not None:
            raise ValueError("SDUNet: text_embeds and time_ids given to a UNet without "
                             "text-time conditioning")
        # The sinusoids and MLPs run in f32; cast down so the resnets' time
        # projections run in the activation dtype.
        temb = temb.to(latents.dtype)
        kw = dict(mode=mode, stereo_active=stereo_active)

        x = self.conv_in(latents)
        skips = [x]
        for blk in self.down_blocks:
            x, res = blk(x, temb, context, **kw)
            skips.extend(res)
        x = self.mid_block(x, temb, context, **kw)
        for blk in self.up_blocks:
            x = blk(x, skips, temb, context, **kw)
        return self.conv_out(F.silu(self.conv_norm_out(x)))

    def _text_time(self, text_embeds, time_ids) -> torch.Tensor:
        """diffusers' text-time input of `add_embedding`, in f32: the pooled
        text embedding [B, pooled], then the 256-d sinusoid (flip_sin_to_cos,
        no shift) of each of the six time ids [B, 6], flattened."""
        if text_embeds is None or time_ids is None:
            raise ValueError("SDUNet: a UNet with text-time conditioning needs "
                             "text_embeds and time_ids")
        b = text_embeds.shape[0]
        ids = sd_timestep_embedding(time_ids.reshape(-1), self.cfg.addition_time_embed_dim)
        return torch.cat([text_embeds.float(), ids.reshape(b, -1)], dim=-1)



# ---------------------------------------------------------------------------
# The forward as CUDA graphs
# ---------------------------------------------------------------------------

UNET_GRAPH_CAPTURES = 0  # CUDA graphs captured of SDUNet.forward
UNET_GRAPH_CALLS = 0  # UNet calls served by a graph's replay (each capturing call too)
MAX_GRAPHS = 4  # graphs one GraphedUNet holds; the least recently used is dropped
GRAPH_WARMUPS = 1  # eager forwards on a side stream before each capture


def _backend_flags() -> tuple:
    """The global switches by which cuDNN and cuBLAS choose their kernels."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return (cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32,
            matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction,
            matmul.allow_fp16_reduced_precision_reduction,
            torch.are_deterministic_algorithms_enabled())


def _added(text_embeds: Optional[torch.Tensor],
           time_ids: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The text-time conditioning given to a call, as `SDUNet.forward`'s
    keyword arguments: empty for a call without it."""
    if text_embeds is None and time_ids is None:
        return {}
    return {"text_embeds": text_embeds, "time_ids": time_ids}


def graph_key(latents: torch.Tensor, t, context: torch.Tensor, mode: AttentionMode,
              stereo_active: bool, text_embeds: Optional[torch.Tensor] = None,
              time_ids: Optional[torch.Tensor] = None) -> tuple:
    """What one call's launches depend on: the latents', the timestep's and
    the context's shapes, strides (the convolutions' memory format) and
    dtypes, the device, the attention mode, `stereo_active`, the backend
    switches, and the attention route that `diffusion/attention.py` looks
    up at each call; where the call carries text-time conditioning, its
    tensors' shapes, strides and dtypes too (a call without it keys as it
    did before the conditioning existed)."""
    t = t if isinstance(t, torch.Tensor) else torch.as_tensor(t)
    key = (latents.device, tuple(latents.shape), latents.stride(), latents.dtype,
           tuple(t.shape), t.dtype, tuple(context.shape), context.stride(), context.dtype,
           mode, bool(stereo_active), _backend_flags(), fa.flash_attention)
    for name, x in _added(text_embeds, time_ids).items():
        key += (name, tuple(x.shape), x.stride(), x.dtype)
    return key


def _dense(x: torch.Tensor) -> bool:
    return x.is_contiguous() or (x.dim() == 4 and
                                 x.is_contiguous(memory_format=torch.channels_last))


def graphable(latents: torch.Tensor, t, context: torch.Tensor,
              text_embeds: Optional[torch.Tensor] = None,
              time_ids: Optional[torch.Tensor] = None) -> bool:
    """True where a call can be served by a replay: the latents on a CUDA
    device with the context (and the text-time conditioning, where given),
    each dense in its memory format (contiguous, or channels-last latents,
    as the VAE's encode leaves them), and no input requiring grad."""
    tensors = [latents, context, *_added(text_embeds, time_ids).values()]
    return (latents.device.type == "cuda"
            and all(x.device == latents.device and _dense(x) and not x.requires_grad
                    for x in tensors)
            and not (isinstance(t, torch.Tensor) and t.requires_grad))


class _CapturedForward:
    """One CUDA graph of `SDUNet.forward` with its static inputs (latents and
    context in the UNet's dtype and in the memory format `.to(dtype)` keeps,
    the timestep, and any text-time conditioning, as device tensors of
    their own dtype) and its output, in a memory pool of its own. Every
    static input is copied in at every call, so a replay never sees an
    earlier call's values."""

    def __init__(self, unet: SDUNet, dtype: torch.dtype, latents: torch.Tensor,
                 t: torch.Tensor, context: torch.Tensor, mode: AttentionMode,
                 stereo_active: bool, text_embeds: Optional[torch.Tensor] = None,
                 time_ids: Optional[torch.Tensor] = None):
        global UNET_GRAPH_CAPTURES
        dev = latents.device
        added = _added(text_embeds, time_ids)
        self.latents = torch.empty_like(latents, dtype=dtype)
        self.t = torch.empty(t.shape, dtype=t.dtype, device=dev)
        self.context = torch.empty_like(context, dtype=dtype)
        self.added = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                      for k, v in added.items()}

        def forward():
            return unet(self.latents, self.t, self.context, mode=mode,
                        stereo_active=stereo_active, **self.added)

        with torch.cuda.device(dev):
            self._load(latents, t, context, added)
            # Lazy set-up (kernel builds, cuDNN plans, cuBLAS handles, the
            # timestep frequencies) happens here, outside the capture.
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(GRAPH_WARMUPS):
                    forward()
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.out = forward()
        UNET_GRAPH_CAPTURES += 1

    def _load(self, latents: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
              added: Dict[str, torch.Tensor]) -> None:
        # copy_ rounds float32 to the UNet's dtype as `.to(dtype)` does; a
        # host scalar timestep is filled in, with no copy that waits.
        self.latents.copy_(latents)
        if t.dim() == 0 and not t.is_cuda:
            self.t.fill_(t)
        else:
            self.t.copy_(t)
        self.context.copy_(context)
        for k, v in added.items():
            self.added[k].copy_(v)

    def __call__(self, latents: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                 text_embeds: Optional[torch.Tensor] = None,
                 time_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        with torch.cuda.device(latents.device):
            self._load(latents, t, context, _added(text_embeds, time_ids))
            self.graph.replay()
            return self.out.to(torch.float32, copy=True)


class GraphedUNet:
    """A bundle's `unet_apply`: (latents, t, context, mode=None,
    stereo_active=False, text_embeds=None, time_ids=None) -> eps in
    float32, the latents and context cast to the UNet's `dtype` (the
    text-time conditioning, which SDXL's UNet takes, goes in as given: the
    UNet embeds it in float32).

    A call that `graphable` admits replays a CUDA graph of `SDUNet.forward`,
    one per `graph_key`, captured at the key's first call after
    `GRAPH_WARMUPS` eager forwards on a side stream; the inputs are copied
    into the graph's static buffers and the output comes back as a fresh
    tensor, so a later replay never overwrites what a caller holds. The
    graph launches what the eager forward launches, in the same order, so
    it gives the same bits. Any other call (the CPU, an input that requires
    grad, as null-text optimisation's embedding does) runs the forward
    eagerly. At most `MAX_GRAPHS` graphs are kept, the least recently used
    dropped first. Replays are ordered on the caller's current stream.

    The graphs hold the UNet's parameters where they lay at capture: change
    them in place (`copy_`), never by new tensors or modules, once the
    bundle has run on a card."""

    def __init__(self, unet: SDUNet, dtype: torch.dtype):
        self.unet, self.dtype = unet, dtype
        self.graphs: "collections.OrderedDict[tuple, _CapturedForward]" = \
            collections.OrderedDict()

    def eager(self, latents, t, context, mode: AttentionMode, stereo_active: bool,
              text_embeds: Optional[torch.Tensor] = None,
              time_ids: Optional[torch.Tensor] = None):
        out = self.unet(latents.to(self.dtype), t, context.to(self.dtype), mode=mode,
                        stereo_active=stereo_active, **_added(text_embeds, time_ids))
        return out.float()

    def __call__(self, latents, t, context, mode: Optional[AttentionMode] = None,
                 stereo_active: bool = False, text_embeds: Optional[torch.Tensor] = None,
                 time_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        global UNET_GRAPH_CALLS
        mode = mode or AttentionMode()
        if not graphable(latents, t, context, text_embeds, time_ids):
            return self.eager(latents, t, context, mode, stereo_active, text_embeds, time_ids)
        t = t if isinstance(t, torch.Tensor) else torch.as_tensor(t)
        added = _added(text_embeds, time_ids)
        key = graph_key(latents, t, context, mode, stereo_active, text_embeds, time_ids)
        with torch.no_grad():
            graph = self.graphs.pop(key, None)
            if graph is None:
                while len(self.graphs) >= MAX_GRAPHS:
                    self.graphs.popitem(last=False)
                graph = _CapturedForward(self.unet, self.dtype, latents, t, context, mode,
                                         stereo_active, **added)
            self.graphs[key] = graph
            out = graph(latents, t, context, **added)
        UNET_GRAPH_CALLS += 1
        return out
