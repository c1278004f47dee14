"""Model bundle, the toy model and the stand-in text encoder.

Port of `comfystereo_tpu/diffusion/models.py`: `LATENT_SCALE` (SD's; a
bundle carries its own), the `DiffusionModel` bundle the pipelines consume,
`HashTextEncoder`, the gated transformers CLIP loader
(`load_hf_text_encoder`), and the small random-weight model that wires the
whole stack (`LatentUNet`, `SimpleVAE`, `make_toy_model`). The bundle's
apply functions close over `nn.Module`s, so they take no parameter argument
(the JAX bundle's take a parameter tree).

The toy modules follow the flax modules' numerics: 'SAME' padding (a
stride-2 3x3 conv pads (0, 1)), flax's group and layer norms (eps 1e-6),
tanh GELU, and flax's transposed conv (a correlation of the 2x dilated input
with the unflipped kernel). Their submodule lists are named after flax's
auto-names (`res_blocks` for `_ResBlock_<i>`, `convs` for `Conv_<i>`, ...),
so `porting.toy_state_dicts_from_jax` carries the JAX toy's weights across.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.caching import EmbeddingCache
from .attention import AttentionMode, bn_attention
from .sd_unet import GroupNorm, LayerNorm

# SD latent scaling, the default of a bundle's `latent_scale`
LATENT_SCALE = 0.18215
# SDXL's (its VAE's scaling_factor)
SDXL_LATENT_SCALE = 0.13025


# ---------------------------------------------------------------------------
# The toy UNet
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    base_channels: int = 32
    channel_mults: tuple = (1, 2)
    num_heads: int = 4
    context_dim: int = 64
    time_dim: int = 64


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding [B] -> [B, dim] as [cos | sin], f32."""
    half = dim // 2
    log10k = torch.log(torch.tensor(10000.0, dtype=torch.float32))
    freqs = torch.exp(-log10k * torch.arange(half, dtype=torch.float32) / half)
    args = t.float()[:, None] * freqs.to(t.device)[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class _Conv(nn.Conv2d):
    """flax `nn.Conv` with 'SAME' padding: (k-1)//2 before and the rest
    after (for a stride-2 3x3 conv on an even size: 0 before, 1 after)."""

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        pads = []
        for n in (x.shape[-1], x.shape[-2]):  # F.pad order: W, then H
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return F.conv2d(F.pad(x, pads), self.weight, self.bias, self.stride)


class _ConvTranspose(nn.Module):
    """flax `nn.ConvTranspose` (k=4, stride 2, 'SAME', kernel not
    transposed): the kernel is stored [out, in, kh, kw] as a correlation
    kernel, and F.conv_transpose2d takes it flipped, in and out swapped;
    its padding 1 is lax's (2, 2) on the dilated input."""

    def __init__(self, cin: int, cout: int, k: int = 4):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        w = self.weight.flip(2, 3).transpose(0, 1)
        return F.conv_transpose2d(x, w, self.bias, stride=2, padding=1)


class _Attention(nn.Module):
    """Self- or cross-attention routed through `bn_attention`."""

    def __init__(self, heads: int, dim: int, context_dim: Optional[int] = None):
        super().__init__()
        self.heads, self.dim = heads, dim
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(context_dim or dim, dim, bias=False)
        self.to_v = nn.Linear(context_dim or dim, dim, bias=False)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x, context=None, *, mode: AttentionMode, stereo_active: bool):
        b, n, c = x.shape
        is_cross = context is not None
        ctx = context if is_cross else x
        head_dim = self.dim // self.heads

        def split(t):
            return t.reshape(b, -1, self.heads, head_dim).transpose(1, 2)

        out = bn_attention(split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx)),
                           scale=head_dim ** -0.5, is_cross=is_cross, mode=mode,
                           active=stereo_active)
        return self.to_out(out.transpose(1, 2).reshape(b, n, self.dim))


class _TransformerBlock(nn.Module):
    def __init__(self, heads: int, dim: int, context_dim: int):
        super().__init__()
        self.attn1 = _Attention(heads, dim)
        self.attn2 = _Attention(heads, dim, context_dim)
        self.norms = nn.ModuleList([LayerNorm(dim, 1e-6) for _ in range(3)])
        self.dense = nn.ModuleList([nn.Linear(dim, 4 * dim), nn.Linear(4 * dim, dim)])

    def forward(self, x, context, *, mode, stereo_active):
        h = x + self.attn1(self.norms[0](x), mode=mode, stereo_active=stereo_active)
        h = h + self.attn2(self.norms[1](h), context, mode=mode, stereo_active=stereo_active)
        ff = self.dense[1](F.gelu(self.dense[0](self.norms[2](h)), approximate="tanh"))
        return h + ff


class _ResBlock(nn.Module):
    def __init__(self, cin: int, channels: int, time_dim: int):
        super().__init__()
        self.norms = nn.ModuleList([GroupNorm(8, cin, 1e-6), GroupNorm(8, channels, 1e-6)])
        convs = [_Conv(cin, channels, 3), _Conv(channels, channels, 3)]
        if cin != channels:
            convs.append(_Conv(cin, channels, 1))
        self.convs = nn.ModuleList(convs)
        self.dense = nn.ModuleList([nn.Linear(time_dim, channels)])

    def forward(self, x, temb):
        h = self.convs[0](F.silu(self.norms[0](x)))
        h = h + self.dense[0](F.silu(temb))[:, :, None, None]
        h = self.convs[1](F.silu(self.norms[1](h)))
        if len(self.convs) > 2:
            x = self.convs[2](x)
        return x + h


class LatentUNet(nn.Module):
    """Conditional latent UNet, NCHW at the interface:
    forward(latents [B,C,h,w], t, context [B,77,ctx]) -> eps [B,C,h,w]."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        base, mults = cfg.base_channels, cfg.channel_mults
        # flax names the time MLP's outer Dense first: dense[1] runs first.
        self.dense = nn.ModuleList([nn.Linear(cfg.time_dim, cfg.time_dim),
                                    nn.Linear(cfg.time_dim, cfg.time_dim)])
        convs = [_Conv(cfg.in_channels, base, 3)]
        res, blocks = [], []
        cin, skip_chs = base, [base]
        for mult in mults:
            ch = base * mult
            res.append(_ResBlock(cin, ch, cfg.time_dim))
            blocks.append(_TransformerBlock(cfg.num_heads, ch, cfg.context_dim))
            skip_chs.append(ch)
            convs.append(_Conv(ch, ch, 3, stride=2))
            cin = ch
        ch = base * mults[-1]
        res.append(_ResBlock(cin, ch, cfg.time_dim))
        blocks.append(_TransformerBlock(cfg.num_heads, ch, cfg.context_dim))
        cin = ch
        for mult in reversed(mults):
            ch = base * mult
            res.append(_ResBlock(cin + skip_chs.pop(), ch, cfg.time_dim))
            cin = ch
        self.norms = nn.ModuleList([GroupNorm(8, cin + skip_chs.pop(), 1e-6)])
        convs.append(_Conv(cin + base, cfg.out_channels, 3))
        self.convs = nn.ModuleList(convs)
        self.res_blocks = nn.ModuleList(res)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, latents, t, context, *, mode: AttentionMode = AttentionMode(),
                stereo_active: bool = False):
        cfg = self.cfg
        t = torch.as_tensor(t, device=latents.device)
        if t.dim() == 0:
            t = t.expand(latents.shape[0])
        temb = self.dense[0](F.silu(self.dense[1](timestep_embedding(t, cfg.time_dim))))
        kw = dict(mode=mode, stereo_active=stereo_active)
        n = len(cfg.channel_mults)

        def transformer(i, x):
            b, c, hh, ww = x.shape
            tokens = x.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
            tokens = self.blocks[i](tokens, context, **kw)
            return tokens.reshape(b, hh, ww, c).permute(0, 3, 1, 2)

        x = self.convs[0](latents)
        skips = [x]
        for i in range(n):
            x = transformer(i, self.res_blocks[i](x, temb))
            skips.append(x)
            x = self.convs[1 + i](x)
        x = transformer(n, self.res_blocks[n](x, temb))
        for i in range(n):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = self.res_blocks[n + 1 + i](torch.cat([x, skips.pop()], dim=1), temb)
        x = self.norms[0](torch.cat([x, skips.pop()], dim=1))
        return self.convs[n + 1](F.silu(x))


# ---------------------------------------------------------------------------
# The toy VAE
# ---------------------------------------------------------------------------

class SimpleVAE(nn.Module):
    """Stride-8 conv autoencoder with the SD latent interface:
    encode([-1, 1] NCHW image) -> latents; decode(latents) -> [-1, 1]."""

    def __init__(self, latent_channels: int = 4, base: int = 32):
        super().__init__()
        self.enc = nn.Sequential(
            _Conv(3, base, 3, stride=2), nn.SiLU(),
            _Conv(base, base * 2, 3, stride=2), nn.SiLU(),
            _Conv(base * 2, base * 4, 3, stride=2), nn.SiLU(),
            _Conv(base * 4, latent_channels, 3))
        self.dec = nn.Sequential(
            _Conv(latent_channels, base * 4, 3), nn.SiLU(),
            _ConvTranspose(base * 4, base * 2), nn.SiLU(),
            _ConvTranspose(base * 2, base), nn.SiLU(),
            _ConvTranspose(base, 3))

    def encode(self, img_nchw):
        return self.enc(img_nchw)

    def decode(self, z_nchw):
        return self.dec(z_nchw)

    def forward(self, img_nchw):
        return self.decode(self.encode(img_nchw))


class HashTextEncoder(EmbeddingCache):
    """Deterministic prompt -> [1, 77, dim] embedding with no model: a
    stand-in with the text encoder's interface for bundles without a CLIP
    (seeded random weights, a directory without text_encoder/), cached per
    prompt (`EmbeddingCache`).
    The seed is a stable hash of the text (crc32), so a prompt gives the
    same embedding in every process; its values are not the JAX encoder's,
    which come from `jax.random`."""

    def __init__(self, dim: int = 64, max_length: int = 77,
                 device: Optional[torch.device] = None):
        super().__init__()
        self.dim = dim
        self.max_length = max_length
        self.device = torch.device("cpu") if device is None else torch.device(device)

    def _encode(self, text: str) -> torch.Tensor:
        seed = zlib.crc32(("comfystereo\x00" + text).encode("utf-8"))
        gen = torch.Generator().manual_seed(seed)
        emb = torch.randn((1, self.max_length, self.dim), generator=gen) * 0.02
        return emb.to(self.device)


def load_hf_text_encoder(model_id: str = "openai/clip-vit-base-patch32", device=None):
    """Prompt -> float32 [1, 77, hidden] through transformers' CLIP text
    model (torch), on `device` (None means CUDA). Gated: needs `transformers`
    and the model in the local cache or at a local path."""
    from transformers import CLIPTextModel, CLIPTokenizer  # gated import

    from ..device import resolve_device

    dev = resolve_device(device)
    tokenizer = CLIPTokenizer.from_pretrained(model_id)
    model = CLIPTextModel.from_pretrained(model_id).to(dev).eval()

    @torch.no_grad()
    def encode(text: str) -> torch.Tensor:
        tokens = tokenizer([text], padding="max_length",
                           max_length=tokenizer.model_max_length,
                           truncation=True, return_tensors="pt")
        return model(tokens.input_ids.to(dev)).last_hidden_state.float()

    return encode


@dataclasses.dataclass
class DiffusionModel:
    """Functional bundle consumed by the pipelines.

    unet_apply(latents_nchw, t, context, mode=None, stereo_active=False) -> eps
    vae_encode(x) / vae_decode(z), with the latent scaling (`latent_scale`:
    SD's 0.18215 by default, SDXL's 0.13025) OUTSIDE.
    All three take and return float32 tensors on `device`. A bundle whose
    UNet takes SDXL's text-time conditioning has a `pooled_encode` (prompt
    -> pooled text embedding [1, D] float32), and its `unet_apply` then
    also takes `text_embeds` [B, D] and `time_ids` [B, 6] by keyword.
    """

    unet_apply: Callable
    vae_encode: Callable
    vae_decode: Callable
    text_encode: Callable
    device: torch.device
    latent_channels: int = 4
    context_dim: int = 64
    # UNet input channels; 9 selects the SD-inpainting concat path
    # (latents + mask + masked-image latents).
    unet_in_channels: int = 4
    # Native pixel resolution the model was trained at; the node resizes
    # inputs to this square before diffusion and results back afterwards.
    sample_size: int = 512
    unet: Optional[torch.nn.Module] = None
    vae: Optional[torch.nn.Module] = None
    latent_scale: float = LATENT_SCALE
    pooled_encode: Optional[Callable] = None


def make_toy_model(seed: int = 0, image_size: int = 32, cfg: UNetConfig = UNetConfig(),
                   device=None, unet_state=None, vae_state=None,
                   text_encode: Optional[Callable] = None) -> DiffusionModel:
    """Small random-weight model wiring the whole stack, in float32: the
    given state dicts (e.g. from `porting.toy_state_dicts_from_jax`), else
    seeded random weights (`porting.random_init_`, UNet from `seed`, VAE
    from `seed + 1`). `device=None` means CUDA."""
    from ..device import resolve_device
    from .porting import random_init_

    dev = resolve_device(device)
    unet, vae = LatentUNet(cfg), SimpleVAE(latent_channels=cfg.in_channels)
    for module, state, s in ((unet, unet_state, seed), (vae, vae_state, seed + 1)):
        if state is None:
            random_init_(module, s)
        else:
            module.load_state_dict(state)
        module.requires_grad_(False).eval().to(dev)

    def unet_apply(latents, t, context, mode: Optional[AttentionMode] = None,
                   stereo_active: bool = False):
        return unet(latents, t, context, mode=mode or AttentionMode(),
                    stereo_active=stereo_active)

    return DiffusionModel(
        unet_apply=unet_apply, vae_encode=vae.encode, vae_decode=vae.decode,
        text_encode=text_encode or HashTextEncoder(dim=cfg.context_dim, device=dev),
        device=dev, latent_channels=cfg.in_channels, context_dim=cfg.context_dim,
        sample_size=image_size, unet=unet, vae=vae)
