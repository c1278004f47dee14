"""Stable-Diffusion VAE (AutoencoderKL) in PyTorch.

Port of `comfystereo_tpu/diffusion/sd_vae.py`, with the diffusers
state-dict layout (``encoder.down_blocks.0.resnets.1``). NCHW interface with
the SD contract: encode([-1, 1] image) -> latent MEAN (the 0.18215 scale is
applied outside, `models.LATENT_SCALE`), decode(latents) -> [-1, 1]. Group
norms use eps 1e-6 and flax's numerics; the encoder's downsamplers pad
(0, 1) on each spatial axis, the UNet's (1, 1). The mid block's attention is
single-head with f32 logits (d = 512 at full width): it never takes the
flash kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .attention import _softmax_last
from .sd_unet import Downsample2D, GroupNorm, ResnetBlock2D, Upsample2D


@dataclasses.dataclass(frozen=True)
class SDVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32


SD_VAE_CONFIG = SDVAEConfig()
TINY_SD_VAE_CONFIG = SDVAEConfig(block_out_channels=(16, 32),
                                 layers_per_block=1, norm_num_groups=8)


def _vae_resnet(in_ch: int, out_ch: int, groups: int) -> ResnetBlock2D:
    return ResnetBlock2D(in_ch, out_ch, groups, temb_dim=None, eps=1e-6)


class _VAEAttention(nn.Module):
    """Single-head spatial self-attention over [B, H*W, C] tokens."""

    def __init__(self, channels: int, norm_groups: int):
        super().__init__()
        self.group_norm = GroupNorm(norm_groups, channels, 1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        tokens = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(tokens), self.to_k(tokens), self.to_v(tokens)
        # f32 logits and softmax under bf16 inference, as the JAX package.
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (c ** -0.5)
        out = torch.matmul(_softmax_last(sim).to(v.dtype), v)
        out = self.to_out[0](out)
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _VAEMidBlock(nn.Module):
    def __init__(self, channels: int, norm_groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([_vae_resnet(channels, channels, norm_groups)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([_VAEAttention(channels, norm_groups)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class _DownEncoderBlock(nn.Module):
    def __init__(self, in_ch, out_ch, num_layers, norm_groups, add_downsample):
        super().__init__()
        self.resnets = nn.ModuleList([
            _vae_resnet(in_ch if j == 0 else out_ch, out_ch, norm_groups)
            for j in range(num_layers)])
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(out_ch, padding=((0, 1), (0, 1)))])

    def forward(self, x):
        for res in self.resnets:
            x = res(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        return x


class _UpDecoderBlock(nn.Module):
    def __init__(self, in_ch, out_ch, num_layers, norm_groups, add_upsample):
        super().__init__()
        self.resnets = nn.ModuleList([
            _vae_resnet(in_ch if j == 0 else out_ch, out_ch, norm_groups)
            for j in range(num_layers)])
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_ch)])

    def forward(self, x):
        for res in self.resnets:
            x = res(x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class _Encoder(nn.Module):
    def __init__(self, cfg: SDVAEConfig):
        super().__init__()
        chans, groups = cfg.block_out_channels, cfg.norm_num_groups
        n = len(chans)
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            _DownEncoderBlock(chans[max(i - 1, 0)], ch, cfg.layers_per_block,
                              groups, add_downsample=i < n - 1)
            for i, ch in enumerate(chans)])
        self.mid_block = _VAEMidBlock(chans[-1], groups)
        self.conv_norm_out = GroupNorm(groups, chans[-1], 1e-6)
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class _Decoder(nn.Module):
    def __init__(self, cfg: SDVAEConfig):
        super().__init__()
        rev, groups = tuple(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        n = len(rev)
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _VAEMidBlock(rev[0], groups)
        self.up_blocks = nn.ModuleList([
            _UpDecoderBlock(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1,
                            groups, add_upsample=i < n - 1)
            for i, ch in enumerate(rev)])
        self.conv_norm_out = GroupNorm(groups, rev[-1], 1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class SDVAE(nn.Module):
    """AutoencoderKL-equivalent; NCHW interface.

    encode: [B,3,H,W] in [-1,1] -> latent MEAN [B,4,H/8,W/8].
    decode: latents -> [B,3,H,W] in [-1,1].
    """

    def __init__(self, cfg: SDVAEConfig = SD_VAE_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.encoder = _Encoder(cfg)
        self.decoder = _Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels,
                                         cfg.latent_channels, 1)

    def encode(self, img):
        moments = self.quant_conv(self.encoder(img))
        return moments[:, :self.cfg.latent_channels]

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

    def forward(self, img):
        return self.decode(self.encode(img))
