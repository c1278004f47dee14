"""Bilateral-Neighbor (BN) attention for stereo-consistent diffusion.

Port of `comfystereo_tpu/diffusion/attention.py`. Attention behaviour is a
plain function selected by an `AttentionMode` value that the UNet threads
through every layer: after the stereo start step, each self-attention
recomputes with the left and right views' tokens pooled along the sequence
axis ('uni': keys and values from the left view only; 'bi': both). Under
CFG the batch layout is [uncond_L, uncond_R, cond_L, cond_R].

`standard_attention` keeps the JAX package's three forms, chosen by the same
rule: f32 inputs take f32 logits; bf16 inputs at shapes the flash kernel
`supports` take the kernel route (`kernels/flash_attention.py`: the CUDA
kernel on the card, its plain version with the TPU kernel's numerics on the
CPU); other bf16 shapes materialise bf16 logits and run the softmax
normalisation in f32.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import flash_attention as fa


@dataclasses.dataclass(frozen=True)
class AttentionMode:
    """Static attention configuration for one UNet invocation."""

    stereo: bool = False          # apply BN attention to self-attention
    direction: str = "uni"        # 'uni' | 'bi'
    use_cfg: bool = True          # batch is [u_L, u_R, c_L, c_R] vs [L, R]


def _softmax_last(sim: torch.Tensor) -> torch.Tensor:
    """exp(x - max) / sum over the last axis, the form jax.nn.softmax uses."""
    m = sim.amax(dim=-1, keepdim=True)
    e = torch.exp(sim - m)
    return e / e.sum(dim=-1, keepdim=True)


def standard_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """Plain softmax attention. q, k, v: [B, H, N, D]."""
    if q.dtype == torch.bfloat16:
        b, h, n, d = q.shape
        nk = k.shape[2]
        if fa.supports(n, nk, d, q.dtype):
            out = fa.flash_attention(q.reshape(b * h, n, d),
                                     k.reshape(b * h, nk, d),
                                     v.reshape(b * h, nk, d), scale)
            return out.reshape(b, h, n, d)
        return fa.reference_bf16(q, k, v, scale)
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = _softmax_last(sim).to(v.dtype)
    return torch.matmul(attn, v)


def _stereo_pair_attention(q, k, v, scale: float, uni: bool) -> torch.Tensor:
    """BN attention over a [2b, H, N, D] (left, right) stacked batch: queries
    stay per view; keys and values pool both views' tokens, or with `uni`
    come from the left view only."""
    two_b, h, n, d = q.shape
    b = two_b // 2
    ks = k.reshape(2, b, h, n, d)
    vs = v.reshape(2, b, h, n, d)
    if uni:
        k_cat, v_cat = ks[0], vs[0]
    else:
        k_cat = torch.cat([ks[0], ks[1]], dim=2)          # [b, h, 2n, d]
        v_cat = torch.cat([vs[0], vs[1]], dim=2)
    k_rep = torch.cat([k_cat, k_cat], dim=0)
    v_rep = torch.cat([v_cat, v_cat], dim=0)
    return standard_attention(q, k_rep, v_rep, scale)


def bn_attention(q, k, v, scale: float, *, is_cross: bool,
                 mode: AttentionMode, active: bool) -> torch.Tensor:
    """Attention with optional stereo coupling. q, k, v: [B, H, N, D].
    Cross-attention always stays standard; `active` says whether the
    current step has passed the stereo start step (a host-side bool: the
    denoising loop is a Python loop)."""
    if is_cross or not mode.stereo or not active:
        return standard_attention(q, k, v, scale)
    uni = mode.direction == "uni"
    if mode.use_cfg:
        half = q.shape[0] // 2
        return torch.cat([
            _stereo_pair_attention(q[:half], k[:half], v[:half], scale, uni),
            _stereo_pair_attention(q[half:], k[half:], v[half:], scale, uni)],
            dim=0)
    return _stereo_pair_attention(q, k, v, scale, uni)
