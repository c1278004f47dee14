"""Tensor operations of the Stereo Diffusion node's Fast path with an
SDXL-inpainting UNet and the SD VAE, counted from the widths in the
configuration's settings (the published `unet` and `vae` keys), and the
shapes of the flash launches of one UNet call; what `counts/sd.py` counts
for SD 1.x, with SDXL's topology: attention on the levels that
`down_block_types` names, each spatial transformer its level's depth of
transformer blocks (the mid block the deepest level's), linear projections
in and out (as many operations as SD's 1x1 convolutions), and the
text-time embedding's MLP (`add_embedding`) per latent row beside the
timestep's. The VAE's encode and decode, the UNet calls of a Fast call and
one flash launch's bytes and operations are `counts/sd.py`'s.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from stereo_bench.counts.sd import (CONTEXT_TOKENS, attention, conv, latent_size, linear,
                                    resnet, unet_calls, vae_decode, vae_encode)


def transformer(c: int, h: int, w: int, context: int, depth: int) -> int:
    """A spatial transformer: linear projections in and out, and `depth`
    blocks of self-attention, cross-attention over the 77 context tokens
    and GEGLU feed-forward."""
    n = h * w
    self_attn = 4 * linear(c, c, n) + attention(n, n, c)
    cross = 2 * linear(c, c, n) + 2 * linear(context, c, CONTEXT_TOKENS) \
        + attention(n, CONTEXT_TOKENS, c)
    ff = linear(c, 8 * c, n) + linear(4 * c, c, n)
    return 2 * linear(c, c, n) + depth * (self_attn + cross + ff)


def _attention_levels(cfg: Dict) -> List[bool]:
    return [kind == "CrossAttnDownBlock2D" for kind in cfg["down_block_types"]]


def unet(cfg: Dict, latent: int) -> int:
    """One latent row of the UNet at latent x latent."""
    chans, n, layers = list(cfg["block_out_channels"]), len(cfg["block_out_channels"]), \
        cfg["layers_per_block"]
    ctx, temb = cfg["cross_attention_dim"], 4 * chans[0]
    attn, depth = _attention_levels(cfg), list(cfg["transformer_layers_per_block"])
    ops = linear(chans[0], temb, 1) + linear(temb, temb, 1)
    ops += linear(cfg["projection_class_embeddings_input_dim"], temb, 1) + linear(temb, temb, 1)
    ops += conv(cfg["in_channels"], chans[0], 3, latent, latent)
    skips, prev, s = [chans[0]], chans[0], latent
    for i, ch in enumerate(chans):
        last = i == n - 1
        for j in range(layers):
            ops += resnet(prev if j == 0 else ch, ch, s, s, temb)
            if attn[i]:
                ops += transformer(ch, s, s, ctx, depth[i])
        skips += [ch] * (layers + (0 if last else 1))
        if not last:
            s //= 2
            ops += conv(ch, ch, 3, s, s)
        prev = ch
    ops += 2 * resnet(prev, prev, s, s, temb) + transformer(prev, s, s, ctx, depth[-1])
    for i, ch in enumerate(reversed(chans)):
        level = n - 1 - i
        for _ in range(layers + 1):
            ops += resnet(prev + skips.pop(), ch, s, s, temb)
            prev = ch
            if attn[level]:
                ops += transformer(ch, s, s, ctx, depth[level])
        if i < n - 1:
            s *= 2
            ops += conv(ch, ch, 3, s, s)
    return ops + conv(chans[0], cfg["out_channels"], 3, latent, latent)


def fast_frame(settings: Dict, size: int) -> int:
    """Tensor operations of one frame of the Fast path at size x size."""
    lat = latent_size(settings["vae"], size)
    rows = 2 * unet_calls(settings)
    return (rows * unet(settings["unet"], lat) + 2 * vae_encode(settings["vae"], size)
            + vae_decode(settings["vae"], size))


def flash_shapes(settings: Dict, size: int) -> List[Tuple[int, int, int, int]]:
    """(batch x heads, q length, key length, head width) of each flash
    launch of one UNet call (the guidance's two rows in each), in the order
    the forward makes them: the self-attention of every transformer block
    on a level with attention whose tokens the flash route takes
    (`kernels/flash_attention.py: supports`: 1,024 or more, a multiple of
    128, heads of at most 128), down, mid and up."""
    cfg = settings["unet"]
    chans, n, layers = list(cfg["block_out_channels"]), len(cfg["block_out_channels"]), \
        cfg["layers_per_block"]
    attn, depth, heads = _attention_levels(cfg), cfg["transformer_layers_per_block"], \
        cfg["attention_head_dim"]
    lat = latent_size(settings["vae"], size)

    def level(i: int, transformers: int, mid: bool = False) -> List[Tuple[int, int, int, int]]:
        s = lat // 2 ** i
        t, d = s * s, chans[i] // heads[i]
        if not (attn[i] or mid) or t < 1024 or t % 128 or d > 128:
            return []
        return [(2 * heads[i], t, t, d)] * (transformers * depth[i])

    out = []
    for i in range(n):
        out += level(i, layers)
    out += level(n - 1, 1, mid=True)
    for i in reversed(range(n)):
        out += level(i, layers + 1)
    return out
