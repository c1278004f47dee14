"""Tensor operations of the Stereo Diffusion node's Fast path with an SD
1.x-inpainting UNet and the SD VAE, counted from the widths in the
configuration's settings (the published `unet` and `vae` keys), and the
bytes, tensor operations and exponentials of one launch of the flash
attention kernel.

An operation is a multiply or an add of a matrix product or a convolution
(2 per multiply-accumulate), as `torch.utils.flop_counter` counts them:
every convolution, every linear layer (the time MLP and the resnets' time
projections per latent row included) and both products of every attention,
softmax(Q K^T / sqrt(d)) V (4 N M C for N queries, M keys, width C). Norms,
activations, softmax, resampling and the scheduler's element-wise work are
not counted. A call of the Fast path on one frame runs the UNet on
2 x `unet_calls` latent rows (the guidance's unconditional and conditional
halves), encodes twice (the prefilled image and the masked image) and
decodes once.

The flash kernel (`flash_fwd_kernel`) takes the UNet's bf16
self-attentions of at least 1,024 tokens (`kernels/flash_attention.py:
supports`: q length >= 1024 and divisible by 128, the keys a multiple of
the online chunk, head width <= 128), once per transformer of such a level
and UNet call, with the guidance's two rows and every head in one launch.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

CONTEXT_TOKENS = 77


def conv(cin: int, cout: int, k: int, h: int, w: int) -> int:
    """A k x k convolution to an h x w output."""
    return 2 * cin * cout * k * k * h * w


def linear(nin: int, nout: int, rows: int) -> int:
    return 2 * nin * nout * rows


def attention(n: int, m: int, c: int) -> int:
    """Both products of an attention of n queries over m keys of width c
    (all heads together)."""
    return 4 * n * m * c


def resnet(cin: int, cout: int, h: int, w: int, temb: int = 0) -> int:
    ops = conv(cin, cout, 3, h, w) + conv(cout, cout, 3, h, w)
    if temb:
        ops += linear(temb, cout, 1)
    if cin != cout:
        ops += conv(cin, cout, 1, h, w)
    return ops


def transformer(c: int, h: int, w: int, context: int) -> int:
    """A spatial transformer: 1x1 convs in and out, self-attention,
    cross-attention over the 77 context tokens, GEGLU feed-forward."""
    n = h * w
    self_attn = 4 * linear(c, c, n) + attention(n, n, c)
    cross = 2 * linear(c, c, n) + 2 * linear(context, c, CONTEXT_TOKENS) \
        + attention(n, CONTEXT_TOKENS, c)
    ff = linear(c, 8 * c, n) + linear(4 * c, c, n)
    return 2 * conv(c, c, 1, h, w) + self_attn + cross + ff


def unet(cfg: Dict, latent: int) -> int:
    """One latent row of the UNet at latent x latent."""
    chans, n, layers = list(cfg["block_out_channels"]), len(cfg["block_out_channels"]), \
        cfg["layers_per_block"]
    ctx, temb = cfg["cross_attention_dim"], 4 * chans[0]
    ops = linear(chans[0], temb, 1) + linear(temb, temb, 1)
    ops += conv(cfg["in_channels"], chans[0], 3, latent, latent)
    skips, prev, s = [chans[0]], chans[0], latent
    for i, ch in enumerate(chans):
        last = i == n - 1
        for j in range(layers):
            ops += resnet(prev if j == 0 else ch, ch, s, s, temb)
            if not last:
                ops += transformer(ch, s, s, ctx)
        skips += [ch] * (layers + (0 if last else 1))
        if not last:
            s //= 2
            ops += conv(ch, ch, 3, s, s)
        prev = ch
    ops += 2 * resnet(prev, prev, s, s, temb) + transformer(prev, s, s, ctx)
    for i, ch in enumerate(reversed(chans)):
        for _ in range(layers + 1):
            ops += resnet(prev + skips.pop(), ch, s, s, temb)
            prev = ch
            if i > 0:
                ops += transformer(ch, s, s, ctx)
        if i < n - 1:
            s *= 2
            ops += conv(ch, ch, 3, s, s)
    return ops + conv(chans[0], cfg["out_channels"], 3, latent, latent)


def _vae_mid(c: int, s: int) -> int:
    return 2 * resnet(c, c, s, s) + 4 * linear(c, c, s * s) + attention(s * s, s * s, c)


def latent_size(cfg: Dict, size: int) -> int:
    return size // 2 ** (len(cfg["block_out_channels"]) - 1)


def vae_encode(cfg: Dict, size: int) -> int:
    """The encoder and the quant conv on one size x size image."""
    chans, layers, z = list(cfg["block_out_channels"]), cfg["layers_per_block"], \
        cfg["latent_channels"]
    ops, prev, s = conv(cfg["in_channels"], chans[0], 3, size, size), chans[0], size
    for i, ch in enumerate(chans):
        for j in range(layers):
            ops += resnet(prev if j == 0 else ch, ch, s, s)
        prev = ch
        if i < len(chans) - 1:
            s //= 2
            ops += conv(ch, ch, 3, s, s)
    ops += _vae_mid(prev, s) + conv(prev, 2 * z, 3, s, s)
    return ops + conv(2 * z, 2 * z, 1, s, s)


def vae_decode(cfg: Dict, size: int) -> int:
    """The post-quant conv and the decoder to one size x size image."""
    rev, layers, z = list(reversed(cfg["block_out_channels"])), cfg["layers_per_block"], \
        cfg["latent_channels"]
    s = latent_size(cfg, size)
    ops = conv(z, z, 1, s, s) + conv(z, rev[0], 3, s, s) + _vae_mid(rev[0], s)
    prev = rev[0]
    for i, ch in enumerate(rev):
        for j in range(layers + 1):
            ops += resnet(prev if j == 0 else ch, ch, s, s)
        prev = ch
        if i < len(rev) - 1:
            s *= 2
            ops += conv(ch, ch, 3, s, s)
    return ops + conv(prev, cfg["out_channels"], 3, s, s)


def unet_calls(settings: Dict) -> int:
    """UNet calls of one Fast call: the PLMS list (steps + 1 timesteps)
    from the strength's start on."""
    steps = int(settings["num_inference_steps"])
    start = min(int(steps * (1.0 - float(settings["denoise_strength"]))), steps - 1)
    return steps + 1 - start


def fast_frame(settings: Dict, size: int) -> int:
    """Tensor operations of one frame of the Fast path at size x size."""
    lat = latent_size(settings["vae"], size)
    rows = 2 * unet_calls(settings)
    return (rows * unet(settings["unet"], lat) + 2 * vae_encode(settings["vae"], size)
            + vae_decode(settings["vae"], size))


def flash_shapes(settings: Dict, size: int) -> List[Tuple[int, int, int, int]]:
    """(batch x heads, q length, key length, head width) of each flash
    launch of one UNet call."""
    cfg = settings["unet"]
    heads, layers = cfg["attention_head_dim"], cfg["layers_per_block"]
    s = latent_size(settings["vae"], size)
    out = []
    for ch in list(cfg["block_out_channels"])[:-1]:  # the levels with attention
        n, d = s * s, ch // heads
        if n >= 1024 and n % 128 == 0 and d <= 128:
            out += [(2 * heads, n, n, d)] * (2 * layers + 1)
        s //= 2
    return out


def flash(bh: int, nq: int, nk: int, d: int) -> Tuple[float, float, float]:
    """(bytes, tensor operations, exponentials) of one flash launch: q, k, v
    read and the output written once in bf16; both products; one
    exponential per logit."""
    return 2.0 * bh * d * (2 * nq + 2 * nk), 4.0 * bh * nq * nk * d, float(bh) * nq * nk
