"""Softmax attention for the SD UNet's bf16 self-attentions.

Kernel: `csrc/flash_attention.cu`, CUDA C++ for sm_90a, replacing the Pallas
kernel `comfystereo_tpu/pallas/flash_attention.py:flash_attention`
(`_flash_call`, `_kernel`). It keeps the N^2 logits on the SM: f32 logits
from bf16 products, an online softmax over key tiles with an f32 running
max, sum and accumulator, and bf16 weights in the product with v. TMA loads
the tiles and `wgmma` multiplies them. At the UNet's level-0 shape the
exponentials bound it (see the source's header).

TMA needs rows of a multiple of 16 bytes, so the wrapper zero-pads q, k and
v to a head dimension of a multiple of 8 (`pad_head_dim`) and slices the
output back; zero columns change no logit, and v's zero columns give output
columns that are dropped. No UNet has such a head dimension.

`flash_attention` launches the kernel for CUDA tensors and runs the plain
version, `reference` (the counterpart of JAX's `_reference`: the same
numerics with the logits materialised in f32), for CPU tensors. Like the
JAX kernel it takes only the shapes `supports` admits, by the same rule:
bf16, d <= 128, nk a multiple of 128, nq >= 1024 and a q block that fits the
TPU kernel's VMEM budget (`_pick_bq`). Callers check `supports` first, as
`diffusion/attention.py:standard_attention` does; other shapes raise.

`reference_bf16` is the counterpart of `_reference_bf16` (bf16 logits,
f32 exp and sum). The gradient is the JAX package's custom VJP: the
forward (kernel or `reference`) saves q, k and v only, and the backward, on
both devices, recomputes `reference_bf16` once and differentiates it
(`FlashAttentionFn`). There is no backward kernel, as the JAX package has
none: its VJP runs in XLA, outside any Pallas kernel. The backward launches
nothing, and `LAUNCHES` counts forward launches only, as the host makes
them: a UNet call served by a CUDA graph's replay adds none.
"""
from __future__ import annotations

import torch

from . import _common

# Host launches since the last reset (plain-version calls don't count): a
# CUDA graph's capture counts each launch it records once, and its replays
# (`diffusion/sd_unet.py:GraphedUNet`) run them on the card uncounted.
LAUNCHES = 0

_LANES = 128
_CK = 1024  # the TPU kernel's KV chunk; enters only the feasibility rule
_VMEM_BUDGET = int((16 << 20) / 1.3)


def _pick_bq(nq: int, nk: int, d: int) -> int:
    """The TPU kernel's q block for these sizes, 0 when none fits its VMEM
    budget (`flash_attention.py:_pick_bq`, the same rule)."""
    ck = min(_CK, nk)
    for bq in (512, 256, 128):
        if nq % bq:
            continue
        need = (2 * nk * d * 2 + 4 * bq * d * 2 + bq * ck * (4 + 2)
                + bq * d * 4)
        if need <= _VMEM_BUDGET:
            return bq
    return 0


def supports(nq: int, nk: int, d: int, dtype) -> bool:
    """True when the JAX package would take its kernel for these shapes:
    bf16, kv length a multiple of 128 and of the online chunk, head_dim <=
    128, q length >= 1024 and divisible by a feasible block."""
    return (dtype == torch.bfloat16 and d <= _LANES and nk % _LANES == 0
            and nk % min(_CK, nk) == 0 and nq >= 1024
            and _pick_bq(nq, nk, d) > 0)


def reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """The plain version: f32 logits from the bf16 products, f32 softmax,
    bf16 weights times v. q [..., Nq, D], k and v [..., Nk, D]."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True).detach()
    e = torch.exp((s - m) * scale)
    a = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.matmul(a, v)


def reference_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """bf16-materialised logits, f32 exp and sum: the formulation
    `standard_attention` uses for bf16 shapes outside `supports`, and the
    one the kernel's backward differentiates. The row max is a constant to
    autograd, as JAX's `stop_gradient` makes it."""
    s = torch.matmul(q, k.transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True).detach()
    e = torch.exp((s.float() - m.float()) * scale)
    a = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.matmul(a, v)


def tma_head_dim(d: int) -> int:
    """The head dimension the kernel runs at: d rounded up to a multiple of
    8 (16-byte rows of bf16)."""
    return -(-d // 8) * 8


def pad_head_dim(t: torch.Tensor, d: int) -> torch.Tensor:
    """t [..., D] zero-padded on its last axis to d >= D columns, contiguous
    and 16-byte aligned (a fresh tensor unless it already was all three)."""
    if t.shape[-1] != d:
        t = torch.nn.functional.pad(t, (0, d - t.shape[-1]))
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             scale: float) -> torch.Tensor:
    """The kernel for CUDA tensors, `reference` for CPU tensors."""
    global LAUNCHES
    if q.device.type == "cpu":
        return reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    from . import _build

    bh, nq, d = q.shape
    nk = k.shape[1]
    dk = tma_head_dim(d)
    q, k, v = (pad_head_dim(t, dk) for t in (q, k, v))
    out = torch.empty_like(q)
    err = _common.launch(
        _build.library("flash_attention").cs_flash_attention_bf16,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, nq, nk, dk,
        float(scale), device=q.device)
    _build.check(err, "flash_attention kernel launch")
    LAUNCHES += 1
    return out if dk == d else out[..., :d].contiguous()


class FlashAttentionFn(torch.autograd.Function):
    """Forward: `_forward` (the kernel on the card). Backward: one recompute
    of `reference_bf16` from the saved q, k, v, differentiated by autograd;
    the JAX package's `_bwd` exactly."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = reference_bf16(*qkv, ctx.scale)
            grads = torch.autograd.grad(out, qkv, g)
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Softmax attention, q [BH, Nq, D], k and v [BH, Nk, D] bf16 ->
    [BH, Nq, D] bf16: the CUDA kernel for CUDA tensors, `reference` for CPU
    tensors, differentiable through `FlashAttentionFn`. Raises for shapes
    outside `supports`."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention: expected q, k, v of shape [BH, N, D]")
    bh, nq, d = q.shape
    nk = k.shape[1]
    if tuple(k.shape) != (bh, nk, d) or tuple(v.shape) != (bh, nk, d):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v must share one dtype")
    if not supports(nq, nk, d, q.dtype):
        raise ValueError(f"flash_attention: shape (nq={nq}, nk={nk}, d={d}, "
                         f"{q.dtype}) is outside `supports`")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    return FlashAttentionFn.apply(q, k, v, scale)
