"""Port's flash-attention wrapper and attention module vs the JAX package.

On the CPU the wrapper runs its plain version (`reference`), which has the
TPU kernel's numerics; it is held against JAX's `_reference` and against
the Pallas kernel in interpret mode, at JAX's own bound (atol 4e-3 on bf16
outputs, tests/test_flash_attention.py). `standard_attention` and
`bn_attention` are held against the JAX functions on the CPU. Inputs are
numpy draws from a seed, rounded to bf16 the same way on both sides.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from comfystereo_tpu.diffusion import attention as jatt
from comfystereo_tpu.pallas import flash_attention as jfa
from comfystereo_tpu_torch.diffusion import attention as tatt
from comfystereo_tpu_torch.kernels import flash_attention as tfa

SHAPES = [(4, 1024, 1024, 40), (2, 1024, 2048, 40), (2, 1024, 1024, 80)]


def _qkv(shape, seed, lead=()):
    bh, nq, nk, d = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(lead + (bh, n, d), dtype=np.float32)
            for n in (nq, nk, nk)]


def _both(arrays, dtype):
    """numpy f32 -> (jax arrays, torch tensors) of `dtype` ('bfloat16' or
    'float32'); both round to nearest even."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def jax_outputs():
    """JAX's `_reference` and interpret-mode kernel for every shape, once."""
    out = {}
    for i, shape in enumerate(SHAPES):
        (q, k, v), _ = _both(_qkv(shape, i), "bfloat16")
        scale = shape[3] ** -0.5
        out[shape] = (np.asarray(jfa._reference(q, k, v, scale), np.float32),
                      np.asarray(jfa.flash_attention(q, k, v, scale, True), np.float32))
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_reference_and_kernel(shape, jax_outputs):
    i = SHAPES.index(shape)
    _, (q, k, v) = _both(_qkv(shape, i), "bfloat16")
    before = tfa.LAUNCHES
    got = tfa.flash_attention(q, k, v, shape[3] ** -0.5)
    assert tfa.LAUNCHES == before  # the CPU runs the plain version
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(q.shape)
    want_ref, want_kernel = jax_outputs[shape]
    np.testing.assert_allclose(_np(got), want_ref, rtol=0, atol=4e-3)
    np.testing.assert_allclose(_np(got), want_kernel, rtol=0, atol=4e-3)


def test_reference_bf16_matches_jax():
    (jq, jk, jv), (q, k, v) = _both(_qkv((2, 256, 384, 40), 7), "bfloat16")
    want = jfa._reference_bf16(jq, jk, jv, 40 ** -0.5)
    got = tfa.reference_bf16(q, k, v, 40 ** -0.5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=4e-3)


@pytest.mark.parametrize("d", [20, 36])
def test_pad_head_dim_matches_unpadded_and_jax(d):
    """The wrapper's step for d % 8 != 0 (TMA needs 16-byte rows): `reference`
    on q, k and v zero-padded to a multiple of 8 and sliced back equals
    `reference` on the originals and JAX's `_reference` (atol 4e-3)."""
    shape = (2, 1024, 1024, d)
    (jq, jk, jv), (q, k, v) = _both(_qkv(shape, d), "bfloat16")
    dk = tfa.tma_head_dim(d)
    assert dk % 8 == 0 and d < dk < d + 8
    padded = [tfa.pad_head_dim(t, dk) for t in (q, k, v)]
    for t, pt in zip((q, k, v), padded):
        assert pt.shape[-1] == dk and pt.is_contiguous()
        assert torch.equal(pt[..., :d], t) and not bool(pt[..., d:].any())
    got = tfa.reference(*padded, d ** -0.5)[..., :d]
    np.testing.assert_allclose(_np(got), _np(tfa.reference(q, k, v, d ** -0.5)),
                               rtol=0, atol=4e-3)
    want = np.asarray(jfa._reference(jq, jk, jv, d ** -0.5), np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=4e-3)


def test_tma_head_dim_rounds_up_to_16_bytes():
    assert [tfa.tma_head_dim(d) for d in (8, 20, 36, 40, 64, 80, 127, 128)] == \
        [8, 24, 40, 40, 64, 80, 128, 128]
    t = torch.zeros(3, 5, 40, dtype=torch.bfloat16)
    assert tfa.pad_head_dim(t, 40) is t  # already 16-byte rows: no copy
    view = torch.zeros(3 * 5 * 40 + 1, dtype=torch.bfloat16)[1:].view(3, 5, 40)
    moved = tfa.pad_head_dim(view, 40)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, view)


GATING = [(1024, 1024, 40, "float32"), (512, 1024, 40, "bfloat16"),
          (1024, 1000, 40, "bfloat16"), (1024, 1024, 160, "bfloat16"),
          (1056, 1024, 40, "bfloat16"), (4096, 4096, 40, "bfloat16"),
          (4096, 8192, 40, "bfloat16"), (1024, 77, 40, "bfloat16"),
          (256, 256, 40, "bfloat16"), (1024, 1024, 80, "bfloat16"),
          (4096, 65536, 128, "bfloat16"), (4096, 32768, 40, "bfloat16"),
          (1152, 1024, 20, "bfloat16")]


@pytest.mark.parametrize("nq,nk,d,dtype", GATING)
def test_supports_and_pick_bq_match_jax(nq, nk, d, dtype):
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    assert tfa.supports(nq, nk, d, tdt) == jfa.supports(nq, nk, d, jdt)
    assert tfa._pick_bq(nq, nk, d) == jfa._pick_bq(nq, nk, d)


def test_wrapper_raises_outside_supports():
    q = torch.zeros(2, 512, 40, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, 0.1)
    with pytest.raises(ValueError):
        tfa.flash_attention(q.float(), q.float(), q.float(), 0.1)


@pytest.mark.parametrize("dtype,shape", [
    ("float32", (2, 4, 256, 64, 40)),     # f32 logits (the torch-parity path)
    ("float32", (1, 2, 1024, 1024, 8)),   # f32 never takes the kernel route
    ("bfloat16", (2, 4, 256, 256, 40)),   # bf16, nq < 1024: bf16 logits
    ("bfloat16", (2, 4, 1024, 77, 40)),   # bf16 cross-attention: nk % 128
])
def test_standard_attention_matches_jax(dtype, shape):
    b, h, nq, nk, d = shape
    arrays = _qkv((h, nq, nk, d), nq + nk + d, lead=(b,))
    (jq, jk, jv), (q, k, v) = _both(arrays, dtype)
    want = jatt.standard_attention(jq, jk, jv, d ** -0.5)
    got = tatt.standard_attention(q, k, v, d ** -0.5)
    assert got.dtype == q.dtype
    # f32: one f32 matmul pair, summation order only; bf16: bf16 logits and
    # outputs, so a few bf16 ulps of O(1) values.
    atol = 1e-5 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def test_standard_attention_kernel_route_matches_jax_reference():
    """A supported bf16 shape takes the kernel route: on the CPU its plain
    version, the numerics of the JAX kernel (not of JAX's CPU fallback)."""
    b, h, n, d = 2, 2, 1024, 40
    (jq, jk, jv), (q, k, v) = _both(_qkv((h, n, n, d), 11, lead=(b,)), "bfloat16")
    want = jfa._reference(jq.reshape(b * h, n, d), jk.reshape(b * h, n, d),
                          jv.reshape(b * h, n, d), d ** -0.5).reshape(b, h, n, d)
    got = tatt.standard_attention(q, k, v, d ** -0.5)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=4e-3)


@pytest.mark.parametrize("direction", ["uni", "bi"])
@pytest.mark.parametrize("use_cfg", [True, False])
@pytest.mark.parametrize("active", [True, False])
def test_bn_attention_matches_jax(direction, use_cfg, active):
    b = 4 if use_cfg else 2
    h, n, d = 2, 64, 16
    arrays = _qkv((h, n, n, d), 3, lead=(b,))
    (jq, jk, jv), (q, k, v) = _both(arrays, "float32")
    mode_j = jatt.AttentionMode(stereo=True, direction=direction, use_cfg=use_cfg)
    mode_t = tatt.AttentionMode(stereo=True, direction=direction, use_cfg=use_cfg)
    want = jatt.bn_attention(jq, jk, jv, d ** -0.5, is_cross=False, mode=mode_j,
                             active=jnp.asarray(active))
    got = tatt.bn_attention(q, k, v, d ** -0.5, is_cross=False, mode=mode_t,
                            active=active)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)


def test_bn_attention_cross_and_bf16_match_jax():
    """Cross-attention stays standard under a stereo mode; a bf16 'bi' pair
    outside the kernel gate uses bf16 logits on both sides."""
    mode_j = jatt.AttentionMode(stereo=True, direction="bi")
    mode_t = tatt.AttentionMode(stereo=True, direction="bi")
    (jq, jk, jv), (q, k, v) = _both(_qkv((2, 64, 77, 16), 5, lead=(4,)), "float32")
    want = jatt.bn_attention(jq, jk, jv, 0.25, is_cross=True, mode=mode_j, active=True)
    got = tatt.bn_attention(q, k, v, 0.25, is_cross=True, mode=mode_t, active=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)
    (jq, jk, jv), (q, k, v) = _both(_qkv((2, 256, 256, 40), 6, lead=(4,)), "bfloat16")
    want = jatt.bn_attention(jq, jk, jv, 40 ** -0.5, is_cross=False, mode=mode_j,
                             active=True)
    got = tatt.bn_attention(q, k, v, 40 ** -0.5, is_cross=False, mode=mode_t,
                            active=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1.6e-2)


# --- the gradient --------------------------------------------------------------

GRAD_SHAPE = (2, 1024, 1024, 40)


def _port_grads(fn, q, k, v, scale):
    """Gradients of sum(o^2) w.r.t. q, k, v through `fn`, as f32 numpy."""
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*qkv, scale)
    (out.float() ** 2).sum().backward()
    return out, [_np(t.grad) for t in qkv]


def test_flash_gradient_matches_jax_kernel_vjp():
    """The port's gradient through `flash_attention` on the CPU (forward
    `reference`, backward the recompute of `reference_bf16`) against
    jax.grad through the Pallas kernel in interpret mode, whose custom VJP
    recomputes `_reference_bf16`: dq, dk and dv within JAX's own atol 4e-3
    (tests/test_flash_attention.py; measured 1e-3, 2e-3, 1e-3)."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(GRAD_SHAPE, 21), "bfloat16")
    scale = GRAD_SHAPE[3] ** -0.5

    def loss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention(q_, k_, v_, scale, True).astype(jnp.float32) ** 2)

    want = [np.asarray(g, np.float32) for g in jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)]
    before = tfa.LAUNCHES
    out, got = _port_grads(tfa.flash_attention, q, k, v, scale)
    assert tfa.LAUNCHES == before
    assert type(out.grad_fn).__name__.startswith("FlashAttentionFn")
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=4e-3)


def test_flash_backward_is_the_reference_bf16_vjp():
    """Given one cotangent, the wrapper's backward is `reference_bf16`'s
    autograd VJP bit for bit (one recompute, nothing else), also when the
    caller runs under `torch.no_grad()` elsewhere."""
    _, (q, k, v) = _both(_qkv(GRAD_SHAPE, 22), "bfloat16")
    scale = GRAD_SHAPE[3] ** -0.5
    g = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (2, 1024, 40), dtype=np.float32)).to(torch.bfloat16)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(tfa.flash_attention(*qkv, scale), qkv, g)
    want = torch.autograd.grad(tfa.reference_bf16(*qkv, scale), qkv, g)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    with torch.no_grad():
        out = tfa.flash_attention(*qkv, scale)
    assert out.grad_fn is None and torch.equal(out, tfa.reference(q, k, v, scale))
