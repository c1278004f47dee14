"""Port's w8 weight storage vs the JAX package's `quantize.py`.

JAX and torch both on the CPU. `q` (int8) and `scale` (float32) are the JAX
package's transposed, bit for bit (the output channel is the last axis of a
flax kernel, axis 0 of a torch weight). The TINY w8 model against the JAX
package's w8 model in float32: eps within atol = rtol = 1e-4 (the bound of
tests/test_torch_port_diffusion.py); against the unquantised model: mean
|delta eps| / mean |eps| < 0.05 (tests/test_quantize.py's bound).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn as nn

from comfystereo_tpu.diffusion import porting as jporting
from comfystereo_tpu.diffusion import quantize as jq
from comfystereo_tpu.diffusion.sd_unet import TINY_SD_UNET_CONFIG as J_TINY_UNET
from comfystereo_tpu.diffusion.sd_unet import SDUNet as JUNet
from comfystereo_tpu.diffusion.sd_vae import TINY_SD_VAE_CONFIG as J_TINY_VAE
from comfystereo_tpu.diffusion.sd_vae import SDVAE as JVAE
from comfystereo_tpu_torch.diffusion import (TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG,
                                             build_sd_model, state_dict_from_jax)
from comfystereo_tpu_torch.diffusion import porting as tporting
from comfystereo_tpu_torch.diffusion import quantize as tq


def _weight(shape, seed, dtype):
    """Weights with a different range per output channel (axis 0)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w *= rng.uniform(0.01, 2.0, size=(shape[0],) + (1,) * (len(shape) - 1)).astype(np.float32)
    w[0] = 0.0  # an all-zero channel takes the 1e-12 floor
    return torch.from_numpy(w).to(dtype)


def _to_flax(t):
    """torch weight [out, in(, kh, kw)] -> flax kernel layout."""
    a = t.float().numpy()
    return a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)


def _from_flax(a):
    a = np.asarray(a)
    return a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(128, 64), (96, 48, 3, 3), (64, 64, 1, 1)])
def test_q_and_scale_bit_equal_jax(shape, dtype):
    w = _weight(shape, sum(shape), dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jq._quantize_kernel(jnp.asarray(_to_flax(w), jdt))
    q, scale = tq.quantize_weight(w)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert tuple(scale.shape) == (shape[0],) + (1,) * (len(shape) - 1)
    assert np.array_equal(q.numpy(), _from_flax(want["__w8__"]))
    assert np.array_equal(scale.numpy().view(np.uint32),
                          np.ascontiguousarray(_from_flax(want["scale"])).view(np.uint32))
    back = tq.dequantize(q, scale, torch.float32)
    absmax = w.float().abs().amax(dim=tuple(range(1, w.dim())), keepdim=True)
    assert bool(((back - w.float()).abs() <= absmax / 254.0 + 1e-7).all())


class _Tree(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(128, 256, 3, stride=2, padding=1)
        self.lin = nn.Linear(300, 300, bias=False)
        self.norm = nn.LayerNorm(256)
        self.tiny = nn.Linear(4, 4)
        self.seq = nn.ModuleList([nn.Linear(256, 512)])


def test_selection_rules_and_double_quantize_guard():
    torch.manual_seed(0)
    tree = _Tree()
    x = torch.randn(2, 128, 8, 8)
    want = tree.conv(x)
    f32_bytes = tq.quantized_bytes(tree)
    tq.quantize_module_(tree, torch.float32, min_elems=65536)
    assert isinstance(tree.conv, tq.W8Conv2d) and isinstance(tree.lin, tq.W8Linear)
    assert isinstance(tree.seq[0], tq.W8Linear)
    assert type(tree.tiny) is nn.Linear and type(tree.norm) is nn.LayerNorm
    assert tree.conv.bias is not None and tree.lin.bias is None
    assert tree.conv.stride == (2, 2) and tree.conv.padding == (1, 1)
    assert tq.quantized_bytes(tree) < 0.3 * f32_bytes
    assert {"conv.q", "conv.scale", "conv.bias", "lin.q", "tiny.weight"} <= set(tree.state_dict())
    assert (tree.conv(x) - want).abs().max() <= 0.05 * want.abs().max()
    q = tree.lin.q.clone()
    tq.quantize_module_(tree, torch.float32, min_elems=1)  # already w8: untouched
    assert isinstance(tree.lin, tq.W8Linear) and torch.equal(tree.lin.q, q)
    assert isinstance(tree.tiny, tq.W8Linear)
    ones = nn.Linear(300, 300)
    nn.init.ones_(ones.weight)
    m = nn.ModuleList([ones])
    tq.quantize_module_(tq.quantize_module_(m, torch.float32, 1024), torch.float32, 1)
    np.testing.assert_allclose(m[0].weight.numpy(), 1.0, atol=1e-2)


@pytest.fixture(scope="module")
def tiny():
    up = jax.jit(JUNet(J_TINY_UNET).init)(jax.random.PRNGKey(5), jnp.zeros((1, 4, 8, 8)),
                                          jnp.zeros(()), jnp.zeros((1, 77, 64)))
    vp = jax.jit(JVAE(J_TINY_VAE).init)(jax.random.PRNGKey(6), jnp.zeros((1, 3, 32, 32)))
    return up, vp


def _w8_leaves(tree, path=()):
    """{port key prefix: (q, scale)} of a JAX w8 tree, in torch layout."""
    out = {}
    for name, child in tree.items():
        if isinstance(child, dict) and "__w8__" in child:
            key = tporting._torch_key(list(path), "")[:-1]
            out[key] = (_from_flax(child["__w8__"]), _from_flax(child["scale"]))
        elif isinstance(child, dict):
            out.update(_w8_leaves(child, path + (name,)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiny_w8_model_matches_jax(tiny, dtype):
    up, vp = tiny
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = jporting.build_sd_model(J_TINY_UNET, J_TINY_VAE, unet_params=up, vae_params=vp,
                                 dtype=jdt)
    jq_params = jax.tree.map(jnp.asarray, jq.quantize_tree(jm.unet_params, min_elems=1024))
    jmq = jporting.build_sd_model(J_TINY_UNET, J_TINY_VAE, unet_params=jq_params,
                                  vae_params=vp, dtype=jdt, weight_quant=True)
    usd = state_dict_from_jax(jax.tree.map(np.asarray, up))
    vsd = state_dict_from_jax(jax.tree.map(np.asarray, vp))
    tm = build_sd_model(TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, dtype=tdt, device="cpu",
                        unet_state=usd, vae_state=vsd)
    # As the JAX test does, quantise below the 65,536-element default
    # cutoff first; `weight_quant` keeps the w8 layers.
    tmq = build_sd_model(TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, dtype=tdt, device="cpu",
                         unet_state=usd, vae_state=vsd)
    tq.quantize_module_(tmq.unet, tdt, min_elems=1024)
    leaves = _w8_leaves(jq_params["params"])
    mods = {k: m for k, m in tmq.unet.named_modules() if isinstance(m, tq.W8Linear)}
    assert set(mods) == set(leaves) and len(mods) > 10
    for k, m in mods.items():
        q, scale = leaves[k]
        assert np.array_equal(m.q.numpy(), q), k
        assert np.array_equal(m.scale.numpy().view(np.uint32),
                              np.ascontiguousarray(scale).view(np.uint32)), k
    rng = np.random.default_rng(7)
    lat = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    ctx = (rng.standard_normal((2, 77, 64)) * 0.3).astype(np.float32)
    e = tm.unet_apply(torch.from_numpy(lat), 500, torch.from_numpy(ctx)).numpy()
    eq = tmq.unet_apply(torch.from_numpy(lat), 500, torch.from_numpy(ctx)).numpy()
    assert np.isfinite(eq).all()
    assert np.abs(e - eq).mean() / np.abs(e).mean() < 0.05
    want = np.asarray(jmq.unet_apply(jmq.unet_params, jnp.asarray(lat), jnp.float32(500),
                                     jnp.asarray(ctx)))
    if dtype == "float32":
        np.testing.assert_allclose(eq, want, atol=1e-4, rtol=1e-4)
    else:  # the bf16 bound of tests/test_torch_port_diffusion.py
        assert np.linalg.norm(eq - want) / np.linalg.norm(want) <= 3e-2


def test_default_min_elems_selects_as_jax_and_passes_through(tiny):
    """At the 65,536-element default the port quantises the layers whose
    kernels JAX's `quantize_tree` quantises; quantising the w8 model again
    keeps its q."""
    up, vp = tiny
    usd = state_dict_from_jax(jax.tree.map(np.asarray, up))
    m = build_sd_model(TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, device="cpu", unet_state=usd,
                       weight_quant=True)
    names = {k for k, x in m.unet.named_modules() if isinstance(x, tq.W8Linear)}
    assert names == set(_w8_leaves(jq.quantize_tree(jax.tree.map(np.asarray, up))["params"]))
    assert "up_blocks.0.resnets.0.conv1" in names and "conv_in" not in names
    qs = {k: x.q.clone() for k, x in m.unet.named_modules() if isinstance(x, tq.W8Linear)}
    tq.quantize_module_(m.unet, torch.float32)
    assert all(torch.equal(dict(m.unet.named_modules())[k].q, q) for k, q in qs.items())
