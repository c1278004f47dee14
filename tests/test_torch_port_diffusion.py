"""Port's diffusion stack (StereoDiffusion Fast path) vs the JAX package.

JAX and torch both on the CPU. The TINY UNet (4- and 9-channel) and VAE are
initialised once per file in flax; their weights go to the port through
`state_dict_from_jax`, the same numpy inputs go through both, and where JAX
draws random numbers (the per-frame noise chains, the stand-in text
encoder) its draws are fed to the port. Tolerances:

* UNet eps and VAE encode/decode in float32: atol = rtol = 1e-4 (the bound
  of tests/test_torch_unet_parity.py; measured 2-3e-6).
* bfloat16: relative L2 <= 3e-2 (measured 1.2-1.6%; the JAX package's own
  bf16 eps differs from its f32 eps by 1.4%): the two frameworks round to
  bf16 after other operations (conv and matmul accumulation, the norms).
* schedulers: 1e-6 absolute on O(1) values (the same float32 forms).
* backward warp, disocclusion mask and border prefill: bit-equal.
* warp_inpaint and the Fast node: atol 1e-4 on [0, 1] images (measured
  about 7e-6 and 1.4e-6): float32 sums in other orders through the loop.
* the 512 -> 64 bilinear mask resize (antialiased): 1e-6 on the resized
  values (measured 6e-8) and no mask bit flipped at the 0.1 threshold.
"""
import dataclasses
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from comfystereo_tpu.diffusion import porting as jporting
from comfystereo_tpu.diffusion import schedulers as jsched
from comfystereo_tpu.diffusion import sd_pipeline as jpipe
from comfystereo_tpu.diffusion.attention import AttentionMode as JMode
from comfystereo_tpu.diffusion.sd_unet import SD15_INPAINT_UNET_CONFIG as J_INPAINT
from comfystereo_tpu.diffusion.sd_unet import TINY_SD_UNET_CONFIG as J_TINY_UNET
from comfystereo_tpu.diffusion.sd_unet import SDUNet as JUNet
from comfystereo_tpu.diffusion.sd_vae import SD_VAE_CONFIG as J_VAE
from comfystereo_tpu.diffusion.sd_vae import TINY_SD_VAE_CONFIG as J_TINY_VAE
from comfystereo_tpu.diffusion.sd_vae import SDVAE as JVAE
from comfystereo_tpu.nodes import stereodiffusion as jnode
from comfystereo_tpu.utils import fixtures
from comfystereo_tpu_torch.diffusion import (SD15_INPAINT_UNET_CONFIG, SD_VAE_CONFIG,
                                             TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG,
                                             AttentionMode, HashTextEncoder, SDUNet, SDVAE,
                                             build_sd_model, state_dict_from_jax)
from comfystereo_tpu_torch.diffusion import schedulers as tsched
from comfystereo_tpu_torch.diffusion import sd_pipeline as tpipe
from comfystereo_tpu_torch.kernels import flash_attention as tfa
from comfystereo_tpu_torch.nodes import stereodiffusion as tnode

PROMPTS = ("", "a cat")


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _rel_l2(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_params(in_channels):
    """flax params of the TINY UNet with `in_channels` and the TINY VAE
    (jitted init: the eager one takes tens of seconds)."""
    cfg = dataclasses.replace(J_TINY_UNET, in_channels=in_channels)
    up = jax.jit(JUNet(cfg).init)(jax.random.PRNGKey(in_channels), jnp.zeros((1, in_channels, 8, 8)),
                                  jnp.zeros(()), jnp.zeros((1, 77, cfg.cross_attention_dim)))
    vp = jax.jit(JVAE(J_TINY_VAE).init)(jax.random.PRNGKey(1), jnp.zeros((1, 3, 32, 32)))
    return cfg, up, vp


@pytest.fixture(scope="module")
def models():
    """{in_channels: (jax bundle, port bundle)} in float32, same weights,
    the port conditioned on the JAX encoder's embeddings; plus the bf16
    bundles of the 4-channel model under key ('bf16', 4)."""
    out = {}
    for c in (4, 9):
        cfg, up, vp = _jax_params(c)
        jm = jporting.build_sd_model(cfg, J_TINY_VAE, unet_params=up, vae_params=vp)
        jm.sample_size = 64
        emb = {p: torch.from_numpy(np.array(jm.text_encode(p))) for p in PROMPTS}
        usd = state_dict_from_jax(jax.tree.map(np.asarray, up))
        vsd = state_dict_from_jax(jax.tree.map(np.asarray, vp))
        tcfg = dataclasses.replace(TINY_SD_UNET_CONFIG, in_channels=c)
        tm = build_sd_model(tcfg, TINY_SD_VAE_CONFIG, device="cpu", unet_state=usd,
                            vae_state=vsd, text_encode=emb.__getitem__)
        tm.sample_size = 64
        out[c] = (jm, tm)
        if c == 4:
            out[("bf16", 4)] = (
                jporting.build_sd_model(cfg, J_TINY_VAE, unet_params=up, vae_params=vp,
                                        dtype=jnp.bfloat16),
                build_sd_model(tcfg, TINY_SD_VAE_CONFIG, device="cpu", unet_state=usd,
                               vae_state=vsd, dtype=torch.bfloat16,
                               text_encode=emb.__getitem__))
    return out


def _jax_frame_noise(seeds, shape, n):
    """The JAX package's per-frame noise chains (`_inpaint_scan.frame_noise`:
    one split for the init noise, one per step) as torch tensors: init
    [B, ...] and steps [n, B, ...]."""
    inits, steps = [], []
    for s in seeds:
        key = jax.random.PRNGKey(int(s))
        key, sub = jax.random.split(key)
        inits.append(np.asarray(jax.random.normal(sub, shape)))
        chain = []
        for _ in range(n):
            key, sub = jax.random.split(key)
            chain.append(np.asarray(jax.random.normal(sub, shape)))
        steps.append(np.stack(chain) if n else np.zeros((0,) + shape, np.float32))
    return torch.from_numpy(np.stack(inits)), torch.from_numpy(np.stack(steps, 1))


def _frames(h, w, n=2):
    img = np.stack([np.roll(fixtures.create_test_image(h, w), 5 * i, 1) for i in range(n)])
    dep = np.stack([np.roll(fixtures.create_depth_map(h, w), 5 * i, 1) for i in range(n)])
    return img.astype(np.float32) / 255.0, dep.astype(np.float32) / 255.0


# --- models -----------------------------------------------------------------

@pytest.mark.parametrize("t,stereo", [(1.0, None), (501.0, None), (999.0, None),
                                      (501.0, "uni"), (501.0, "bi")])
def test_unet_matches_flax_f32(models, t, stereo):
    jm, tm = models[4]
    b = 4 if stereo else 2  # BN attention under CFG: [u_L, u_R, c_L, c_R]
    rng = np.random.default_rng(int(t))
    lat = rng.standard_normal((b, 4, 16, 16)).astype(np.float32)
    ctx = rng.standard_normal((b, 77, 64)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if stereo:
        kw_j = dict(mode=JMode(stereo=True, direction=stereo), stereo_active=True)
        kw_t = dict(mode=AttentionMode(stereo=True, direction=stereo), stereo_active=True)
    want = jm.unet_apply(jm.unet_params, jnp.asarray(lat), jnp.float32(t), jnp.asarray(ctx),
                         **kw_j)
    got = tm.unet_apply(torch.from_numpy(lat), t, torch.from_numpy(ctx), **kw_t)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, 4, 16, 16)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


def test_vae_encode_decode_match_flax_f32(models):
    jm, tm = models[4]
    rng = np.random.default_rng(8)
    img = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    z = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    np.testing.assert_allclose(_np(tm.vae_encode(torch.from_numpy(img))),
                               _np(jm.vae_encode(jm.vae_params, jnp.asarray(img))),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(tm.vae_decode(torch.from_numpy(z))),
                               _np(jm.vae_decode(jm.vae_params, jnp.asarray(z))),
                               atol=1e-4, rtol=1e-4)


def test_unet_and_vae_bf16_match_flax(models):
    jm, tm = models[("bf16", 4)]
    assert next(tm.unet.parameters()).dtype == torch.bfloat16
    rng = np.random.default_rng(9)
    lat = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    z = rng.standard_normal((1, 4, 16, 16)).astype(np.float32)
    for t in (1.0, 501.0):
        got = tm.unet_apply(torch.from_numpy(lat), t, torch.from_numpy(ctx))
        assert got.dtype == torch.float32  # the boundary returns f32
        want = jm.unet_apply(jm.unet_params, jnp.asarray(lat), jnp.float32(t),
                             jnp.asarray(ctx))
        assert _rel_l2(got, want) <= 3e-2
    got = tm.vae_decode(torch.from_numpy(z))
    want = jm.vae_decode(jm.vae_params, jnp.asarray(z))
    assert _rel_l2(got, want) <= 3e-2


@pytest.mark.parametrize("which", ["unet", "vae"])
def test_state_dict_from_jax_keys_and_shapes_at_full_width(which):
    """The flax tree of the full SD 1.5-inpainting UNet / SD VAE, carried
    across by `state_dict_from_jax`, has the port's state_dict keys and
    shapes. Shapes come from `jax.eval_shape` and zero-stride numpy arrays;
    the port's modules are built on the meta device: nothing is allocated."""
    if which == "unet":
        init = lambda: JUNet(J_INPAINT).init(  # noqa: E731
            jax.random.PRNGKey(0), jnp.zeros((1, 9, 8, 8)), jnp.zeros(()),
            jnp.zeros((1, 77, 768)))
        with torch.device("meta"):
            module = SDUNet(SD15_INPAINT_UNET_CONFIG)
    else:
        init = lambda: JVAE(J_VAE).init(jax.random.PRNGKey(0),  # noqa: E731
                                        jnp.zeros((1, 3, 32, 32)))
        with torch.device("meta"):
            module = SDVAE(SD_VAE_CONFIG)
    shapes = jax.eval_shape(init)
    tree = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    sd = state_dict_from_jax(tree)
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    n = sum(int(np.prod(s)) for s in want.values())
    assert n > (8e8 if which == "unet" else 8e7)


def test_build_sd_model_seeded_and_cast():
    a = build_sd_model(TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, seed=3, device="cpu",
                       dtype=torch.bfloat16)
    b = build_sd_model(TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, seed=3, device="cpu",
                       dtype=torch.bfloat16)
    for m in ("unet", "vae"):
        sa, sb = getattr(a, m).state_dict(), getattr(b, m).state_dict()
        assert all(v.dtype == torch.bfloat16 and torch.equal(v, sb[k]) for k, v in sa.items())
    lat = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(0))
    eps = a.unet_apply(lat, 10, torch.cat([a.text_encode("")] * 2))
    assert eps.dtype == torch.float32 and bool(torch.isfinite(eps).all())


def test_hash_text_encoder_is_deterministic():
    enc = HashTextEncoder(dim=32)
    a, b = enc("a cat"), HashTextEncoder(dim=32)("a cat")
    assert tuple(a.shape) == (1, 77, 32) and torch.equal(a, b)
    assert not torch.equal(a, enc("a dog"))
    assert 0.01 < float(a.std()) < 0.03


# --- schedulers ---------------------------------------------------------------

def test_schedules_match_jax():
    for n in (1, 6, 20, 50):
        p_j, p_t = jsched.make_pndm(n), tsched.make_pndm(n)
        np.testing.assert_array_equal(p_t.timesteps, p_j.timesteps)
        np.testing.assert_array_equal(p_t.alphas_cumprod, p_j.alphas_cumprod)
        for s in (0.1, 0.6, 0.75, 1.0):
            np.testing.assert_array_equal(tsched.pndm_skip_timesteps(p_t, s),
                                          jsched.pndm_skip_timesteps(p_j, s))
        np.testing.assert_array_equal(tsched.make_ddim(n).timesteps,
                                      jsched.make_ddim(n).timesteps)
        e_j, e_t = jsched.make_euler(n), tsched.make_euler(n)
        np.testing.assert_array_equal(e_t.timesteps, e_j.timesteps)
        np.testing.assert_array_equal(e_t.sigmas, e_j.sigmas)
    assert len(tsched.pndm_skip_timesteps(tsched.make_pndm(20), 0.6)) == 13


def test_pndm_scan_step_matches_jax():
    """i = 0..5 through the strength-truncated node schedule, both forms of
    the PLMS state, with the same eps draws.

    The stateful form runs JAX op by op, so the port gives its bits. The
    scan form's counter branches run under `lax.switch`, which XLA compiles:
    it contracts `3 * e3 - e2` and the like into FMAs and divides by 12 and
    24 as products with the rounded reciprocals, so from i = 2 on JAX
    leaves a float32 evaluation of its own expressions by a few ulps of the
    O(1) values (7.2e-7 at most in this test). The port is held to that within 1e-6
    and bit for bit to the numpy float32 evaluation
    (`test_torch_port_rounding.py::test_pndm_scan_step_bit_equal_to_numpy_float32`)."""
    sj, st = jsched.make_pndm(20), tsched.make_pndm(20)
    ts = tsched.pndm_skip_timesteps(st, 0.6)
    rng = np.random.default_rng(0)
    shape = (2, 4, 8, 8)
    lat = rng.standard_normal(shape).astype(np.float32)
    j = (jnp.asarray(lat), jnp.zeros((4,) + shape), jnp.zeros(shape))
    t = (torch.from_numpy(lat), torch.zeros((4,) + shape), torch.zeros(shape))
    state = tsched.PNDMState()
    state_j = jsched.PNDMState()
    lat_s, lat_sj = torch.from_numpy(lat), jnp.asarray(lat)
    for i in range(6):
        eps = rng.standard_normal(shape).astype(np.float32)
        sample_j, ets_j, cur_j = jsched.pndm_scan_step(sj, i, int(ts[i]), j[1], j[2],
                                                      jnp.asarray(eps), j[0])
        sample_t, ets_t, cur_t = tsched.pndm_scan_step(st, i, int(ts[i]), t[1], t[2],
                                                      torch.from_numpy(eps), t[0])
        for a, b in ((sample_t, sample_j), (ets_t, ets_j), (cur_t, cur_j)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)
        j, t = (sample_j, ets_j, cur_j), (sample_t, ets_t, cur_t)
        lat_s, state = tsched.pndm_step(st, state, torch.from_numpy(eps), int(ts[i]), lat_s)
        lat_sj, state_j = jsched.pndm_step(sj, state_j, jnp.asarray(eps), int(ts[i]), lat_sj)
        np.testing.assert_array_equal(_np(lat_s), _np(lat_sj))


def test_scheduler_steps_match_jax():
    rng = np.random.default_rng(1)
    x, e = (rng.standard_normal((2, 4, 8, 8)).astype(np.float32) for _ in range(2))
    xt, et, xj, ej = torch.from_numpy(x), torch.from_numpy(e), jnp.asarray(x), jnp.asarray(e)
    dj, dt = jsched.make_ddim(10), tsched.make_ddim(10)
    uj, ut = jsched.make_euler(10), tsched.make_euler(10)
    for tt in (1, 401, 901):
        pairs = [
            (tsched.ddim_step(dt, et, tt, xt), jsched.ddim_step(dj, ej, tt, xj)),
            (tsched.ddim_next_step(dt, et, tt, xt), jsched.ddim_next_step(dj, ej, tt, xj)),
            (tsched.add_noise(dt, xt, et, tt), jsched.add_noise(dj, xj, ej, tt)),
            (tsched.add_noise(dt, xt, et, -1), jsched.add_noise(dj, xj, ej, -1)),
            (tsched.scale_model_input(ut, xt, tt), jsched.scale_model_input(uj, xj, tt)),
            (tsched.euler_step(ut, et, tt, xt), jsched.euler_step(uj, ej, tt, xj)),
            (tsched.scheduler_step(ut, et, tt, xt), jsched.scheduler_step(uj, ej, tt, xj)),
            (tsched.to_sigma_space(ut, xt, tt), jsched.to_sigma_space(uj, xj, tt)),
        ]
        for a, b in pairs:
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)


# --- warp, prefill, resize --------------------------------------------------

@pytest.mark.parametrize("divergence", [2.5, 5.0, 12.0])
def test_backward_warp_and_border_prefill_bit_equal(divergence):
    img, dep = _frames(48, 80)
    dep[1] = np.random.default_rng(0).random(dep[1].shape, dtype=np.float32)
    jw, jm = jpipe.backward_warp_right(jnp.asarray(img), jnp.asarray(dep), divergence)
    tw, tm = tpipe.backward_warp_right(torch.from_numpy(img), torch.from_numpy(dep),
                                       divergence)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert 0 < float(tm.float().mean()) < 1
    jp = jpipe.border_prefill(jw, jm)
    tp = tpipe.border_prefill(tw, tm)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_mask_resize_512_to_64_matches_jax():
    """The node-size disocclusion mask at 512x512 resized to the 64x64
    latent grid: F.interpolate(antialias=True) against jax.image.resize."""
    img, dep = _frames(512, 512, n=1)
    _, mask = tpipe.backward_warp_right(torch.from_numpy(img), torch.from_numpy(dep), 5.0)
    m = mask[:, None].float()
    got = tpipe.resize_bilinear(m, 64, 64).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(m.numpy()), (1, 1, 64, 64), "bilinear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got > 0.1, want > 0.1)
    assert (want > 0.1).any()


@pytest.mark.parametrize("hw", [(80, 96, 64, 64), (64, 64, 80, 96)])
def test_node_resize_matches_jax(hw):
    h, w, oh, ow = hw
    x = np.random.default_rng(h).random((2, h, w, 3), dtype=np.float32)
    got = tnode._resize_to(torch.from_numpy(x), oh, ow).numpy()
    np.testing.assert_allclose(got, jnode._resize_to(x, oh, ow), rtol=0, atol=1e-5)


# --- the Fast path -------------------------------------------------------------

@pytest.mark.parametrize("channels", [9, 4])
def test_warp_inpaint_matches_jax(models, channels):
    """9 channels: the SD-inpainting concat path (init noise only); 4: the
    masked-latent path (init and per-step noise). JAX's noise is fed in."""
    jm, tm = models[channels]
    img, dep = _frames(64, 64)
    steps, strength, seeds = 6, 0.75, np.array([7, 8], np.uint64)
    n = len(jsched.pndm_skip_timesteps(jsched.make_pndm(steps), strength))
    init, chain = _jax_frame_noise(seeds, (4, 32, 32), n)
    want = jpipe.warp_inpaint(jm, jnp.asarray(img), jnp.asarray(dep), "a cat",
                              divergence=8.0, num_inference_steps=steps, strength=strength,
                              guidance_scale=3.0, seed=seeds)
    got = tpipe.warp_inpaint(tm, torch.from_numpy(img), torch.from_numpy(dep), "a cat",
                             divergence=8.0, num_inference_steps=steps, strength=strength,
                             guidance_scale=3.0,
                             noise=(init, None if channels == 9 else chain))
    assert torch.equal(got.left, torch.from_numpy(img))
    np.testing.assert_allclose(_np(got.right), _np(want.right), rtol=0, atol=1e-4)
    assert float((got.right - torch.from_numpy(img)).abs().max()) > 0


def test_stereodiffusion_node_fast_matches_jax(models, monkeypatch):
    """The Fast node on the 9-channel TINY bundle with sample size 64, input
    80x96 (resized to 64 and back), node defaults otherwise; the port's
    per-frame noise is replaced by JAX's draws for the same seeds."""
    jm, tm = models[9]
    img, dep = _frames(80, 96)

    def jax_noise(seeds, shape, n_steps, device):
        init, chain = _jax_frame_noise(seeds, tuple(shape), n_steps)
        return init.to(device), (chain.to(device) if n_steps else None)

    monkeypatch.setattr(tpipe, "frame_noise", jax_noise)
    kw = dict(scale_factor=5.0, num_inference_steps=6, denoise_strength=0.6, seed=5,
              prompt="a cat")
    want = jnode.StereoDiffusionNode().generate_stereo(img, dep, model=jm, **kw)
    before = tfa.LAUNCHES
    got = tnode.StereoDiffusionNode().generate_stereo(img, dep, model=tm, device="cpu", **kw)
    assert tfa.LAUNCHES == before  # the CPU never launches the kernel
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == torch.float32
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4)


def test_node_raises_for_unported_modes(monkeypatch, capsys):
    """Model resolution is ported (the NotImplementedError it once raised is
    gone): a model_id on no disk, offline and without a hub package, falls
    back loudly to the toy model on the CPU, which runs; the node's contract
    attributes are JAX's."""
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    monkeypatch.setenv("COMFYSTEREO_OFFLINE", "1")
    img, dep = _frames(48, 40, n=1)
    pair, left, right = tnode.StereoDiffusionNode().generate_stereo(
        img, dep, device="cpu", pipeline_mode="Standard (DDIM)", model_id="org/not-on-disk",
        num_inference_steps=2, null_text_optimization=False)
    out = capsys.readouterr().out
    assert "FALLING BACK TO THE OFFLINE TOY MODEL" in out and "org/not-on-disk" in out
    assert "huggingface_hub missing" in out
    assert tuple(pair.shape) == (1, 48, 80, 3) and bool(torch.isfinite(pair).all())
    assert tnode._default_model(torch.device("cpu")).sample_size == 64
    assert tnode.StereoDiffusionNode.INPUT_TYPES() == jnode.StereoDiffusionNode.INPUT_TYPES()
    for attr in ("RETURN_TYPES", "RETURN_NAMES", "FUNCTION", "CATEGORY"):
        assert getattr(tnode.StereoDiffusionNode, attr) == getattr(
            jnode.StereoDiffusionNode, attr)
