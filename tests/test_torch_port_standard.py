"""Port's StereoDiffusion Standard (DDIM) mode vs the JAX package.

JAX and torch both on the CPU, same numpy inputs. The toy model (flax
`LatentUNet` + `SimpleVAE`, 32x32 images) and the TINY SD UNet + VAE are
initialised once per file with a jitted `init`; their weights go to the port
through `toy_state_dicts_from_jax` and `state_dict_from_jax`. Where JAX
draws random numbers (the stand-in text encoder, the deblur noise) its draws
are fed to the port. Tolerances:

* scatter-min/max and the latent stereo shift: bit-equal.
* the 512 -> 64 bilinear depth resize (antialiased): 1e-6.
* toy eps and VAE, the step helpers, the DDIM inversion trajectory and the
  per-timestep latents: atol 1e-5 (float32 sums in other orders; measured
  about 1e-6).
* the optimised null-text embedding u: the difference within 1e-2 of the
  optimisation's own update (relative L2), and within 2 lr = 2e-2 on every
  component. Adam's first steps are lr * g / (|g| + 1e-8), about
  lr * sign(g): where a gradient component is within about 1e-8 of 0,
  float32 differences in g move the step by up to 2 lr. Measured on the toy
  (4 timesteps, 2 inner steps): relative 2e-4 to 9e-4, at most 5 of 4928
  components off by more than 1e-4, the largest by 1.5e-3.
* images in [0, 1]: 1e-4 without null-text optimisation, 1e-3 with it
  (measured about 5e-6 and 2e-5).
"""
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from comfystereo_tpu.diffusion import helpers as jhelpers
from comfystereo_tpu.diffusion import inversion as jinv
from comfystereo_tpu.diffusion import models as jmodels
from comfystereo_tpu.diffusion import porting as jporting
from comfystereo_tpu.diffusion import schedulers as jsched
from comfystereo_tpu.diffusion import sd_pipeline as jpipe
from comfystereo_tpu.diffusion import stereo_latent as jlat
from comfystereo_tpu.diffusion.adapters import detect_model_type as j_detect
from comfystereo_tpu.diffusion.sd_unet import TINY_SD_UNET_CONFIG as J_TINY_UNET
from comfystereo_tpu.diffusion.sd_unet import SDUNet as JUNet
from comfystereo_tpu.diffusion.sd_vae import TINY_SD_VAE_CONFIG as J_TINY_VAE
from comfystereo_tpu.diffusion.sd_vae import SDVAE as JVAE
from comfystereo_tpu.nodes import stereodiffusion as jnode
from comfystereo_tpu.ops import fills as jfills
from comfystereo_tpu.utils import fixtures
from comfystereo_tpu_torch.diffusion import (SUPPORTED_MODEL_TYPES, TINY_SD_UNET_CONFIG,
                                             TINY_SD_VAE_CONFIG, AttentionMode, LatentUNet,
                                             SimpleVAE, UNetConfig, build_sd_model,
                                             detect_model_type, make_toy_model,
                                             state_dict_from_jax, toy_state_dicts_from_jax)
from comfystereo_tpu_torch.diffusion import helpers as thelpers
from comfystereo_tpu_torch.diffusion import inversion as tinv
from comfystereo_tpu_torch.diffusion import schedulers as tsched
from comfystereo_tpu_torch.diffusion import sd_pipeline as tpipe
from comfystereo_tpu_torch.diffusion import stereo_latent as tlat
from comfystereo_tpu_torch.kernels import flash_attention as tfa
from comfystereo_tpu_torch.nodes import stereodiffusion as tnode
from comfystereo_tpu_torch.ops import fills as tfills

PROMPTS = ("", "p")
SMALL_1024 = dict(base_channels=8, channel_mults=(1,), num_heads=2, context_dim=1024,
                  time_dim=16)


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def _close_u(got, want, u0):
    """Null-text embeddings: the difference within 1e-2 of the optimisation's
    own update (relative L2) and within 2 lr = 2e-2 on every component
    (Adam's sign-like first steps)."""
    got, want, u0 = _np(got), _np(want), _np(u0)
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want - u0)
    assert float(np.abs(got - want).max()) <= 2e-2


def _text_encoders(dim):
    """A fixed stand-in text encoder for both packages: seeded 0.02 * normal
    [1, 77, dim] embeddings (the JAX stand-in hashes with Python's per-process
    `hash`, so its draws change from run to run)."""
    rng = np.random.default_rng(dim)
    emb = {p: (0.02 * rng.standard_normal((1, 77, dim))).astype(np.float32) for p in PROMPTS}
    return (lambda p: jnp.asarray(emb[p])), (lambda p: torch.from_numpy(emb[p]))


def _toy_pair(cfg=jmodels.UNetConfig(), image_size=32):
    """(JAX toy bundle, port toy bundle) with the same weights: the JAX
    bundle as `make_toy_model` wires it, with a jitted init."""
    unet, vae = jmodels.LatentUNet(cfg), jmodels.SimpleVAE(latent_channels=cfg.in_channels)
    up = jax.jit(unet.init)(jax.random.PRNGKey(0), jnp.zeros((1, cfg.in_channels, 4, 4)),
                            jnp.zeros(()), jnp.zeros((1, 77, cfg.context_dim)))
    vp = jax.jit(vae.init)(jax.random.PRNGKey(1), jnp.zeros((1, 3, 32, 32)))

    @functools.partial(jax.jit, static_argnames=("mode",))
    def unet_jit(params, latents, t, context, stereo_active, mode):
        return unet.apply(params, latents, t, context, mode=mode, stereo_active=stereo_active)

    def unet_apply(params, latents, t, context, mode=jmodels.AttentionMode(),
                   stereo_active=False):
        return unet_jit(params, latents, t, context, stereo_active, mode)

    j_text, t_text = _text_encoders(cfg.context_dim)
    jm = jmodels.DiffusionModel(
        unet_apply=unet_apply, unet_params=up,
        vae_encode=jax.jit(lambda p, x: vae.apply(p, x, method=jmodels.SimpleVAE.encode)),
        vae_decode=jax.jit(lambda p, z: vae.apply(p, z, method=jmodels.SimpleVAE.decode)),
        vae_params=vp, text_encode=j_text,
        latent_channels=cfg.in_channels, context_dim=cfg.context_dim, sample_size=image_size)
    usd, vsd = toy_state_dicts_from_jax(jax.tree.map(np.asarray, up),
                                        jax.tree.map(np.asarray, vp))
    tm = make_toy_model(image_size=image_size, cfg=UNetConfig(**dataclasses.asdict(cfg)),
                        device="cpu", unet_state=usd, vae_state=vsd, text_encode=t_text)
    return jm, tm


@pytest.fixture(scope="module")
def toy():
    """The default toy at sample size 64 (8x8 latents: wide enough for the
    latent shift to move columns)."""
    return _toy_pair(image_size=64)


@pytest.fixture(scope="module")
def toy1024():
    """A one-level toy with a 1024-d context: an SD2-family model to
    `detect_model_type`, so "auto" picks Euler."""
    return _toy_pair(jmodels.UNetConfig(**SMALL_1024))


@pytest.fixture(scope="module")
def tiny():
    """The TINY SD UNet and VAE (float32, sample size 64: 32x32 latents)."""
    up = jax.jit(JUNet(J_TINY_UNET).init)(
        jax.random.PRNGKey(4), jnp.zeros((1, 4, 8, 8)), jnp.zeros(()),
        jnp.zeros((1, 77, J_TINY_UNET.cross_attention_dim)))
    vp = jax.jit(JVAE(J_TINY_VAE).init)(jax.random.PRNGKey(1), jnp.zeros((1, 3, 32, 32)))
    j_text, t_text = _text_encoders(J_TINY_UNET.cross_attention_dim)
    jm = jporting.build_sd_model(J_TINY_UNET, J_TINY_VAE, unet_params=up, vae_params=vp,
                                 text_encode=j_text)
    jm.sample_size = 64
    tm = build_sd_model(TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, device="cpu",
                        unet_state=state_dict_from_jax(jax.tree.map(np.asarray, up)),
                        vae_state=state_dict_from_jax(jax.tree.map(np.asarray, vp)),
                        text_encode=t_text)
    tm.sample_size = 64
    return jm, tm


def _jax_deblur_noise(seed, shape):
    """text2stereo's deblur draw in the JAX package: PRNGKey(seed), split
    once, one normal draw."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    return torch.from_numpy(np.asarray(jax.random.normal(sub, shape)))


def _image_depth(size, seed=1):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (1, 3, size, size)).astype(np.float32)
    depth = rng.uniform(0, 1, (1, size, size)).astype(np.float32)
    return img, depth


class _CountGradCalls:
    """Wraps a bundle's unet_apply and counts the calls whose context needs
    a gradient (the null-text loop's inner iterations)."""

    def __init__(self, model):
        self.model, self.apply, self.n = model, model.unet_apply, 0

    def __enter__(self):
        def counted(latents, t, context, **kw):
            self.n += bool(context.requires_grad)
            return self.apply(latents, t, context, **kw)
        self.model.unet_apply = counted
        return self

    def __exit__(self, *exc):
        self.model.unet_apply = self.apply


# --- scatter and the latent shift ------------------------------------------------

@pytest.mark.parametrize("op", ["min", "max"])
def test_scatter_min_max_w_bit_equal(op):
    """Ties (several lanes to one column), invalid lanes and columns out of
    range (clipped, then dumped when invalid); int32 as in the shift."""
    rng = np.random.default_rng(3)
    w = 24
    dest = rng.integers(-4, w + 4, (2, 5, w)).astype(np.int32)
    values = rng.integers(0, 6, (2, 5, w)).astype(np.int32)  # many ties
    valid = (rng.random((2, 5, w)) < 0.8) & (dest >= 0) & (dest < w)
    valid[0, 0] = True  # clipped columns on a valid lane
    init = 2 ** 30 if op == "min" else -1
    jfn = jfills.scatter_min_w if op == "min" else jfills.scatter_max_w
    tfn = tfills.scatter_min_w if op == "min" else tfills.scatter_max_w
    want = np.asarray(jfn(jnp.asarray(dest), jnp.asarray(values), jnp.asarray(valid), w,
                          jnp.int32(init)))
    got = tfn(torch.from_numpy(dest), torch.from_numpy(values), torch.from_numpy(valid), w,
              init)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == init).any() and (want != init).any()


@pytest.mark.parametrize("scale", [8.0, -6.0, 5.0])
@pytest.mark.parametrize("shift_both", [False, True])
def test_stereo_shift_bit_equal(scale, shift_both):
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(2, 4, 12, 24)).astype(np.float32)
    depth = rng.uniform(0, 1, (2, 12, 24)).astype(np.float32)
    depth[1] = 0.25  # flat depth: normalised to 0
    want = jlat.stereo_shift(jnp.asarray(imgs), jnp.asarray(depth), scale_factor=scale,
                             shift_both=shift_both)
    got = tlat.stereo_shift(torch.from_numpy(imgs), torch.from_numpy(depth), scale_factor=scale,
                            shift_both=shift_both)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not shift_both:
        np.testing.assert_array_equal(got[:2].numpy(), imgs)


@pytest.mark.parametrize("scale", [8.0, -30.0])
def test_stereo_shift_with_mask_bit_equal(scale):
    rng = np.random.default_rng(2)
    lat = rng.normal(size=(1, 4, 16, 16)).astype(np.float32)
    depth = rng.uniform(0, 3, (1, 16, 16)).astype(np.float32)
    jr, jh = jlat.stereo_shift_with_mask(jnp.asarray(lat), jnp.asarray(depth), scale)
    tr, th = tlat.stereo_shift_with_mask(torch.from_numpy(lat), torch.from_numpy(depth), scale)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert 0 < float(th.float().mean()) < 1


def test_depth_resize_512_to_64_matches_jax():
    """The node-size depth map to the 64x64 latent grid (8x, antialiased):
    F.interpolate(antialias=True) against jax.image.resize."""
    depth = fixtures.create_depth_map(512, 512).astype(np.float32)[None] / 255.0
    want = np.asarray(jax.image.resize(jnp.asarray(depth), (1, 64, 64), "bilinear"))
    got = tpipe.resize_bilinear(torch.from_numpy(depth)[:, None], 64, 64)[:, 0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# --- the toy model -----------------------------------------------------------------

@pytest.mark.parametrize("t,stereo", [(1.0, None), (501.0, None), (981.0, "uni"),
                                      (501.0, "bi")])
def test_toy_unet_matches_flax(toy, t, stereo):
    jm, tm = toy
    b = 4 if stereo else 2
    rng = np.random.default_rng(int(t))
    lat = rng.standard_normal((b, 4, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((b, 77, 64)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if stereo:
        kw_j = dict(mode=jmodels.AttentionMode(stereo=True, direction=stereo),
                    stereo_active=True)
        kw_t = dict(mode=AttentionMode(stereo=True, direction=stereo), stereo_active=True)
    want = jm.unet_apply(jm.unet_params, jnp.asarray(lat), jnp.float32(t), jnp.asarray(ctx),
                         **kw_j)
    got = tm.unet_apply(torch.from_numpy(lat), t, torch.from_numpy(ctx), **kw_t)
    assert tuple(got.shape) == (b, 4, 4, 4)
    _close(got, want, 1e-5)


def test_toy_vae_matches_flax(toy):
    jm, tm = toy
    rng = np.random.default_rng(8)
    img = rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    z = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    _close(tm.vae_encode(torch.from_numpy(img)), jm.vae_encode(jm.vae_params, jnp.asarray(img)),
           1e-5)
    got = tm.vae_decode(torch.from_numpy(z))
    assert tuple(got.shape) == (2, 3, 32, 32)
    _close(got, jm.vae_decode(jm.vae_params, jnp.asarray(z)), 1e-5)


def test_toy_state_dicts_cover_the_modules():
    """The carried-over keys and shapes are the port's modules' own, for the
    default toy and for the one-level 1024-d toy."""
    for kw in ({}, SMALL_1024):
        cfg = jmodels.UNetConfig(**kw)
        unet_shapes = jax.eval_shape(lambda c=cfg: jmodels.LatentUNet(c).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 4)), jnp.zeros(()),
            jnp.zeros((1, 77, c.context_dim))))
        vae_shapes = jax.eval_shape(lambda: jmodels.SimpleVAE().init(
            jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32))))
        usd, vsd = toy_state_dicts_from_jax(
            *(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), t)
              for t in (unet_shapes, vae_shapes)))
        for sd, module in ((usd, LatentUNet(UNetConfig(**kw))), (vsd, SimpleVAE())):
            assert {k: tuple(v.shape) for k, v in sd.items()} == \
                {k: tuple(v.shape) for k, v in module.state_dict().items()}


def test_make_toy_model_seeded():
    a = make_toy_model(seed=3, device="cpu")
    b = make_toy_model(seed=3, device="cpu")
    for m in ("unet", "vae"):
        sa, sb = getattr(a, m).state_dict(), getattr(b, m).state_dict()
        assert all(torch.equal(v, sb[k]) for k, v in sa.items())
    eps = a.unet_apply(torch.zeros(2, 4, 4, 4), 10, torch.cat([a.text_encode("")] * 2))
    assert tuple(eps.shape) == (2, 4, 4, 4) and bool(torch.isfinite(eps).all())
    assert a.sample_size == 32 and a.context_dim == 64


# --- helpers and adapters ----------------------------------------------------------

def test_diffusion_steps_match_jax(toy):
    jm, tm = toy
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    ctx = np.concatenate([np.repeat(np.asarray(jm.text_encode(p)), 2, 0) for p in PROMPTS])
    js, ts = jsched.make_ddim(10), tsched.make_ddim(10)
    t = int(ts.timesteps[0])
    mode_j = jmodels.AttentionMode(stereo=True, direction="bi")
    mode_t = AttentionMode(stereo=True, direction="bi")
    want = jhelpers.diffusion_step(jm, js, jnp.asarray(lat), jnp.asarray(ctx), jnp.int32(t), 7.5,
                                   mode=mode_j, stereo_active=True)
    got = thelpers.diffusion_step(tm, ts, torch.from_numpy(lat), torch.from_numpy(ctx), t, 7.5,
                                  mode=mode_t, stereo_active=True)
    _close(got, want, 1e-5)
    want = jhelpers.diffusion_step_no_cfg(jm, js, jnp.asarray(lat), jnp.asarray(ctx[:2]),
                                          jnp.int32(t), controller=lambda x: x * 2)
    got = thelpers.diffusion_step_no_cfg(tm, ts, torch.from_numpy(lat),
                                         torch.from_numpy(ctx[:2]), t,
                                         controller=lambda x: x * 2)
    _close(got, want, 1e-5)


def test_init_latent():
    gen = torch.Generator().manual_seed(0)
    lat, lats = thelpers.init_latent(None, gen, 4, 64, 64, 3)
    assert tuple(lat.shape) == (1, 4, 8, 8) and tuple(lats.shape) == (3, 4, 8, 8)
    lat2, lats2 = thelpers.init_latent(lat, None, 4, 64, 64, 2)
    assert lat2 is lat and torch.equal(lats2[1], lat[0])
    again = thelpers.init_latent(None, torch.Generator().manual_seed(0), 4, 64, 64, 1)[0]
    assert torch.equal(again, lat)


def test_detect_model_type_matches_jax(toy, toy1024):
    class SD2Config:
        context_dim = 1024

    class SDXLThing:
        pass

    class FluxConfig:
        pass

    SDXLThing.__name__ = "SDXLModelConfig"
    cases = [SD2Config(), SDXLThing(), FluxConfig(), object(), None]
    assert [detect_model_type(c) for c in cases] == [j_detect(c) for c in cases] == \
        ["SD2", "SDXL", "FLUX", "SD1", "SD1"]
    assert detect_model_type(toy[1]) == j_detect(toy[0]) == "SD1"
    assert detect_model_type(toy1024[1]) == j_detect(toy1024[0]) == "SD2"
    # The port runs SDXL too (Fast mode; Standard mode raises for it).
    assert SUPPORTED_MODEL_TYPES == ["SD1", "SD2", "SDXL"]


# --- inversion ---------------------------------------------------------------------

def test_ddim_invert_loop_matches_jax(toy):
    jm, tm = toy
    img, _ = _image_depth(32)
    js, ts = jsched.make_ddim(5), tsched.make_ddim(5)
    cond_j = jm.text_encode("p")
    lat_j = jinv.image_to_latent(jm, jnp.asarray(img))
    lat_t = tinv.image_to_latent(tm, torch.from_numpy(img))
    _close(lat_t, lat_j, 1e-5)
    want = jinv.ddim_invert_loop(jm, js, lat_j, cond_j)
    got = tinv.ddim_invert_loop(tm, ts, lat_t, tm.text_encode("p"))
    assert tuple(got.shape) == (6, 1, 4, 4, 4)
    _close(got, want, 1e-5)


def _null_text_case(jm, tm, stop):
    """One null-text timestep (i = 3 of 6) on the toy from the same inputs
    in both packages; stop=None puts the stop threshold just above the
    first iteration's loss, so exactly one Adam step runs."""
    rng = np.random.default_rng(11)
    cur = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    prev = cur + 0.05 * rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    js, ts = jsched.make_ddim(6), tsched.make_ddim(6)
    t = int(ts.timesteps[3])
    u0, cond = jm.text_encode(""), jm.text_encode("p")
    lr = float(np.float32(1e-2 * (1.0 - 3 / 100.0)))
    if stop is None:
        eps_c = tm.unet_apply(torch.from_numpy(cur), t, tm.text_encode("p"))
        eps_u = tm.unet_apply(torch.from_numpy(cur), t, tm.text_encode(""))
        rec = tsched.ddim_step(ts, eps_u + 7.5 * (eps_c - eps_u), t, torch.from_numpy(cur))
        stop = float(torch.mean((rec - torch.from_numpy(prev)) ** 2)) * 1.001
    want = jinv.null_text_optimize_step(jm, js, jnp.asarray(cur), jnp.asarray(prev),
                                        jnp.int32(t), u0, cond, 7.5, 4, jnp.float32(lr),
                                        jnp.float32(stop))
    args = (tm, ts, torch.from_numpy(cur), torch.from_numpy(prev), t, tm.text_encode(""),
            tm.text_encode("p"), 7.5, 4, lr, float(np.float32(stop)))
    return want, args


@pytest.mark.parametrize("case", ["all_steps", "stop_after_one", "under_no_grad"])
def test_null_text_optimize_step_matches_jax(toy, case):
    """u and the advanced latent after one timestep: all 4 inner steps
    (stop 0), one step (stop just above the first loss), and all 4 steps
    called under torch.no_grad(), as the node calls the pipeline."""
    jm, tm = toy
    want, args = _null_text_case(jm, tm, None if case == "stop_after_one" else 0.0)
    with _CountGradCalls(tm) as calls:
        if case == "under_no_grad":
            with torch.no_grad():
                got = tinv.null_text_optimize_step(*args)
        else:
            got = tinv.null_text_optimize_step(*args)
    assert calls.n == (1 if case == "stop_after_one" else 4)
    u0 = args[5]
    assert not got[0].requires_grad and float((got[0] - u0).abs().max()) > 1e-3
    _close_u(got[0], want[0], u0)
    _close(got[1], want[1], 1e-5)


@pytest.mark.parametrize("null_text", [False, True])
def test_invert_matches_jax(toy, null_text):
    jm, tm = toy
    img, _ = _image_depth(32, seed=4)
    kw = dict(num_ddim_steps=4, guidance_scale=7.5, num_inner_steps=2,
              null_text_optimization=null_text)
    want = jinv.invert(jm, jnp.asarray(img), "p", **kw)
    got = tinv.invert(tm, torch.from_numpy(img), "p", **kw)
    assert tuple(got.uncond_embeddings.shape) == (4, 1, 77, 64)
    _close(got.latents, want.latents, 1e-5)
    _close(got.image_rec, want.image_rec, 1e-5)
    for i in range(4):
        _close_u(got.uncond_embeddings[i], want.uncond_embeddings[i], tm.text_encode(""))
    if null_text:
        assert float((got.uncond_embeddings[0] - tm.text_encode("")).abs().max()) > 1e-3


# --- text2stereo -------------------------------------------------------------------

def _text2stereo_pair(pair, size, steps, seed=3, **kw):
    jm, tm = pair
    img, depth = _image_depth(size)
    want = jpipe.text2stereo(jm, jnp.asarray(img), jnp.asarray(depth), "p",
                             num_inference_steps=steps, seed=seed, **kw)
    lat_shape = tuple(tm.vae_encode(torch.from_numpy(img)).shape)
    got = tpipe.text2stereo(tm, torch.from_numpy(img), torch.from_numpy(depth), "p",
                            num_inference_steps=steps, seed=seed,
                            noise=_jax_deblur_noise(seed, lat_shape), **kw)
    assert tuple(got.left.shape) == tuple(got.right.shape) == (1, size, size, 3)
    return got, want


@pytest.mark.parametrize("deblur,direction,null_text,scheduler", [
    (True, "uni", False, "auto"),
    (False, "bi", False, "ddim"),
    (True, "bi", False, "euler"),
    (False, "uni", True, "auto"),
    (True, "uni", True, "ddim"),
])
def test_text2stereo_toy_matches_jax(toy, deblur, direction, null_text, scheduler):
    got, want = _text2stereo_pair(toy, 64, 6, deblur=deblur, direction=direction,
                                  null_text_optimization=null_text, num_inner_steps=3,
                                  scheduler=scheduler, guidance_scale=7.5, scale_factor=40.0)
    atol = 1e-3 if null_text else 1e-4
    _close(got.left, want.left, atol)
    _close(got.right, want.right, atol)
    assert float((got.left - got.right).abs().max()) > 0


def test_text2stereo_auto_picks_euler_for_sd2_context(toy1024):
    got, want = _text2stereo_pair(toy1024, 32, 3, deblur=True, scale_factor=60.0)
    _close(got.left, want.left, 1e-4)
    _close(got.right, want.right, 1e-4)
    ddim = tpipe.text2stereo(toy1024[1], *(torch.from_numpy(a) for a in _image_depth(32)), "p",
                             num_inference_steps=3, seed=3, scheduler="ddim",
                             scale_factor=60.0, noise=_jax_deblur_noise(3, (1, 4, 4, 4)))
    assert not torch.equal(ddim.right, got.right)


@pytest.mark.parametrize("deblur,direction,null_text", [
    (True, "uni", True),
    (False, "bi", False),
])
def test_text2stereo_tiny_sd_matches_jax(tiny, deblur, direction, null_text):
    """The TINY SD UNet and VAE at 64x64 (32x32 latents), 4 steps,
    null-text with 2 inner steps."""
    got, want = _text2stereo_pair(tiny, 64, 4, deblur=deblur, direction=direction,
                                  null_text_optimization=null_text, num_inner_steps=2,
                                  guidance_scale=3.0, scale_factor=8.0)
    atol = 1e-3 if null_text else 1e-4
    _close(got.left, want.left, atol)
    _close(got.right, want.right, atol)


def test_text2stereo_draws_deblur_noise_from_seed(toy):
    _, tm = toy
    img, depth = (torch.from_numpy(a) for a in _image_depth(64))
    kw = dict(num_inference_steps=5, deblur=True, scale_factor=40.0)
    a = tpipe.text2stereo(tm, img, depth, "p", seed=5, **kw)
    b = tpipe.text2stereo(tm, img, depth, "p", seed=5, **kw)
    c = tpipe.text2stereo(tm, img, depth, "p", seed=6, **kw)
    fed = tpipe.text2stereo(tm, img, depth, "p", seed=0, noise=torch.randn(
        (1, 4, 8, 8), generator=torch.Generator().manual_seed(5)), **kw)
    assert torch.equal(a.right, b.right) and torch.equal(a.right, fed.right)
    assert torch.equal(a.left, c.left) and not torch.equal(a.right, c.right)


# --- the node ----------------------------------------------------------------------

def test_stereodiffusion_node_standard_matches_jax(toy, monkeypatch):
    """The Standard node on the toy (sample size 64), input 72x80 resized to
    64 and back, null-text on (10 inner steps), 5 steps, deblur on, scale
    20 (the node's maximum); the port gets JAX's deblur noise and text
    embeddings."""
    jm, tm = toy
    rng = np.random.default_rng(6)
    img = rng.random((2, 72, 80, 3), dtype=np.float32)
    dep = rng.random((2, 72, 80), dtype=np.float32)
    seed = 9
    monkeypatch.setattr(tnode, "text2stereo", functools.partial(
        tpipe.text2stereo, noise=_jax_deblur_noise(seed, (1, 4, 8, 8))))
    kw = dict(pipeline_mode="Standard (DDIM)", num_inference_steps=5, deblur=True,
              direction="bi", seed=seed, prompt="p", guidance_scale=3.0, scale_factor=20.0)
    want = jnode.StereoDiffusionNode().generate_stereo(img, dep, model=jm, **kw)
    before = tfa.LAUNCHES
    got = tnode.StereoDiffusionNode().generate_stereo(img, dep, model=tm, device="cpu", **kw)
    assert tfa.LAUNCHES == before
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == torch.float32
        assert tuple(g.shape) == w.shape and w.shape[0] == 1  # first frame only
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-3)
    assert float((got[1] - got[2]).abs().max()) > 0
