"""The port's public surface against the JAX package, on the CPU, on the same
numpy inputs: the video chunk reader's three modes, `rgb_to_gray_depth`,
`normalize_depth(batch_axes=)`, the `impl=` switches of `forward_warp` and
`apply_polylines_exact`, the loader's `clear_model_cache`,
`load_sd_from_diffusers_dir(text_encode=)`, and functions the JAX package's
tests exercise that no other port test names (`make_for_model_type`,
`sd_timestep_embedding`, `port_text_encoder_state`, `video_fps`, the model
and embedding caches). Tolerances: bit-equality, except where stated.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfystereo_tpu.diffusion import model_loader as jloader
from comfystereo_tpu.diffusion import porting as jporting
from comfystereo_tpu.diffusion import schedulers as jsched
from comfystereo_tpu.diffusion import sd_unet as jsd_unet
from comfystereo_tpu.diffusion.clip_text import CLIPTextConfig as JTextConfig
from comfystereo_tpu.diffusion.clip_text import CLIPTextModel as JCLIP
from comfystereo_tpu.ops import depth as jdepth
from comfystereo_tpu.ops import polylines_exact as jpe
from comfystereo_tpu.ops import warp as jwarp
from comfystereo_tpu.utils import caching as jcaching
from comfystereo_tpu.utils import fixtures
from comfystereo_tpu.utils import video as jvideo
from comfystereo_tpu_torch.diffusion import model_loader as tloader
from comfystereo_tpu_torch.diffusion import porting as tporting
from comfystereo_tpu_torch.diffusion import schedulers as tsched
from comfystereo_tpu_torch.diffusion import sd_unet as tsd_unet
from comfystereo_tpu_torch.diffusion.clip_text import CLIPTextConfig, CLIPTextModel
from comfystereo_tpu_torch.diffusion.sd_unet import SDUNetConfig
from comfystereo_tpu_torch.diffusion.sd_vae import SDVAEConfig
from comfystereo_tpu_torch.ops import depth as tdepth
from comfystereo_tpu_torch.ops import polylines_exact as tpe
from comfystereo_tpu_torch.ops import warp as twarp
from comfystereo_tpu_torch.utils import caching as tcaching
from comfystereo_tpu_torch.utils import video as tvideo
from torch_checkpoint import seeded_state, toy_vocab, write_sd_dir

LUMA_ATOL = 3e-7  # tests/test_torch_port_host.py's bound for the native luma


# --- video ------------------------------------------------------------------

def _write_avi(path: str, n: int = 7, h: int = 24, w: int = 40, fps: float = 12.0):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), fps, (w, h))
    assert wr.isOpened()
    for _ in range(n):
        wr.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    wr.release()
    return path


@pytest.mark.parametrize("mode", ["rgb", "gray", "raw"])
def test_iter_frame_chunks_equals_jax(tmp_path, mode):
    """7 FFV1 frames in chunks of 3: float32 RGB in 0-1 by default, the
    Rec.601 luma with gray=True (within the native luma bound), the
    decoder's BGR uint8 with raw=True; the fps too."""
    path = _write_avi(str(tmp_path / "v.avi"))
    kw = {"rgb": {}, "gray": {"gray": True}, "raw": {"raw": True}}[mode]
    want = list(jvideo.iter_frame_chunks(path, 3, **kw))
    got = list(tvideo.iter_frame_chunks(path, 3, **kw))
    assert [len(c) for c, _ in got] == [len(c) for c, _ in want] == [3, 3, 1]
    for (g, g_fps), (w, w_fps) in zip(got, want):
        assert g_fps == w_fps == 12.0
        assert g.dtype == w.dtype and g.shape == w.shape
        if mode == "gray":
            np.testing.assert_allclose(g, w, rtol=0, atol=LUMA_ATOL)
        else:
            np.testing.assert_array_equal(g, w)
    if mode == "raw":
        assert got[0][0].dtype == np.uint8 and got[0][0].shape == (3, 24, 40, 3)


def test_video_fps_equals_jax(tmp_path):
    path = _write_avi(str(tmp_path / "v.avi"), fps=24.0)
    assert tvideo.video_fps(path) == jvideo.video_fps(path) == 24.0
    with pytest.raises(RuntimeError):
        tvideo.video_fps(str(tmp_path / "missing.avi"))


# --- depth ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 4, 4, 3), (2, 5, 7, 3), (2, 5, 7, 1), (2, 5, 7),
                                   (5, 7), (2, 5, 7, 2)])
def test_rgb_to_gray_depth_equals_jax(shape):
    """The [..., 3] contraction within JAX's 1e-6 (XLA contracts the sum
    into FMAs; measured within 1.2e-7), the [..., 1] channel and the
    pass-through bit-equal; test_depth.py's all-ones case first."""
    x = (np.ones(shape, np.float32) if shape == (1, 4, 4, 3)
         else np.random.default_rng(3).random(shape).astype(np.float32))
    want = np.asarray(jdepth.rgb_to_gray_depth(jnp.asarray(x)))
    got = tdepth.rgb_to_gray_depth(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if shape[-1] == 3:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("batch_axes", [1, 2])
def test_normalize_depth_batch_axes_ignored_as_in_jax(batch_axes):
    d = np.random.default_rng(4).random((2, 3, 6, 9)).astype(np.float32) * 255
    want = np.asarray(jdepth.normalize_depth(jnp.asarray(d), batch_axes=batch_axes))
    got = tdepth.normalize_depth(torch.from_numpy(d), batch_axes=batch_axes)
    assert torch.equal(got, tdepth.normalize_depth(torch.from_numpy(d)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# --- impl= --------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["auto", "kernel", "twin"])
def test_forward_warp_impl_equals_jax(impl):
    """Every impl runs the plain version on the CPU: one output, JAX's
    (gap masks bit-equal, colours within tests/test_torch_port_warp.py's
    1e-5)."""
    img = fixtures.create_test_image(32, 64).astype(np.float32)[None] / 255.0
    dep = fixtures.create_depth_map(32, 64).astype(np.float32)[None]
    a, gap_a = jwarp.forward_warp(jnp.asarray(img), jnp.asarray(dep), 4.0, 0.5, 2.0)
    b, gap_b = twarp.forward_warp(torch.from_numpy(img), torch.from_numpy(dep), 4.0, 0.5, 2.0,
                                  impl=impl)
    np.testing.assert_array_equal(gap_b.numpy(), np.asarray(gap_a))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "kernel", "twin"])
def test_apply_polylines_exact_impl_equals_jax(impl):
    img = np.trunc(fixtures.create_test_image(16, 48).astype(np.float32))[None]
    nd = fixtures.create_depth_map(16, 48).astype(np.float32)[None] / 255.0 - 0.5
    want = np.asarray(jpe.apply_polylines_exact(jnp.asarray(img), jnp.asarray(nd), 3.0, 0.5,
                                                2.0, sharp=True, impl="xla"))
    got = tpe.apply_polylines_exact(torch.from_numpy(img), torch.from_numpy(nd), 3.0, 0.5,
                                    2.0, sharp=True, impl=impl)
    np.testing.assert_array_equal(got.numpy(), want)


def test_impl_values_are_checked():
    img, dep = torch.zeros(1, 4, 8, 3), torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="impl"):
        twarp.forward_warp(img, dep, 1.0, 0.0, 2.0, impl="pallas")
    with pytest.raises(ValueError, match="impl"):
        tpe.apply_polylines_exact(img, dep, 1.0, 0.0, 2.0, impl="xla")


# --- caches and loading -----------------------------------------------------

def test_model_loader_clear_model_cache_clears_the_one_cache():
    """The loader's clear_model_cache is the model cache's own (one cache),
    and empties it as JAX's empties its loader's: a cleared key loads
    again."""
    assert tloader.clear_model_cache is tcaching.clear_model_cache
    jloader._model_cache["surface-test"] = object()
    jloader.clear_model_cache()
    assert not jloader._model_cache
    calls = []
    for _ in range(2):
        tcaching.get_or_load_model("surface-test", lambda: calls.append(1) or object())
    tloader.clear_model_cache()
    tcaching.get_or_load_model("surface-test", lambda: calls.append(1) or object())
    assert calls == [1, 1]
    tloader.clear_model_cache()


def test_model_and_embedding_caches_equal_jax():
    """tests/test_utils.py's cache tests, on both packages."""
    for mod in (jcaching, tcaching):
        calls = []
        mod.clear_model_cache()

        def loader():
            calls.append(1)
            return object()

        a = mod.get_or_load_model(("m", 1), loader)
        assert mod.get_or_load_model(("m", 1), loader) is a and len(calls) == 1
        mod.clear_model_cache()
        seen = []
        cache = mod.EmbeddingCache(lambda t: seen.append(t) or len(t), capacity=2)
        assert cache("a") == 1 and cache("a") == 1
        cache("bb")
        cache("ccc")  # evicts "a"
        cache("a")
        assert seen == ["a", "bb", "ccc", "a"], mod.__name__


SMALL_UNET = SDUNetConfig(in_channels=4, block_out_channels=(32, 64), layers_per_block=1,
                          cross_attention_dim=64, attention_head_dim=8)
SMALL_VAE = SDVAEConfig(block_out_channels=(32, 64), layers_per_block=1)
SMALL_TEXT = CLIPTextConfig(vocab_size=96, hidden_size=64, num_hidden_layers=1,
                            num_attention_heads=4, intermediate_size=64)


def test_load_sd_from_diffusers_dir_text_encode(tmp_path, capsys):
    """A caller's text encoder replaces the directory's CLIP in both
    packages (the directory's is not read: it is removed here); without
    one, the port loads the directory's."""
    write_sd_dir(str(tmp_path), SMALL_UNET, SMALL_VAE, SMALL_TEXT, toy_vocab(), seed=2,
                 dtype=torch.float32)

    def encode(text):
        return np.zeros((1, 77, 64), np.float32)

    own = tporting.load_sd_from_diffusers_dir(str(tmp_path), device="cpu")
    assert own.text_encode is not encode and own.text_encode("low").shape == (1, 77, 64)
    for sub in ("text_encoder", "tokenizer"):
        for name in os.listdir(tmp_path / sub):
            os.remove(tmp_path / sub / name)
    got = tporting.load_sd_from_diffusers_dir(str(tmp_path), text_encode=encode,
                                              device="cpu")
    want = jporting.load_sd_from_diffusers_dir(str(tmp_path), text_encode=encode)
    assert got.text_encode is encode and want.text_encode is encode
    assert "hash-stub" not in capsys.readouterr().out


# --- functions the JAX package's tests exercise -----------------------------

@pytest.mark.parametrize("model_type", ["SD1", "SD2", "SDXL"])
def test_make_for_model_type_equals_jax(model_type):
    """tests/test_schedulers.py:211: DDIM for SD1 (and the default), Euler
    for SD2; the schedules equal JAX's, and one generic step agrees."""
    j, t = jsched.make_for_model_type(model_type, 10), tsched.make_for_model_type(model_type, 10)
    assert (t.sigmas is None) == (j.sigmas is None) == (model_type != "SD2")
    np.testing.assert_array_equal(np.asarray(t.timesteps), np.asarray(j.timesteps))
    np.testing.assert_array_equal(np.asarray(t.alphas_cumprod), np.asarray(j.alphas_cumprod))
    if j.sigmas is not None:
        np.testing.assert_array_equal(np.asarray(t.sigmas), np.asarray(j.sigmas))
    rng = np.random.default_rng(6)
    x, eps = (rng.normal(size=(2, 4, 8, 8)).astype(np.float32) for _ in range(2))
    ts = int(j.timesteps[0])
    want = np.asarray(jsched.scheduler_step(j, jnp.asarray(eps), jnp.int32(ts), jnp.asarray(x)))
    got = tsched.scheduler_step(t, torch.from_numpy(eps), ts, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dim", [8, 320])
def test_sd_timestep_embedding_equals_jax(dim):
    """tests/test_sd_models.py:72 (cos half then sin half), and timesteps up
    to 999 within one float32 ulp of the largest argument, t * freq <= 999
    (6.1e-5): the two frameworks' exp and sin/cos round such arguments
    differently (measured 5.7e-5 at dim 320, 6e-8 at dim 8)."""
    t = np.array([0.0, 1.0, 37.0, 999.0], np.float32)
    want = np.asarray(jsd_unet.sd_timestep_embedding(jnp.asarray(t), dim))
    got = tsd_unet.sd_timestep_embedding(torch.from_numpy(t), dim).numpy()
    assert got.shape == want.shape == (4, dim)
    np.testing.assert_allclose(got[0, :dim // 2], 1.0, atol=1e-6)
    np.testing.assert_allclose(got[0, dim // 2:], 0.0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=float(np.spacing(np.float32(999.0))))


def test_port_text_encoder_state_equals_jax():
    """tests/test_clip_text.py:154: one transformers-layout state dict
    through both packages' port_text_encoder_state (configs inferred from
    the shapes, and given), then the same ids through both CLIPs, within
    tests/test_torch_port_clip.py's float32 bound."""
    state = seeded_state(CLIPTextModel, SMALL_TEXT, 7)  # transformers layout: text_model.*
    jcfg = JTextConfig(vocab_size=96, hidden_size=64, num_hidden_layers=1,
                       num_attention_heads=4, intermediate_size=64)
    jparams, jcfg2 = jporting.port_text_encoder_state({k: v.numpy() for k, v in state.items()},
                                                      cfg=jcfg)
    tsd, tcfg = tporting.port_text_encoder_state(state, cfg=SMALL_TEXT)
    _, inferred = tporting.port_text_encoder_state(state)
    _, jinferred = jporting.port_text_encoder_state({k: v.numpy() for k, v in state.items()})
    for f in ("vocab_size", "hidden_size", "num_hidden_layers", "intermediate_size"):
        assert getattr(inferred, f) == getattr(jinferred, f), f
    model = CLIPTextModel(tcfg)
    model.load_state_dict(tsd)
    ids = np.random.default_rng(8).integers(0, 96, size=(2, 77))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    want = np.asarray(JCLIP(jcfg2).apply(jparams, jnp.asarray(ids, jnp.int32)))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_build_sd_model_init_mode_zeros_equals_jax():
    """init_mode="zeros": every weight zero, as JAX's; one UNet call and a
    VAE decode give JAX's outputs (zeros); "random" stays the default."""
    from comfystereo_tpu.diffusion.sd_unet import TINY_SD_UNET_CONFIG as J_UNET
    from comfystereo_tpu.diffusion.sd_vae import TINY_SD_VAE_CONFIG as J_VAE
    from comfystereo_tpu_torch.diffusion import (TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG,
                                                 build_sd_model)
    t = build_sd_model(TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, device="cpu", init_mode="zeros")
    assert all(float(p.abs().max()) == 0.0 for p in t.unet.parameters())
    assert all(float(p.abs().max()) == 0.0 for p in t.vae.parameters())
    j = jporting.build_sd_model(J_UNET, J_VAE, init_mode="zeros")
    rng = np.random.default_rng(9)
    lat = rng.normal(size=(1, 4, 8, 8)).astype(np.float32)
    ctx = rng.normal(size=(1, 77, J_UNET.cross_attention_dim)).astype(np.float32)
    want = np.asarray(j.unet_apply(j.unet_params, jnp.asarray(lat), jnp.float32(10.0),
                                   jnp.asarray(ctx)))
    got = t.unet_apply(torch.from_numpy(lat), torch.tensor([10.0]), torch.from_numpy(ctx))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(j.vae_decode(j.vae_params, jnp.asarray(lat)))
    np.testing.assert_array_equal(t.vae_decode(torch.from_numpy(lat)).numpy(), want)
    r = build_sd_model(TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, device="cpu")
    assert float(next(r.unet.parameters()).abs().max()) > 0.0
    with pytest.raises(ValueError, match="init_mode"):
        build_sd_model(TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, device="cpu", init_mode="ones")
