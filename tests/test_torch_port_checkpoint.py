"""Port's checkpoint I/O, key work and loading vs the JAX package.

JAX and torch both on the CPU, the same files and state dicts through both.
Tolerances:

* safetensors: the port's writer and parser (no package) bit-equal both
  ways with the safetensors package and with the JAX package's reader and
  writer, through that package and without it (JAX's own parser widens
  bfloat16 to float32, which is exact).
* key normalisation, the LDM maps and config inference: equal keys, equal
  configs, bit-equal values.
* models loaded from a TINY diffusers directory, or carried across from
  torch modules: eps, VAE encode/decode and text embeddings within the
  float32 bound of tests/test_torch_port_diffusion.py, atol = rtol = 1e-4.
"""
import dataclasses
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from comfystereo_tpu.diffusion import adapters as jadapters
from comfystereo_tpu.diffusion import porting as jporting
from comfystereo_tpu.diffusion.sd_unet import TINY_SD_UNET_CONFIG as J_TINY_UNET
from comfystereo_tpu.diffusion.sd_vae import TINY_SD_VAE_CONFIG as J_TINY_VAE
from comfystereo_tpu.diffusion.sd_vae import SDVAE as JVAE
from comfystereo_tpu_torch.diffusion import (TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG,
                                             TINY_TEXT_CONFIG, CLIPBPETokenizer,
                                             NativeCLIPTextEncoder, SDUNet, state_dict_from_jax)
from comfystereo_tpu_torch.diffusion import porting as tporting
from comfystereo_tpu_torch.diffusion.adapters import from_torch_modules
from comfystereo_tpu_torch.utils import caching
from torch_checkpoint import toy_vocab, write_sd_dir
from torch_ref import TorchSDUNet, TorchSDVAE

ATOL = RTOL = 1e-4
PROMPTS = ("low", "lower lower", "")


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tensors():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(7, 5, generator=gen)
    return {"a.half_odd": torch.randn(3, generator=gen).half(),  # odd bytes first
            "b.f32": x, "c.f16": (x * 3).half(), "d.bf16": (x / 3).bfloat16(),
            "e.i8": torch.arange(-5, 6, dtype=torch.int8), "f.conv": torch.randn(
                4, 2, 3, 3, generator=gen), "g.empty": torch.zeros(0, 4)}


def _bits(t):
    return t.contiguous().view(torch.uint8) if t.numel() else t


def _hide_package(monkeypatch):
    """`import safetensors...` fails from here on (the JAX package then
    parses and writes the format itself)."""
    for name in ("safetensors", "safetensors.torch", "safetensors.numpy"):
        monkeypatch.setitem(sys.modules, name, None)


def test_safetensors_port_roundtrip_bit_equal(tmp_path, monkeypatch):
    """The port's writer and parser need no safetensors package."""
    _hide_package(monkeypatch)
    src = _tensors()
    path = str(tmp_path / "t.safetensors")
    tporting.save_safetensors(src, path)
    got = tporting.load_safetensors(path)
    assert set(got) == set(src)
    for k, v in src.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert torch.equal(_bits(got[k]), _bits(v)), k


@pytest.mark.parametrize("reader", ["safetensors", "jax", "jax-own"])
def test_safetensors_port_writes_jax_reads(tmp_path, reader, monkeypatch):
    """The port's file read by the safetensors package, by the JAX package
    through that package, and by the JAX package's own parser."""
    src = _tensors()
    path = str(tmp_path / "t.safetensors")
    tporting.save_safetensors(src, path)
    if reader == "safetensors":
        got = dict(pytest.importorskip("safetensors.torch").load_file(path))
        assert set(got) == set(src)
        for k, v in src.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            assert torch.equal(_bits(got[k]), _bits(v)), k
        return
    if reader == "jax-own":
        _hide_package(monkeypatch)
    else:
        pytest.importorskip("safetensors.numpy")
    src.pop("e.i8")
    got = jporting.load_safetensors(path)
    for k, v in src.items():
        g = got[k]
        if v.dtype == torch.bfloat16:  # bf16 with the package, else widened to f32
            g, v = g.astype(np.float32), v.float()
        assert g.dtype == v.numpy().dtype and g.shape == tuple(v.shape)
        assert np.array_equal(g.view(np.uint8), v.numpy().view(np.uint8)), k


@pytest.mark.parametrize("writer", ["safetensors", "jax", "jax-own"])
def test_safetensors_jax_writes_port_reads(tmp_path, writer, monkeypatch):
    """Files of the safetensors package, of the JAX package through that
    package, and of the JAX package's own writer, read by the port's
    parser."""
    path = str(tmp_path / "t.safetensors")
    if writer == "safetensors":
        src = _tensors()
        pytest.importorskip("safetensors.torch").save_file(src, path)
    else:
        rng = np.random.default_rng(1)
        arrays = {"a.half_odd": rng.standard_normal(3).astype(np.float16),
                  "b.f32": rng.standard_normal((7, 5)).astype(np.float32),
                  "c.f16": rng.standard_normal((2, 3, 3)).astype(np.float16),
                  "d.i8": np.arange(-4, 4, dtype=np.int8)}
        if writer == "jax-own":
            _hide_package(monkeypatch)
        else:
            pytest.importorskip("safetensors.numpy")
        jporting.save_safetensors(arrays, path)
        src = {k: torch.from_numpy(v) for k, v in arrays.items()}
    _hide_package(monkeypatch)
    got = tporting.load_safetensors(path)
    assert set(got) == set(src)
    for k, v in src.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        assert torch.equal(_bits(got[k]), _bits(v)), k


# ---------------------------------------------------------------------------
# Key work
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_vae():
    vp = jax.jit(JVAE(J_TINY_VAE).init)(jax.random.PRNGKey(1), jnp.zeros((1, 3, 32, 32)))
    return jax.tree.map(np.asarray, vp)


_LEGACY = {"to_q": "query", "to_k": "key", "to_v": "value"}


def _legacy_vae(modern):
    """Modern diffusers VAE keys -> the pre-0.18 layout: query/key/value/
    proj_attn projections stored as [C, C, 1, 1] convs, the attention's
    GroupNorm named norm, plus non-parameter entries."""
    out = {}
    for k, v in modern.items():
        parts = k.split(".")
        if "attentions" in parts:
            i = parts.index("attentions") + 2
            name = parts[i]
            if name in _LEGACY:
                parts[i] = _LEGACY[name]
            elif name == "to_out":
                parts[i:i + 2] = ["proj_attn"]
            elif name == "group_norm":
                parts[i] = "norm"
            if parts[-1] == "weight" and v.ndim == 2:
                v = v[:, :, None, None]
        out[".".join(parts)] = v
    out["encoder.num_batches_tracked"] = np.zeros((), np.int64)
    out["text_model.embeddings.position_ids"] = np.arange(77)[None]
    return out


def test_normalize_state_dict_matches_jax_legacy_vae(jax_vae):
    legacy = _legacy_vae(jporting.flax_to_torch_state_dict(jax_vae))
    assert any(".query." in k for k in legacy)
    got = tporting.normalize_state_dict(legacy)
    want = state_dict_from_jax(jporting.torch_to_flax_params(legacy))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k
    q = "encoder.mid_block.attentions.0.to_q.weight"
    assert got[q].dim() == 2
    with torch.device("meta"):
        ref = tporting.SDVAE(TINY_SD_VAE_CONFIG).state_dict()
    tporting.check_port(ref, got)


def test_normalize_keeps_unet_transformer_norm_and_check_port_lists_mismatches():
    with torch.device("meta"):
        ref = SDUNet(TINY_SD_UNET_CONFIG).state_dict()
    sd = {k: torch.zeros(v.shape) for k, v in ref.items()}
    norm = "down_blocks.0.attentions.0.norm.weight"
    assert norm in sd
    out = tporting.normalize_state_dict(sd)
    assert set(out) == set(ref)
    tporting.check_port(ref, out)
    del out["conv_in.weight"]
    out["conv_out.bias"] = torch.zeros(3)
    out["extra.weight"] = torch.zeros(2)
    with pytest.raises(ValueError) as ei:
        tporting.check_port(ref, out)
    msg = str(ei.value)
    assert "missing in port: conv_in.weight" in msg
    assert "unexpected in port: extra.weight" in msg
    assert "shape mismatch conv_out.bias" in msg


_RES = {"norm1": "in_layers.0", "conv1": "in_layers.2", "time_emb_proj": "emb_layers.1",
        "norm2": "out_layers.0", "conv2": "out_layers.3", "conv_shortcut": "skip_connection"}


def _ldm_unet(sd, layers):
    """Diffusers UNet keys -> the LDM/ComfyUI `UNetModel` layout (the inverse
    of `ldm_unet_to_diffusers`), under the model.diffusion_model. prefix."""
    per = layers + 1
    up_attn = {k.split(".")[1] for k in sd if k.startswith("up_blocks.") and ".attentions." in k}
    out = {}
    for k, v in sd.items():
        p = k.split(".")
        if p[0] == "time_embedding":
            key = f"time_embed.{0 if p[1] == 'linear_1' else 2}.{p[2]}"
        elif p[0] in ("conv_in", "conv_norm_out", "conv_out"):
            key = {"conv_in": "input_blocks.0.0", "conv_norm_out": "out.0",
                   "conv_out": "out.2"}[p[0]] + "." + p[-1]
        elif p[0] == "mid_block":
            n = {"resnets.0": 0, "attentions.0": 1, "resnets.1": 2}[f"{p[1]}.{p[2]}"]
            rest = _RES[p[3]] + "." + ".".join(p[4:]) if p[1] == "resnets" else ".".join(p[3:])
            key = f"middle_block.{n}.{rest}"
        else:
            b, kind = int(p[1]), p[2]
            down = p[0] == "down_blocks"
            base, blocks = (1 + b * per, "input_blocks") if down else (b * per, "output_blocks")
            if kind == "resnets":
                key = f"{blocks}.{base + int(p[3])}.0.{_RES[p[4]]}." + ".".join(p[5:])
            elif kind == "attentions":
                key = f"{blocks}.{base + int(p[3])}.1." + ".".join(p[4:])
            elif down:
                key = f"input_blocks.{base + layers}.0.op." + ".".join(p[5:])
            else:
                idx = 2 if p[1] in up_attn else 1
                key = f"output_blocks.{base + layers}.{idx}.conv." + ".".join(p[5:])
        out["model.diffusion_model." + key] = v
    return out


def _ldm_vae(sd, n_blocks):
    """Diffusers VAE keys -> the LDM AutoencoderKL layout (decoder up-block
    order reversed, attention projections as [C, C, 1, 1] convs)."""
    attn = {"group_norm": "norm", "to_q": "q", "to_k": "k", "to_v": "v", "to_out": "proj_out"}
    out = {}
    for k, v in sd.items():
        p = k.split(".")
        if p[0] in ("quant_conv", "post_quant_conv") or p[1] in ("conv_in", "conv_out"):
            key = k
        elif p[1] == "conv_norm_out":
            key = f"{p[0]}.norm_out.{p[2]}"
        elif p[1] == "mid_block":
            if p[2] == "attentions":
                key = f"{p[0]}.mid.attn_1.{attn[p[4]]}.{p[-1]}"
                if p[-1] == "weight" and v.dim() == 2:
                    v = v[:, :, None, None]
            else:
                rest = ".".join(p[5:]).replace("conv_shortcut", "nin_shortcut")
                key = f"{p[0]}.mid.block_{int(p[3]) + 1}.{p[4]}" + (f".{rest}" if rest else "")
        else:
            i = int(p[2]) if p[0] == "encoder" else n_blocks - 1 - int(p[2])
            side = "down" if p[0] == "encoder" else "up"
            if p[3] == "resnets":
                rest = ".".join(p[5:]).replace("conv_shortcut", "nin_shortcut")
                key = f"{p[0]}.{side}.{i}.block.{p[4]}.{rest}"
            else:
                key = f"{p[0]}.{side}.{i}.{side}sample." + ".".join(p[5:])
        out["first_stage_model." + key] = v
    return out


class FakeTorchModule:
    """Duck-typed torch module exposing state_dict()."""

    def __init__(self, sd):
        self._sd = sd

    def state_dict(self):
        return self._sd


UNET2 = dataclasses.replace(TINY_SD_UNET_CONFIG, layers_per_block=2)
J_UNET2 = dataclasses.replace(J_TINY_UNET, layers_per_block=2)


def _torch_unet(cfg=UNET2, seed=0):
    torch.manual_seed(seed)
    return TorchSDUNet(cfg).eval()


def _torch_vae(seed=1):
    torch.manual_seed(seed)
    return TorchSDVAE(TINY_SD_VAE_CONFIG).eval()


def test_ldm_maps_and_config_inference_match_jax():
    unet_sd = _torch_unet().state_dict()
    ldm = _ldm_unet(unet_sd, 2)
    assert tporting.looks_like_ldm(ldm) and jporting.looks_like_ldm(ldm)
    assert not tporting.looks_like_ldm(unet_sd) and not jporting.looks_like_ldm(unet_sd)
    got = tporting.ldm_unet_to_diffusers(ldm, layers_per_block=2)
    assert list(got) == list(jporting.ldm_unet_to_diffusers(ldm, layers_per_block=2))
    assert set(got) == set(unet_sd)
    assert all(torch.equal(got[k], unet_sd[k]) for k in got)
    vae_sd = _torch_vae().state_dict()
    lv = _ldm_vae(vae_sd, len(TINY_SD_VAE_CONFIG.block_out_channels))
    gv = tporting.ldm_vae_to_diffusers(lv)
    assert list(gv) == list(jporting.ldm_vae_to_diffusers(lv))
    norm = tporting.normalize_state_dict(gv)
    assert set(norm) == set(vae_sd)
    assert all(torch.equal(norm[k], vae_sd[k]) for k in vae_sd)
    for sd in (unet_sd, {k: np.zeros(v.shape) for k, v in _sd2_unet().items()}):
        # The port's config has SDXL's fields besides JAX's; on these SD
        # layouts they keep their defaults.
        got = dataclasses.asdict(tporting.infer_unet_config(sd))
        want = dataclasses.asdict(jporting.infer_unet_config(sd))
        extra = {f.name: f.default for f in dataclasses.fields(tporting.SDUNetConfig)
                 if f.name not in want}
        assert got == {**want, **extra}
    assert dataclasses.asdict(tporting.infer_vae_config(vae_sd)) == dataclasses.asdict(
        jporting.infer_vae_config(vae_sd))


def _sd2_unet():
    z = torch.zeros
    return {"conv_in.weight": z(320, 4, 3, 3), "conv_out.weight": z(4, 320, 3, 3),
            "down_blocks.0.resnets.0.conv1.weight": z(320, 320, 3, 3),
            "down_blocks.0.resnets.1.conv1.weight": z(320, 320, 3, 3),
            "down_blocks.1.resnets.0.conv1.weight": z(640, 320, 3, 3),
            "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight": z(320, 1024)}


# ---------------------------------------------------------------------------
# Models from torch modules
# ---------------------------------------------------------------------------

def _inputs(seed, channels=4, size=16, ctx_dim=64, batch=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, channels, size, size)).astype(np.float32),
            rng.standard_normal((batch, 77, ctx_dim)).astype(np.float32))


@pytest.mark.parametrize("layout", ["diffusers", "ldm"])
def test_port_torch_modules_match_module_and_jax(layout):
    unet, vae = _torch_unet(), _torch_vae()
    if layout == "ldm":
        m_unet = FakeTorchModule(_ldm_unet(unet.state_dict(), 2))
        m_vae = FakeTorchModule(_ldm_vae(vae.state_dict(), 2))
    else:
        m_unet, m_vae = unet, vae
    usd, ucfg = tporting.port_torch_unet(m_unet, cfg=UNET2)
    vsd, vcfg = tporting.port_torch_vae(m_vae, cfg=TINY_SD_VAE_CONFIG)
    assert vsd["encoder.mid_block.attentions.0.to_q.weight"].dim() == 2
    tm = tporting.build_sd_model(ucfg, vcfg, device="cpu", unet_state=usd, vae_state=vsd)
    jp, _ = jporting.port_torch_unet(m_unet, cfg=J_UNET2)
    jv, _ = jporting.port_torch_vae(m_vae, cfg=J_TINY_VAE)
    jm = jporting.build_sd_model(J_UNET2, J_TINY_VAE, unet_params=jp, vae_params=jv)
    lat, ctx = _inputs(3)
    got = tm.unet_apply(torch.from_numpy(lat), 321, torch.from_numpy(ctx))
    with torch.no_grad():
        ref = unet(torch.from_numpy(lat), torch.tensor(321.0), torch.from_numpy(ctx))
    want = jm.unet_apply(jm.unet_params, jnp.asarray(lat), jnp.float32(321), jnp.asarray(ctx))
    np.testing.assert_allclose(_np(got), _np(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=RTOL)
    img = np.random.default_rng(4).uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32)
    got = tm.vae_encode(torch.from_numpy(img))
    with torch.no_grad():
        ref = vae.encode_mean(torch.from_numpy(img))
    np.testing.assert_allclose(_np(got), _np(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_np(got), _np(jm.vae_encode(jm.vae_params, jnp.asarray(img))),
                               atol=ATOL, rtol=RTOL)
    with torch.no_grad():
        ref = vae.decode(got)
    np.testing.assert_allclose(_np(tm.vae_decode(got)), _np(ref), atol=ATOL, rtol=RTOL)


def test_from_torch_modules_ports_clip_and_runs_on_the_port():
    transformers = pytest.importorskip("transformers")
    unet, vae = _torch_unet(), _torch_vae()
    # One head: the head count the port infers from a 64-wide tower.
    t_cfg = transformers.CLIPTextConfig(vocab_size=96, hidden_size=64, num_hidden_layers=2,
                                        num_attention_heads=1, intermediate_size=64,
                                        max_position_embeddings=77)
    torch.manual_seed(2)
    text = transformers.CLIPTextModel(t_cfg).eval()
    tok = CLIPBPETokenizer(*toy_vocab())
    model = from_torch_modules(unet, vae, tok, text, unet_cfg=UNET2,
                               vae_cfg=TINY_SD_VAE_CONFIG, device="cpu")
    jm = jadapters.from_torch_modules(unet, vae, tok, text, unet_cfg=J_UNET2,
                                      vae_cfg=J_TINY_VAE)
    assert isinstance(model.unet, SDUNet) and model.device == torch.device("cpu")
    assert isinstance(model.text_encode, NativeCLIPTextEncoder)
    with torch.no_grad():
        want = text(tok(["low"], return_tensors="pt").input_ids).last_hidden_state
    got = _np(model.text_encode("low"))
    np.testing.assert_allclose(got, _np(want), atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, _np(jm.text_encode("low")), atol=2e-5, rtol=1e-4)
    lat, ctx = _inputs(5)
    with torch.no_grad():
        ref = unet(torch.from_numpy(lat), torch.tensor(10.0), torch.from_numpy(ctx))
    got = _np(model.unet_apply(torch.from_numpy(lat), 10, torch.from_numpy(ctx)))
    np.testing.assert_allclose(got, _np(ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, _np(jm.unet_apply(jm.unet_params, jnp.asarray(lat),
                                                      jnp.float32(10), jnp.asarray(ctx))),
                               atol=ATOL, rtol=RTOL)


class _OpaqueUNet(torch.nn.Module):
    """A UNet-like module the port cannot carry across (no SD keys)."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Conv2d(4, 4, 1)

    def forward(self, x, t, encoder_hidden_states):
        return {"sample": self.proj(x) + encoder_hidden_states.mean() + t.float()}


def test_from_torch_modules_falls_back_to_the_given_modules(capsys):
    unet = _OpaqueUNet()
    text = torch.nn.Embedding(96, 8)
    tok = CLIPBPETokenizer(*toy_vocab())
    model = from_torch_modules(unet, None, tok, lambda ids: (text(ids),), device="cpu")
    assert "weight port unavailable" in capsys.readouterr().out
    lat, ctx = _inputs(6, size=8, ctx_dim=8, batch=1)
    got = model.unet_apply(torch.from_numpy(lat), 7, torch.from_numpy(ctx))
    with torch.no_grad():
        want = unet(torch.from_numpy(lat), torch.tensor(7), torch.from_numpy(ctx))["sample"]
    assert torch.equal(got, want) and not got.requires_grad
    emb = model.text_encode("low")
    assert tuple(emb.shape) == (1, 77, 8) and model.text_encode("low") is emb


@pytest.mark.parametrize("off", ["unet", "text_encoder"])
def test_from_torch_modules_refuses_fallback_modules_off_its_device(off, capsys):
    """A module the port cannot carry across runs itself only on the
    bundle's device: here it lies on the meta device, the bundle on the
    CPU, and the adapter refuses it instead of running it elsewhere."""
    unet, text = _OpaqueUNet(), torch.nn.Embedding(96, 8)
    if off == "unet":
        unet = unet.to("meta")
    else:
        text = text.to("meta")
    with pytest.raises(ValueError, match=f"given {off} has parameters on meta, not on cpu"):
        from_torch_modules(unet, None, CLIPBPETokenizer(*toy_vocab()), text, device="cpu")


def test_from_torch_modules_lets_device_errors_through(monkeypatch, capsys):
    """Only the port's own mismatch errors lead to the fallback: an error of
    the device (here a card out of memory) propagates."""
    def oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(tporting, "build_sd_model", oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        from_torch_modules(_torch_unet(), _torch_vae(), None, None, unet_cfg=UNET2,
                           vae_cfg=TINY_SD_VAE_CONFIG, device="cpu")
    assert "unavailable" not in capsys.readouterr().out


# ---------------------------------------------------------------------------
# A TINY diffusers directory through both loaders
# ---------------------------------------------------------------------------

def test_tiny_dir_loaded_by_both_packages(tmp_path):
    states, nbytes, _ = write_sd_dir(str(tmp_path), TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG,
                                     TINY_TEXT_CONFIG, toy_vocab(), seed=3)
    assert nbytes > 0 and states["unet"]["conv_in.weight"].dtype == torch.float16
    tm = tporting.load_sd_from_diffusers_dir(str(tmp_path), TINY_SD_UNET_CONFIG,
                                             TINY_SD_VAE_CONFIG, dtype=torch.float32,
                                             device="cpu")
    jm = jporting.load_sd_from_diffusers_dir(str(tmp_path), J_TINY_UNET, J_TINY_VAE,
                                             dtype=jnp.float32)
    assert isinstance(tm.text_encode, NativeCLIPTextEncoder) and tm.sample_size == 512
    assert torch.equal(tm.unet.conv_in.weight, states["unet"]["conv_in.weight"].float())
    for p in PROMPTS:
        np.testing.assert_allclose(_np(tm.text_encode(p)), _np(jm.text_encode(p)),
                                   atol=ATOL, rtol=RTOL)
    lat, ctx = _inputs(7)
    np.testing.assert_allclose(
        _np(tm.unet_apply(torch.from_numpy(lat), 500, torch.from_numpy(ctx))),
        _np(jm.unet_apply(jm.unet_params, jnp.asarray(lat), jnp.float32(500),
                          jnp.asarray(ctx))), atol=ATOL, rtol=RTOL)
    img = np.random.default_rng(8).uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32)
    z = np.random.default_rng(9).standard_normal((1, 4, 16, 16)).astype(np.float32)
    np.testing.assert_allclose(_np(tm.vae_encode(torch.from_numpy(img))),
                               _np(jm.vae_encode(jm.vae_params, jnp.asarray(img))),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_np(tm.vae_decode(torch.from_numpy(z))),
                               _np(jm.vae_decode(jm.vae_params, jnp.asarray(z))),
                               atol=ATOL, rtol=RTOL)


def test_dir_without_text_encoder_falls_back_to_hash(tmp_path, capsys):
    write_sd_dir(str(tmp_path), TINY_SD_UNET_CONFIG, TINY_SD_VAE_CONFIG, TINY_TEXT_CONFIG,
                 toy_vocab())
    (tmp_path / "tokenizer" / "vocab.json").unlink()
    m = tporting.load_sd_from_diffusers_dir(str(tmp_path), TINY_SD_UNET_CONFIG,
                                            TINY_SD_VAE_CONFIG, device="cpu")
    assert "hash-stub" in capsys.readouterr().out
    assert tuple(m.text_encode("x").shape) == (1, 77, 64)
    with pytest.raises(ValueError, match="checkpoint port mismatch"):
        tporting.load_sd_from_diffusers_dir(
            str(tmp_path), dataclasses.replace(TINY_SD_UNET_CONFIG, in_channels=9),
            TINY_SD_VAE_CONFIG, device="cpu")


def test_save_and_load_params_roundtrip(tmp_path):
    sd = {"a": torch.randn(3, 4), "b": {"c": torch.arange(5)}}
    caching.save_params(str(tmp_path / "p.pt"), sd)
    back = caching.load_params(str(tmp_path / "p.pt"))
    assert torch.equal(back["a"], sd["a"]) and torch.equal(back["b"]["c"], sd["b"]["c"])
