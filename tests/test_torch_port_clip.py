"""Port's CLIP text encoder and BPE tokenizer vs the JAX package.

JAX and torch both on the CPU. The flax CLIP (TINY widths, both
activations) is initialised with a jitted `init` and carried across with
`state_dict_from_jax`; the same token ids go through both. Tolerances:

* tokenizer: ids equal (the same pure-Python BPE).
* CLIP float32: atol 2e-5, rtol 1e-4 (the JAX package's own bound against
  transformers, tests/test_clip_text.py); against transformers' torch
  CLIPTextModel the same.
* CLIP bfloat16: relative L2 <= 1e-2 of the JAX package's bf16 output
  (measured 6.5-7.0e-3; the JAX package's own bf16 output is 8.0-8.5e-3
  from its float32 one): the two frameworks round the products' and the
  norms' results to bf16 after sums in other orders.
"""
import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from comfystereo_tpu.diffusion import clip_text as jclip
from comfystereo_tpu.diffusion import clip_tokenizer as jtok
from comfystereo_tpu.diffusion import porting as jporting
from comfystereo_tpu_torch.diffusion import clip_text as tclip
from comfystereo_tpu_torch.diffusion import clip_tokenizer as ttok
from comfystereo_tpu_torch.diffusion import porting as tporting
from comfystereo_tpu_torch.diffusion import state_dict_from_jax
from torch_checkpoint import clip_vocab, toy_vocab, write_tokenizer

TEXTS = ["low", "lower lower", "low, lower!", "LOW   lower", "0 12 er lo w", "",
         "low " * 50, "  LoW \n\t low  "]


@pytest.fixture(scope="module")
def full_vocab():
    return clip_vocab()


def _tokenizers(vocab, merges, max_length):
    return (jtok.CLIPBPETokenizer(vocab, merges, max_length=max_length),
            ttok.CLIPBPETokenizer(vocab, merges, max_length=max_length))


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("padding", ["max_length", "none"])
def test_tokenizer_ids_equal_jax(text, padding):
    jt, tt = _tokenizers(*toy_vocab(), max_length=16)
    want = jt(text, padding=padding, max_length=16).input_ids
    got = tt(text, padding=padding, max_length=16).input_ids
    assert got.dtype == np.int32 and np.array_equal(got, want)
    pt = tt(text, padding=padding, max_length=16, return_tensors="pt").input_ids
    assert pt.dtype == torch.int64 and np.array_equal(pt.numpy(), want)
    assert tt.encode(text) == jt.encode(text)
    assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text))


@pytest.mark.parametrize("text", ["a photo of a cat on a sofa, 4k", "café ÜNÏCODE 東京 🐱",
                                  "x" * 300, "it's 12'3\" tall"])
def test_tokenizer_full_size_vocab_equal_jax(full_vocab, text):
    """The generated 49,408-id vocab: unicode bytes, truncation to 77 with a
    terminal EOS, padding with EOS."""
    jt, tt = _tokenizers(*full_vocab, max_length=77)
    want = jt(text).input_ids
    got = tt(text, return_tensors="pt").input_ids
    assert got.shape == (1, 77) and np.array_equal(got.numpy(), want)
    assert int(got[0, 0]) == 49406 and 49407 in got[0].tolist()


def test_tokenizer_from_dir_equal_jax(tmp_path, full_vocab):
    write_tokenizer(str(tmp_path / "tokenizer"), *full_vocab)
    jt = jtok.CLIPBPETokenizer.from_dir(str(tmp_path))
    tt = ttok.CLIPBPETokenizer.from_dir(str(tmp_path / "tokenizer"))
    assert tt.encoder == jt.encoder and tt.bpe_ranks == jt.bpe_ranks
    assert (tt.bos_token_id, tt.eos_token_id, tt.pad_token_id) == (49406, 49407, 49407)
    for text in ("a red barn under a blue sky", "zz9 plural z alpha"):
        assert np.array_equal(tt(text).input_ids, jt(text).input_ids)


# ---------------------------------------------------------------------------
# The text model
# ---------------------------------------------------------------------------

def _configs(act):
    j = jclip.CLIPTextConfig(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                             num_attention_heads=4, intermediate_size=64, hidden_act=act)
    t = tclip.CLIPTextConfig(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                             num_attention_heads=4, intermediate_size=64, hidden_act=act)
    return j, t


def _jax_clip(cfg, seed=0):
    ids = jnp.zeros((1, 77), jnp.int32)
    return jax.jit(jclip.CLIPTextModel(cfg).init)(jax.random.PRNGKey(seed), ids)


def _port_clip(cfg, params, dtype=torch.float32):
    model = tclip.CLIPTextModel(cfg)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, params)))
    return model.to(dtype)


def _ids(n=2, seed=1):
    return np.random.default_rng(seed).integers(0, 96, size=(n, 77)).astype(np.int64)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_matches_flax_f32(act):
    jcfg, tcfg = _configs(act)
    params = _jax_clip(jcfg)
    ids = _ids()
    want = np.asarray(jclip.CLIPTextModel(jcfg).apply(params, jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got = _port_clip(tcfg, params)(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 77, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_matches_flax_bf16(act):
    jcfg, tcfg = _configs(act)
    params = _jax_clip(jcfg, seed=3)
    ids = _ids(seed=4)
    pb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want = np.asarray(jclip.CLIPTextModel(jcfg).apply(pb, jnp.asarray(ids, jnp.int32)),
                      np.float32)
    with torch.no_grad():
        got = _port_clip(tcfg, params, torch.bfloat16)(torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-2


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_clip_matches_transformers(act):
    transformers = pytest.importorskip("transformers")
    t_cfg = transformers.CLIPTextConfig(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                                        num_attention_heads=4, intermediate_size=64,
                                        max_position_embeddings=77, hidden_act=act)
    torch.manual_seed(0)
    ref = transformers.CLIPTextModel(t_cfg).eval()
    _, tcfg = _configs(act)
    state, cfg = tporting.port_torch_text_encoder(ref, cfg=tcfg)
    assert "text_model.embeddings.position_ids" not in state
    model = tclip.CLIPTextModel(cfg)
    model.load_state_dict(state)
    ids = torch.from_numpy(_ids(seed=5))
    with torch.no_grad():
        want = ref(ids).last_hidden_state
        got = model(ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=1e-4)


def test_infer_text_config_and_json_equal_jax():
    z = np.zeros
    sd = {"text_model.embeddings.token_embedding.weight": z((49408, 1024)),
          "text_model.embeddings.position_embedding.weight": z((77, 1024)),
          "text_model.encoder.layers.0.self_attn.q_proj.weight": z((1024, 1024)),
          "text_model.encoder.layers.0.mlp.fc1.weight": z((4096, 1024)),
          "text_model.encoder.layers.1.self_attn.q_proj.weight": z((1024, 1024)),
          "text_model.final_layer_norm.weight": z((1024,))}
    assert dataclasses.asdict(tclip.infer_text_config(sd)) == dataclasses.asdict(
        jclip.infer_text_config(sd))
    for js in ({"hidden_size": 1024, "num_hidden_layers": 23, "num_attention_heads": 16,
                "intermediate_size": 4096, "hidden_act": "gelu"},
               {}, {"vocab_size": 96, "hidden_size": 32, "layer_norm_eps": 1e-6}):
        assert dataclasses.asdict(tclip.config_from_json(js)) == dataclasses.asdict(
            jclip.config_from_json(js))
    assert tclip.config_from_json({"hidden_size": 1024, "num_hidden_layers": 23,
                                   "num_attention_heads": 16, "intermediate_size": 4096,
                                   "hidden_act": "gelu"}) == tclip.SD21_TEXT_CONFIG


@pytest.mark.parametrize("cfg,count", [(tclip.SD15_TEXT_CONFIG, 123_060_480),
                                       (tclip.SD21_TEXT_CONFIG, 340_387_840)])
def test_param_counts_on_meta(cfg, count):
    with torch.device("meta"):
        model = tclip.CLIPTextModel(cfg)
    assert sum(p.numel() for p in model.parameters()) == count


def test_full_width_keys_and_shapes_equal_jax_tree():
    """The SD 1.5 CLIP tree (jax.eval_shape) carried across has the port's
    state_dict keys and shapes; nothing is allocated."""
    ids = jnp.zeros((1, 77), jnp.int32)
    shapes = jax.eval_shape(lambda: jclip.CLIPTextModel(jclip.SD15_TEXT_CONFIG).init(
        jax.random.PRNGKey(0), ids))
    tree = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    sd = state_dict_from_jax(tree)
    with torch.device("meta"):
        want = tclip.CLIPTextModel(tclip.SD15_TEXT_CONFIG).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in want.items()}


def _write_text_encoder(root, params, cfg):
    te = root / "text_encoder"
    te.mkdir()
    jporting.save_safetensors(jporting.flax_to_torch_state_dict(params),
                              str(te / "model.safetensors"))
    with open(te / "config.json", "w") as f:
        json.dump({"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
                   "num_hidden_layers": cfg.num_hidden_layers,
                   "num_attention_heads": cfg.num_attention_heads,
                   "intermediate_size": cfg.intermediate_size,
                   "hidden_act": cfg.hidden_act}, f)
    write_tokenizer(str(root / "tokenizer"), *toy_vocab())


def test_load_clip_text_from_dir_matches_jax(tmp_path):
    """A text_encoder/ (written by the JAX package) + tokenizer/ directory
    loaded by both packages: the same embeddings, cached per prompt, and
    None for a directory without them."""
    jcfg = jclip.TINY_TEXT_CONFIG
    _write_text_encoder(tmp_path, jax.tree.map(np.asarray, _jax_clip(jcfg, seed=7)), jcfg)
    jenc = jporting.load_clip_text_from_dir(str(tmp_path))
    tenc = tporting.load_clip_text_from_dir(str(tmp_path), device="cpu")
    assert isinstance(tenc, tclip.NativeCLIPTextEncoder)
    assert tenc.cfg == tclip.TINY_TEXT_CONFIG and tenc.device == torch.device("cpu")
    for text in ("low", "lower", "low, lower!"):
        got = tenc(text)
        assert got.dtype == torch.float32 and tuple(got.shape) == (1, 77, 32)
        np.testing.assert_allclose(got.numpy(), np.asarray(jenc(text)), atol=2e-5, rtol=1e-4)
    e1 = tenc("low")
    assert tenc("low") is e1
    assert not torch.allclose(e1, tenc("lower"))
    assert tporting.load_clip_text_from_dir(str(tmp_path / "nope"), device="cpu") is None
    bf = tporting.load_clip_text_from_dir(str(tmp_path), dtype=torch.bfloat16, device="cpu")
    assert next(bf.model.parameters()).dtype == torch.bfloat16
    assert bf("low").dtype == torch.float32


def test_load_hf_text_encoder_from_a_local_dir(tmp_path, monkeypatch):
    """The gated transformers loader on a saved tiny CLIP (a local path, so
    nothing is fetched): float32 [1, 77, hidden] on the device, transformers'
    own output."""
    transformers = pytest.importorskip("transformers")
    from comfystereo_tpu_torch.diffusion.models import load_hf_text_encoder
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    write_tokenizer(str(tmp_path / "tok"), *toy_vocab())
    tok = transformers.CLIPTokenizer(str(tmp_path / "tok" / "vocab.json"),
                                     str(tmp_path / "tok" / "merges.txt"), model_max_length=77)
    torch.manual_seed(0)
    model = transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=77)).eval()
    tok.save_pretrained(str(tmp_path / "clip"))
    model.save_pretrained(str(tmp_path / "clip"))
    encode = load_hf_text_encoder(str(tmp_path / "clip"), device="cpu")
    got = encode("low lower")
    with torch.no_grad():
        want = model(tok(["low lower"], padding="max_length", max_length=77,
                         return_tensors="pt").input_ids).last_hidden_state
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 77, 32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
