"""CLIP text encoder in PyTorch, with the transformers state-dict layout.

Port of `comfystereo_tpu/diffusion/clip_text.py`. `CLIPTextModel`'s
`state_dict()` keys are transformers' ``text_model.*`` keys, so a
checkpoint's ``text_encoder/`` weights load with
`load_state_dict(strict=True)`, and the JAX package's flax tree carries
across with `porting.state_dict_from_jax`:

    torch  text_model.encoder.layers.0.self_attn.q_proj.weight
    flax   params/text_model/encoder/layers_0/self_attn/q_proj/kernel

Both SD text encoders:
  * SD1.x: the CLIP ViT-L/14 text tower, 12 layers x 768, 12 heads,
    quick_gelu (123,060,480 parameters);
  * SD2.x: the OpenCLIP ViT-H text tower as diffusers stores it, 23 layers
    x 1024, 16 heads, gelu (340,387,840 parameters).

Numerics follow the flax module under mixed precision: q is scaled before
the product; the attention logits are float32 products of the (bf16)
operands, the causal bias is float32's most negative value above the
diagonal, and the softmax runs in float32 before a cast to v's dtype; layer
norms take float32 statistics (`sd_unet.LayerNorm`). The 77-token causal
attention is written as explicit products: it is far below the flash
kernel's `supports` range, and the JAX package computes it with plain XLA
ops.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.caching import EmbeddingCache
from .attention import _softmax_last
from .sd_unet import LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


# SD1.x (openai/clip-vit-large-patch14 text tower)
SD15_TEXT_CONFIG = CLIPTextConfig()
# SD2.x (stabilityai/stable-diffusion-2-1 text_encoder/config.json)
SD21_TEXT_CONFIG = CLIPTextConfig(hidden_size=1024, num_hidden_layers=23,
                                  num_attention_heads=16,
                                  intermediate_size=4096, hidden_act="gelu")
# Tiny config for tests
TINY_TEXT_CONFIG = CLIPTextConfig(vocab_size=96, hidden_size=32,
                                  num_hidden_layers=2,
                                  num_attention_heads=4,
                                  intermediate_size=64)


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu
    raise ValueError(f"unsupported hidden_act: {name}")


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, x, causal_bias):
        b, n, c = x.shape
        head_dim = c // self.heads

        def split(t):
            return t.reshape(b, n, self.heads, head_dim).transpose(1, 2)

        # transformers' CLIPAttention scales q before the product.
        q = split(self.q_proj(x) * head_dim ** -0.5)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + causal_bias
        weights = _softmax_last(logits).to(v.dtype)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, n, c)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = _act(cfg.hidden_act)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x, causal_bias):
        h = x + self.self_attn(self.layer_norm1(x), causal_bias)
        return h + self.mlp(self.layer_norm2(h))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)[None, :]
        return self.token_embedding(ids) + self.position_embedding(pos)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(cfg.num_hidden_layers)])

    def forward(self, x, causal_bias):
        for layer in self.layers:
            x = layer(x, causal_bias)
        return x


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, ids):
        n = ids.shape[1]
        x = self.embeddings(ids)
        # transformers' causal mask: float32's most negative value above the
        # diagonal (the float32 softmax keeps it from overflowing).
        causal = torch.full((n, n), torch.finfo(torch.float32).min,
                            device=ids.device).triu(1)
        return self.final_layer_norm(self.encoder(x, causal))


class CLIPTextModel(nn.Module):
    """``input_ids [B, N] -> last_hidden_state [B, N, hidden]`` in the
    parameter dtype. The `text_model` level is transformers' state-dict
    prefix, so ports need no key surgery."""

    def __init__(self, cfg: CLIPTextConfig = SD15_TEXT_CONFIG):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, input_ids):
        return self.text_model(input_ids.long())


class NativeCLIPTextEncoder(EmbeddingCache):
    """Tokenizer + `CLIPTextModel` behind the text encoder's interface
    (str -> float32 [1, 77, hidden] on `device`), cached per prompt
    (`EmbeddingCache`). The model is cast to `dtype` (None keeps its own)
    and moved to `device` (None means CUDA)."""

    def __init__(self, tokenizer, model: CLIPTextModel, cfg: CLIPTextConfig,
                 dtype: Optional[torch.dtype] = None, device=None):
        from ..device import resolve_device

        super().__init__()
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.dim = cfg.hidden_size
        self.device = resolve_device(device)
        self.model = model.requires_grad_(False).eval().to(device=self.device, dtype=dtype)

    def _encode(self, text: str) -> torch.Tensor:
        ids = self.tokenizer([text], padding="max_length",
                             max_length=self.cfg.max_position_embeddings,
                             truncation=True, return_tensors="pt").input_ids
        with torch.no_grad():
            return self.model(ids.to(self.device)).float()


def infer_text_config(state_dict) -> CLIPTextConfig:
    """CLIPTextConfig from a transformers-layout state dict's shapes. The
    activation is not recoverable from shapes: 768-wide towers are the SD1.x
    CLIP (quick_gelu), wider ones OpenCLIP-derived (gelu)."""
    tok = state_dict["text_model.embeddings.token_embedding.weight"]
    pos = state_dict["text_model.embeddings.position_embedding.weight"]
    vocab, hidden = tuple(tok.shape)
    layers = 0
    while f"text_model.encoder.layers.{layers}.self_attn.q_proj.weight" in state_dict:
        layers += 1
    inter = tuple(state_dict["text_model.encoder.layers.0.mlp.fc1.weight"].shape)[0]
    heads = {768: 12, 1024: 16, 1280: 20}.get(hidden, hidden // 64)
    act = "quick_gelu" if hidden <= 768 else "gelu"
    return CLIPTextConfig(vocab_size=vocab, hidden_size=hidden,
                          num_hidden_layers=layers, num_attention_heads=heads,
                          intermediate_size=inter,
                          max_position_embeddings=tuple(pos.shape)[0], hidden_act=act)


def config_from_json(cfg_json: dict) -> CLIPTextConfig:
    """CLIPTextConfig from a transformers text_encoder/config.json dict."""
    return CLIPTextConfig(
        vocab_size=cfg_json.get("vocab_size", 49408),
        hidden_size=cfg_json.get("hidden_size", 768),
        num_hidden_layers=cfg_json.get("num_hidden_layers", 12),
        num_attention_heads=cfg_json.get("num_attention_heads", 12),
        intermediate_size=cfg_json.get("intermediate_size", 3072),
        max_position_embeddings=cfg_json.get("max_position_embeddings", 77),
        hidden_act=cfg_json.get("hidden_act", "quick_gelu"),
        layer_norm_eps=cfg_json.get("layer_norm_eps", 1e-5),
    )
