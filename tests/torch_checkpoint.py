"""Seeded diffusers-layout SD checkpoints for the port's tests and chip_smoke.py.

No real checkpoint or CLIP vocabulary is in the repository, so these helpers
write one: `write_sd_dir` draws a UNet, a VAE and a CLIP text tower with
`porting.random_init_`'s rule from a seed and writes them as a diffusers
directory (unet/, vae/, text_encoder/ with config.json and safetensors,
tokenizer/ with vocab.json and merges.txt) with the port's own safetensors
writer. The vocabulary is either the toy BPE vocab of
tests/test_clip_text.py or `clip_vocab()`, generated at the real CLIP size:
49,408 ids, the 256 byte symbols and their ``</w>`` forms, 48,894 generated
merges, BOS 49406 and EOS 49407.

Imports the port and torch only (chip_smoke.py loads it by path).
"""
from __future__ import annotations

import dataclasses
import json
import os
import string
import time

import torch

from comfystereo_tpu_torch.diffusion import porting
from comfystereo_tpu_torch.diffusion.clip_text import CLIPTextModel
from comfystereo_tpu_torch.diffusion.clip_tokenizer import (BOS_TOKEN, EOS_TOKEN,
                                                            bytes_to_unicode)
from comfystereo_tpu_torch.diffusion.sd_unet import SDUNet
from comfystereo_tpu_torch.diffusion.sd_vae import SDVAE

CLIP_VOCAB_SIZE = 49408


def toy_vocab():
    """The toy vocab and merges of tests/test_clip_text.py:_toy_tokenizer:
    single characters and their </w> forms, the low/lower merge chain and
    the two specials."""
    vocab = {}
    for c in "abcdefghijklmnopqrstuvwxyz .,!0123456789":
        vocab.setdefault(c, len(vocab))
        vocab.setdefault(c + "</w>", len(vocab))
    for tok in ["lo", "low", "low</w>", "er</w>", "we", "wer</w>", BOS_TOKEN, EOS_TOKEN]:
        vocab.setdefault(tok, len(vocab))
    merges = [("l", "o"), ("lo", "w</w>"), ("lo", "w"), ("e", "r</w>")]
    vocab.setdefault("low</w>", len(vocab))
    vocab.setdefault("w</w>", len(vocab))
    return vocab, merges


def clip_vocab():
    """A vocab laid out as CLIP's: the byte symbols, their </w> forms, one
    id per merge, then BOS 49406 and EOS 49407. The merges join pairs of
    letters and digits (with and without </w>), then such a pair with a
    final symbol, until the vocab holds 49,408 ids."""
    symbols = list(bytes_to_unicode().values())
    alnum = string.ascii_lowercase + string.digits
    merges = [(a, b + "</w>") for a in alnum for b in alnum]
    merges += [(a, b) for a in alnum for b in alnum]
    n_merges = CLIP_VOCAB_SIZE - 2 * len(symbols) - 2
    merges += [(a + b, c + "</w>") for a in alnum for b in alnum
               for c in alnum][:n_merges - len(merges)]
    tokens = symbols + [s + "</w>" for s in symbols] + ["".join(m) for m in merges]
    tokens += [BOS_TOKEN, EOS_TOKEN]
    vocab = {t: i for i, t in enumerate(tokens)}
    assert len(vocab) == CLIP_VOCAB_SIZE and vocab[EOS_TOKEN] == 49407
    return vocab, merges


def write_tokenizer(tok_dir: str, vocab, merges) -> None:
    os.makedirs(tok_dir, exist_ok=True)
    with open(os.path.join(tok_dir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(tok_dir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")


def seeded_state(cls, cfg, seed: int):
    """`cls(cfg)`'s state dict with `random_init_(seed)` weights (float32)."""
    module = porting._empty_module(cls, cfg)
    porting.random_init_(module, seed)
    return module.state_dict()


def _unet_config(cfg):
    n = len(cfg.block_out_channels)
    heads = cfg.attention_head_dim
    return {"_class_name": "UNet2DConditionModel", "in_channels": cfg.in_channels,
            "out_channels": cfg.out_channels,
            "block_out_channels": list(cfg.block_out_channels),
            "layers_per_block": cfg.layers_per_block,
            "cross_attention_dim": cfg.cross_attention_dim,
            "attention_head_dim": list(heads) if isinstance(heads, tuple) else heads,
            "norm_num_groups": cfg.norm_num_groups, "sample_size": 64,
            "down_block_types": ["CrossAttnDownBlock2D"] * (n - 1) + ["DownBlock2D"],
            "up_block_types": ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * (n - 1)}


def _vae_config(cfg):
    return {"_class_name": "AutoencoderKL", **dataclasses.asdict(cfg),
            "block_out_channels": list(cfg.block_out_channels), "sample_size": 512}


def write_sd_dir(path: str, unet_cfg, vae_cfg, text_cfg, vocab_merges, seed: int = 0,
                 dtype: torch.dtype = torch.float16, share_from: str = None):
    """Write a diffusers-layout directory: the UNet drawn from `seed`, the
    VAE from seed + 1, the text tower from seed + 2, stored in `dtype`.
    With `share_from` (a directory this function wrote), vae/,
    text_encoder/ and tokenizer/ are hard links to its files.
    Returns ({"unet", "vae", "text_encoder": the stored state dicts, None
    where shared}, bytes written, seconds)."""
    t0 = time.perf_counter()
    states, written = {}, 0
    parts = (("unet", SDUNet, unet_cfg, seed, "diffusion_pytorch_model", _unet_config),
             ("vae", SDVAE, vae_cfg, seed + 1, "diffusion_pytorch_model", _vae_config),
             ("text_encoder", CLIPTextModel, text_cfg, seed + 2, "model",
              lambda c: {"architectures": ["CLIPTextModel"], **dataclasses.asdict(c)}))
    for sub, cls, cfg, s, stem, config in parts:
        d = os.path.join(path, sub)
        os.makedirs(d, exist_ok=True)
        files = (f"{stem}.safetensors", "config.json")
        if share_from is not None and sub != "unet":
            for name in files:
                os.link(os.path.join(share_from, sub, name), os.path.join(d, name))
            states[sub] = None
            continue
        state = {k: v.to(dtype) for k, v in seeded_state(cls, cfg, s).items()}
        porting.save_safetensors(state, os.path.join(d, files[0]))
        with open(os.path.join(d, files[1]), "w", encoding="utf-8") as f:
            json.dump(config(cfg), f)
        written += sum(os.path.getsize(os.path.join(d, n)) for n in files)
        states[sub] = state
    tok_dir = os.path.join(path, "tokenizer")
    if share_from is not None:
        os.makedirs(tok_dir, exist_ok=True)
        for name in ("vocab.json", "merges.txt"):
            os.link(os.path.join(share_from, "tokenizer", name), os.path.join(tok_dir, name))
    else:
        write_tokenizer(tok_dir, *vocab_merges)
        written += sum(os.path.getsize(os.path.join(tok_dir, n))
                       for n in ("vocab.json", "merges.txt"))
    with open(os.path.join(path, "model_index.json"), "w", encoding="utf-8") as f:
        json.dump({"_class_name": "StableDiffusionPipeline"}, f)
    return states, written, time.perf_counter() - t0
