"""Pure-Python CLIP BPE tokenizer (no transformers dependency).

Port of `comfystereo_tpu/diffusion/clip_tokenizer.py`, which imports no
JAX; the port keeps its own copy. It reads a diffusers checkpoint's own
``tokenizer/vocab.json`` + ``tokenizer/merges.txt`` and implements CLIP's
byte-level BPE: lowercasing, whitespace cleanup, the CLIP word pattern,
``</w>`` end-of-word merges, BOS 49406 / EOS 49407, truncation to 77 with a
terminal EOS, and padding with EOS (CLIP's pad token is <|endoftext|>).

Host-side by design: tokenization is string processing that happens once per
prompt; the embedding lookup onward runs on the device (`clip_text.py`).
`return_tensors="pt"` gives int64 `input_ids`, as transformers does;
`"np"` gives int32, as the JAX package does.
"""
from __future__ import annotations

import functools
import html
import json
import os
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

BOS_TOKEN = "<|startoftext|>"
EOS_TOKEN = "<|endoftext|>"


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte -> printable-unicode map (keeps the BPE
    vocab free of control characters)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _basic_clean(text: str) -> str:
    # CLIP additionally runs ftfy; double html-unescape covers the common
    # mojibake-free case without the extra dependency.
    return html.unescape(html.unescape(text)).strip()


def _word_pattern():
    """CLIP's token pattern. Uses the `regex` module's unicode classes when
    available; the `re` fallback maps \\p{L} -> [^\\W\\d_] and \\p{N} -> \\d
    (equivalent for all practical prompt text)."""
    try:
        import regex

        return regex.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", regex.IGNORECASE)
    except ImportError:
        return re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
            r"|[^\W\d_]+|\d|[^\s\w]+", re.IGNORECASE | re.UNICODE)


class CLIPBPETokenizer:
    """Byte-level BPE with CLIP's ``</w>`` end-of-word convention.

    `__call__` mirrors the transformers CLIPTokenizer call signature the
    adapters already use (padding="max_length", truncation, return_tensors),
    so it drops into every text_encode path unchanged.
    """

    model_max_length = 77

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]],
                 max_length: int = 77):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.model_max_length = max_length
        self.bos_token_id = self.encoder.get(BOS_TOKEN, 49406)
        self.eos_token_id = self.encoder.get(EOS_TOKEN, 49407)
        # CLIP pads with <|endoftext|> (reference model_wrappers.py:214-236)
        self.pad_token_id = self.eos_token_id
        self._cache = {BOS_TOKEN: BOS_TOKEN, EOS_TOKEN: EOS_TOKEN}
        self._pat = _word_pattern()

    # -- construction -------------------------------------------------------

    @classmethod
    def from_dir(cls, path: str, max_length: int = 77) -> "CLIPBPETokenizer":
        """Load from a diffusers `tokenizer/` directory (vocab.json +
        merges.txt); `path` may be the model root or the tokenizer dir."""
        d = path
        if not os.path.exists(os.path.join(d, "vocab.json")):
            d = os.path.join(path, "tokenizer")
        with open(os.path.join(d, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(d, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = []
        for line in lines:
            line = line.strip()
            if not line or line.startswith("#version"):
                continue
            parts = line.split()
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
        return cls(vocab, merges, max_length=max_length)

    # -- BPE ----------------------------------------------------------------

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Text -> BPE ids (no special tokens, no padding)."""
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for token in self._pat.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    # -- transformers-compatible call --------------------------------------

    def __call__(self, texts, padding: str = "max_length",
                 max_length: int = None, truncation: bool = True,
                 return_tensors: str = "np"):
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        rows = []
        for text in texts:
            ids = self.encode(text)
            if truncation:
                ids = ids[:max_length - 2]
            row = [self.bos_token_id] + ids + [self.eos_token_id]
            if padding == "max_length" and len(row) < max_length:
                row = row + [self.pad_token_id] * (max_length - len(row))
            rows.append(row)
        input_ids = np.asarray(rows, dtype=np.int32)

        class _Batch(dict):
            @property
            def input_ids(self):
                return self["input_ids"]

        if return_tensors == "pt":
            return _Batch(input_ids=torch.from_numpy(input_ids.astype(np.int64)))
        return _Batch(input_ids=input_ids)
