"""Checkpoint I/O, weight carry-over and model assembly.

Port of `comfystereo_tpu/diffusion/porting.py`. The port's SD modules
(`sd_unet.SDUNet`, `sd_vae.SDVAE`, `clip_text.CLIPTextModel`) use the
diffusers and transformers state-dict layouts key for key, so a checkpoint
loads with `load_state_dict` after key normalisation alone: no transposes.

* Safetensors I/O (`load_safetensors`, `save_safetensors`): the format
  parsed and written directly (8-byte little-endian header length, JSON
  header, raw little-endian buffer), with no `safetensors` package.
  bfloat16 stays bfloat16.
* `normalize_state_dict`: legacy VAE attention names (query/key/value/
  proj_attn, and their GroupNorm ``norm``) to the modern ones, [C, C, 1, 1]
  attention projections squeezed to matrices, non-parameter keys dropped.
  `check_port` holds a state dict to the module's own, built on the meta
  device, and lists every mismatch.
* The LDM/ComfyUI key maps (`ldm_unet_to_diffusers`,
  `ldm_vae_to_diffusers`), and configs inferred from shapes
  (`infer_unet_config`, `infer_vae_config`).
* `build_sd_model` builds the SD UNet and VAE at a config's full width, with
  seeded random weights or a given state dict, casts the parameters to
  `dtype` and optionally stores the UNet's large weights as w8
  (`quantize.py`), and wraps them in a `DiffusionModel` whose apply
  functions cast inputs to `dtype` at the UNet and VAE boundary and return
  float32, as the JAX package's jitted boundary does.
* `load_sd_from_diffusers_dir` loads a diffusers-layout directory (unet/,
  vae/, text_encoder/, tokenizer/) into such a bundle, with the
  checkpoint's own CLIP (`load_clip_text_from_dir`); `port_torch_unet`,
  `port_torch_vae` and `port_torch_text_encoder` take a connected torch
  module's weights in diffusers or LDM layout.
* `state_dict_from_jax` turns the JAX package's flax parameter tree (as
  numpy arrays) into the port's state dict: conv kernels HWIO -> OIHW,
  dense kernels transposed, norm `scale` and embedding tables -> `weight`
  (untransposed), and ``name_index`` module names split back into dotted
  keys, with ``linear_1``/``linear_2`` kept literal;
  `toy_state_dicts_from_jax` does the same for the JAX toy model's trees.
"""
from __future__ import annotations

import json
import math
import mmap
import os
import struct
import warnings
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .models import LATENT_SCALE, SDXL_LATENT_SCALE, DiffusionModel, HashTextEncoder
from .sd_unet import SD15_UNET_CONFIG, GraphedUNet, SDUNet, SDUNetConfig
from .sd_vae import SD_VAE_CONFIG, SDVAE, SDVAEConfig

# Module names whose trailing _<digit> is diffusers' own spelling, not a list
# index (TimestepEmbedding's linear_1 / linear_2).
_LITERAL = {"linear_1", "linear_2"}


def _torch_key(path, leaf: str) -> str:
    parts = []
    for p in path:
        head, _, idx = p.rpartition("_")
        if head and idx.isdigit() and p not in _LITERAL:
            parts.extend([head, idx])
        else:
            parts.append(p)
    return ".".join(parts + [leaf])


def _from_numpy(arr) -> torch.Tensor:
    """A tensor sharing a numpy array's memory, read-only arrays too (JAX's
    are): load it with `load_state_dict`, which copies, and write none."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(np.asarray(arr))


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax parameter tree ({'params': ...} or its inside) of numpy arrays ->
    the port's state dict (float32 tensors; bf16 leaves are widened, which is
    exact). Transposes are views of the numpy arrays: nothing is copied, and
    the tensors share the arrays' memory, often read-only (JAX's are), so
    load them with `load_state_dict`, which copies, and write none."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, path + [name])
                continue
            arr = np.asarray(child)
            if arr.dtype.name == "bfloat16":
                arr = arr.astype(np.float32)
            if name == "kernel":
                leaf = "weight"
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            elif name in ("scale", "embedding"):
                leaf = "weight"
            elif name == "bias":
                leaf = "bias"
            else:
                raise KeyError(f"state_dict_from_jax: unknown leaf {'/'.join(path + [name])}")
            out[_torch_key(path, leaf)] = _from_numpy(arr)

    walk(tree, [])
    return out


# flax auto-name prefixes of the toy modules -> the port's module lists
# (`models.py`); the VAE's Sequential layers_<i> are the torch Sequential's i.
_TOY_NAMES = {"Conv": "convs", "Dense": "dense", "GroupNorm": "norms", "LayerNorm": "norms",
              "_ResBlock": "res_blocks", "_TransformerBlock": "blocks"}


def toy_state_dicts_from_jax(unet_params: Mapping[str, Any], vae_params: Mapping[str, Any]):
    """The JAX toy model's flax trees (`make_toy_model`'s `unet_params` and
    `vae_params`, as numpy arrays) -> (UNet, VAE) state dicts of the port's
    `LatentUNet` and `SimpleVAE` (`state_dict_from_jax`, then the toy's
    module names)."""
    def rename(sd):
        return {".".join(_TOY_NAMES.get(p, p) for p in k.split(".") if p != "layers"): v
                for k, v in sd.items()}
    return rename(state_dict_from_jax(unet_params)), rename(state_dict_from_jax(vae_params))


# ---------------------------------------------------------------------------
# Safetensors I/O
# ---------------------------------------------------------------------------

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read a .safetensors file into CPU tensors of the stored dtypes. The
    tensors are views of a private (copy-on-write) mapping of the file, so
    a page is read only when a tensor is used, and once (a tensor whose
    offset is not a multiple of its item size is copied). While they live,
    replace the file rather than rewrite it in place, as
    `save_safetensors` does."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + hlen
    out: Dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dt = _SAFETENSORS_DTYPES[meta["dtype"]]
        start, end = (base + o for o in meta["data_offsets"])
        if end > len(mapped):
            raise ValueError(f"{path}: truncated safetensors file")
        itemsize = torch.empty((), dtype=dt).element_size()
        if end == start:
            t = torch.empty(0, dtype=dt)
        elif start % itemsize:
            t = torch.frombuffer(bytearray(mapped[start:end]), dtype=dt)
        else:
            t = torch.frombuffer(mapped, dtype=dt, count=(end - start) // itemsize, offset=start)
        out[name] = t.reshape(meta["shape"])
    return out


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> None:
    """Write tensors as a .safetensors file, in the format `load_safetensors`
    reads (tensors ordered by item size, largest first, then by name, so
    each offset is a multiple of its item size; header padded to 8
    bytes). The file is written beside `path` and then replaces it, so
    tensors that map the old file keep its data."""
    tensors = {k: v.detach().cpu().contiguous() for k, v in tensors.items()}
    names = {v: k for k, v in _SAFETENSORS_DTYPES.items()}
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, Any] = {}
    offset = 0
    for k in order:
        t = tensors[k]
        n = t.numel() * t.element_size()
        header[k] = {"dtype": names[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    hjson += b" " * (-len(hjson) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for k in order:
            f.write(tensors[k].reshape(-1).view(torch.uint8).numpy().data)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Key normalisation and shape checks
# ---------------------------------------------------------------------------

# Legacy diffusers VAE attention naming -> modern (pre-0.18 checkpoints).
# Legacy "attentions.N.norm" also maps to group_norm, but only inside VAE
# attention blocks (see normalize_torch_key): the UNet's Transformer2D owns
# a GroupNorm legitimately named "norm".
_LEGACY_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v",
                "proj_attn": "to_out.0"}


def normalize_torch_key(key: str, legacy_vae_attn: bool = False) -> str:
    """Map legacy attention naming onto the modern layout. `legacy_vae_attn`
    is a state-dict-level property (any ``.query.`` key present): legacy VAE
    attention blocks also named their GroupNorm "norm", which becomes
    "group_norm" only then."""
    parts = [_LEGACY_ATTN.get(p, p) for p in key.split(".")]
    if legacy_vae_attn and "attentions" in key:
        parts = ["group_norm" if p == "norm" else p for p in parts]
    return ".".join(parts)


def _is_attention_projection(parts) -> bool:
    return parts[-2] in ("to_q", "to_k", "to_v") or parts[-3:-1] == ["to_out", "0"]


def normalize_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A torch state dict (tensors or numpy arrays) in the port's layout:
    legacy attention keys renamed (`normalize_torch_key`), [C, C, 1, 1]
    attention projections (legacy LDM/ComfyUI VAEs store them as 1x1 convs)
    squeezed to [C, C], and every key that is not a parameter dropped
    (``position_ids``, ``num_batches_tracked``, weights of a rank other than
    1, 2 or 4): the rank rules of the JAX package's `torch_to_flax_params`."""
    legacy = any(".query." in k for k in state_dict)
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        key = normalize_torch_key(key, legacy)
        t = value if isinstance(value, torch.Tensor) else _from_numpy(value)
        parts = key.split(".")
        if parts[-1] == "weight":
            if (t.dim() == 4 and tuple(t.shape[-2:]) == (1, 1) and len(parts) >= 3
                    and _is_attention_projection(parts)):
                t = t[:, :, 0, 0]
            if t.dim() not in (1, 2, 4):
                continue
        elif parts[-1] != "bias":
            continue
        out[key] = t
    return out


def check_port(reference_params: Mapping[str, Any], ported_params: Mapping[str, Any]) -> None:
    """Raise ValueError listing every key missing from or unexpected in
    `ported_params`, and every shape that differs from `reference_params`'
    (the module's own state dict, e.g. built on the meta device)."""
    ref = {k: tuple(v.shape) for k, v in reference_params.items()}
    got = {k: tuple(v.shape) for k, v in ported_params.items()}
    problems = []
    for k in sorted(set(ref) | set(got)):
        if k not in got:
            problems.append(f"missing in port: {k} {ref[k]}")
        elif k not in ref:
            problems.append(f"unexpected in port: {k} {got[k]}")
        elif ref[k] != got[k]:
            problems.append(f"shape mismatch {k}: model {ref[k]} vs checkpoint {got[k]}")
    if problems:
        raise ValueError("checkpoint port mismatch:\n  " + "\n  ".join(problems[:50])
                         + ("" if len(problems) <= 50 else
                            f"\n  ... and {len(problems) - 50} more"))


def _meta_state(cls, cfg) -> Dict[str, torch.Tensor]:
    """`cls(cfg).state_dict()` built on the meta device (shapes, no memory)."""
    with torch.device("meta"):
        return cls(cfg).state_dict()


def _empty_module(cls, cfg) -> torch.nn.Module:
    """`cls(cfg)` with uninitialised CPU parameters (no default init: every
    parameter is then loaded or drawn)."""
    with torch.device("meta"):
        module = cls(cfg)
    return module.to_empty(device="cpu")


# ---------------------------------------------------------------------------
# LDM / ComfyUI checkpoint layout -> diffusers layout
# ---------------------------------------------------------------------------

_LDM_RESNET = {"in_layers.0": "norm1", "in_layers.2": "conv1",
               "emb_layers.1": "time_emb_proj", "out_layers.0": "norm2",
               "out_layers.3": "conv2", "skip_connection": "conv_shortcut"}
_LDM_VAE_RESNET = {"norm1": "norm1", "conv1": "conv1", "norm2": "norm2",
                   "conv2": "conv2", "nin_shortcut": "conv_shortcut"}
_LDM_VAE_ATTN = {"norm": "group_norm", "q": "to_q", "k": "to_k",
                 "v": "to_v", "proj_out": "to_out.0"}


def _map_ldm_resnet(rest: str) -> str:
    for old, new in _LDM_RESNET.items():
        if rest.startswith(old + "."):
            return new + rest[len(old):]
    return rest


def ldm_unet_to_diffusers(state_dict: Mapping[str, Any],
                          num_blocks: int = 4, layers_per_block: int = 2
                          ) -> Dict[str, Any]:
    """Convert an LDM/ComfyUI `UNetModel` state_dict (input_blocks /
    middle_block / output_blocks naming, as ComfyUI's diffusion_model
    exposes) to the diffusers key layout the port consumes (the public
    diffusers conversion convention).
    """
    out: Dict[str, Any] = {}
    per = layers_per_block + 1
    for key, v in state_dict.items():
        if key.startswith("model.diffusion_model."):
            key = key[len("model.diffusion_model."):]
        if key.startswith("time_embed.0."):
            out["time_embedding.linear_1." + key.split(".", 2)[2]] = v
        elif key.startswith("time_embed.2."):
            out["time_embedding.linear_2." + key.split(".", 2)[2]] = v
        elif key.startswith("input_blocks.0.0."):
            out["conv_in." + key[len("input_blocks.0.0."):]] = v
        elif key.startswith("input_blocks."):
            parts = key.split(".")
            n, mod = int(parts[1]), parts[2]
            rest = ".".join(parts[3:])
            blk, j = (n - 1) // per, (n - 1) % per
            if j == layers_per_block:  # downsampler slot
                out[f"down_blocks.{blk}.downsamplers.0.conv."
                    + rest.replace("op.", "")] = v
            elif mod == "0":
                out[f"down_blocks.{blk}.resnets.{j}."
                    + _map_ldm_resnet(rest)] = v
            else:
                out[f"down_blocks.{blk}.attentions.{j}." + rest] = v
        elif key.startswith("middle_block."):
            parts = key.split(".")
            mod = parts[1]
            rest = ".".join(parts[2:])
            if mod == "0":
                out["mid_block.resnets.0." + _map_ldm_resnet(rest)] = v
            elif mod == "1":
                out["mid_block.attentions.0." + rest] = v
            else:
                out["mid_block.resnets.1." + _map_ldm_resnet(rest)] = v
        elif key.startswith("output_blocks."):
            parts = key.split(".")
            n, mod = int(parts[1]), parts[2]
            rest = ".".join(parts[3:])
            blk, j = n // per, n % per
            if mod == "0":
                out[f"up_blocks.{blk}.resnets.{j}."
                    + _map_ldm_resnet(rest)] = v
            elif rest.startswith("conv.") or ".conv." in f".{rest}":
                out[f"up_blocks.{blk}.upsamplers.0." + rest] = v
            else:
                out[f"up_blocks.{blk}.attentions.{j}." + rest] = v
        elif key.startswith("out.0."):
            out["conv_norm_out." + key[len("out.0."):]] = v
        elif key.startswith("out.2."):
            out["conv_out." + key[len("out.2."):]] = v
        # label_emb and friends (SDXL-only) are skipped.
    return out


def ldm_vae_to_diffusers(state_dict: Mapping[str, Any],
                         num_blocks: Optional[int] = None) -> Dict[str, Any]:
    """Convert an LDM/ComfyUI AutoencoderKL state_dict (encoder.down /
    decoder.up naming) to the diffusers layout. Decoder up-block order is
    REVERSED between the two conventions; the block count is inferred from
    the highest up/down index when not given (SD VAEs use 4)."""
    out: Dict[str, Any] = {}
    if num_blocks is None:
        stripped = [k.split("first_stage_model.")[-1] for k in state_dict]
        idx = [int(k.split(".")[2]) for k in stripped
               if k.startswith(("encoder.down.", "decoder.up."))]
        num_blocks = max(idx) + 1 if idx else 4

    def attn(rest: str) -> str:
        head = rest.split(".", 1)
        return _LDM_VAE_ATTN.get(head[0], head[0]) + (
            "." + head[1] if len(head) > 1 else "")

    def resnet(rest: str) -> str:
        head, _, tail = rest.partition(".")
        return _LDM_VAE_RESNET.get(head, head) + ("." + tail if tail else "")

    for key, v in state_dict.items():
        if key.startswith("first_stage_model."):
            key = key[len("first_stage_model."):]
        parts = key.split(".")
        if key.startswith(("quant_conv.", "post_quant_conv.")):
            out[key] = v
        elif parts[0] in ("encoder", "decoder"):
            side = parts[0]
            if parts[1] == "conv_in" or parts[1] == "conv_out":
                out[key] = v
            elif parts[1] == "norm_out":
                out[f"{side}.conv_norm_out." + ".".join(parts[2:])] = v
            elif parts[1] == "mid":
                mod = parts[2]
                rest = ".".join(parts[3:])
                name = {"block_1": "resnets.0", "attn_1": "attentions.0",
                        "block_2": "resnets.1"}[mod]
                mapped = attn(rest) if mod == "attn_1" else resnet(rest)
                out[f"{side}.mid_block.{name}." + mapped] = v
            elif parts[1] == "down":
                i = int(parts[2])
                if parts[3] == "downsample":
                    out[f"encoder.down_blocks.{i}.downsamplers.0."
                        + ".".join(parts[4:])] = v
                else:
                    j = int(parts[4])
                    out[f"encoder.down_blocks.{i}.resnets.{j}."
                        + resnet(".".join(parts[5:]))] = v
            elif parts[1] == "up":
                i = num_blocks - 1 - int(parts[2])  # reversed order
                if parts[3] == "upsample":
                    out[f"decoder.up_blocks.{i}.upsamplers.0."
                        + ".".join(parts[4:])] = v
                else:
                    j = int(parts[4])
                    out[f"decoder.up_blocks.{i}.resnets.{j}."
                        + resnet(".".join(parts[5:]))] = v
    return out


def looks_like_ldm(state_dict: Mapping[str, Any]) -> bool:
    return any(k.startswith(("input_blocks.", "model.diffusion_model.",
                             "middle_block."))
               for k in state_dict)


def _depth(diffusers_sd: Mapping[str, Any], prefix: str) -> int:
    """Transformer blocks of the spatial transformer at `prefix` (1 where
    the state dict holds none of its keys)."""
    k = 0
    while any(key.startswith(f"{prefix}.transformer_blocks.{k}.") for key in diffusers_sd):
        k += 1
    return max(k, 1)


def infer_unet_config(diffusers_sd: Mapping[str, Any]) -> SDUNetConfig:
    """SDUNetConfig from a diffusers-layout state dict's shapes: the levels
    with attention and each one's transformer depth (the deepest level's
    from the mid block where it has none), linear or 1x1-conv projections
    by the rank of proj_in, and SDXL's text-time conditioning where
    `add_embedding` is present. Head counts are not recoverable from
    shapes: SD1.x uses 8 heads, SD2.x (1024-d context) and SDXL 64-d heads;
    nor is SDXL's time-id sinusoid width, 256."""
    def shape(k):
        return tuple(diffusers_sd[k].shape)

    in_ch = shape("conv_in.weight")[1]
    blocks = []
    i = 0
    while f"down_blocks.{i}.resnets.0.conv1.weight" in diffusers_sd:
        blocks.append(shape(f"down_blocks.{i}.resnets.0.conv1.weight")[0])
        i += 1
    n = len(blocks)
    layers = 0
    while f"down_blocks.0.resnets.{layers}.conv1.weight" in diffusers_sd:
        layers += 1
    attn = [any(k.startswith(f"down_blocks.{i}.attentions.") for k in diffusers_sd)
            for i in range(n)]
    depths = [_depth(diffusers_sd, f"down_blocks.{i}.attentions.0") if attn[i] else 1
              for i in range(n)]
    if not attn[-1]:
        depths[-1] = _depth(diffusers_sd, "mid_block.attentions.0")
    first = f"down_blocks.{attn.index(True)}.attentions.0"
    ctx = shape(f"{first}.transformer_blocks.0.attn2.to_k.weight")[1]
    text_time = "add_embedding.linear_1.weight" in diffusers_sd
    heads = tuple(ch // 64 for ch in blocks) if ctx >= 1024 or text_time else 8
    sd1_levels = attn == [i < n - 1 for i in range(n)]
    proj_in = diffusers_sd.get(f"{first}.proj_in.weight")
    return SDUNetConfig(
        in_channels=in_ch, out_channels=shape("conv_out.weight")[0],
        block_out_channels=tuple(blocks), layers_per_block=layers,
        cross_attention_dim=ctx, attention_head_dim=heads,
        down_block_types=None if sd1_levels else tuple(
            "CrossAttnDownBlock2D" if a else "DownBlock2D" for a in attn),
        transformer_layers_per_block=1 if set(depths) == {1} else tuple(depths),
        use_linear_projection=proj_in is not None and len(proj_in.shape) == 2,
        addition_embed_type="text_time" if text_time else None,
        addition_time_embed_dim=256 if text_time else None,
        projection_class_embeddings_input_dim=(
            shape("add_embedding.linear_1.weight")[1] if text_time else None))


def infer_vae_config(diffusers_sd: Mapping[str, Any]) -> SDVAEConfig:
    blocks = []
    i = 0
    while f"encoder.down_blocks.{i}.resnets.0.conv1.weight" in diffusers_sd:
        blocks.append(tuple(diffusers_sd[f"encoder.down_blocks.{i}.resnets.0.conv1.weight"]
                            .shape)[0])
        i += 1
    layers = 0
    while f"encoder.down_blocks.0.resnets.{layers}.conv1.weight" in diffusers_sd:
        layers += 1
    lat = tuple(diffusers_sd["post_quant_conv.weight"].shape)[1]
    return SDVAEConfig(block_out_channels=tuple(blocks), layers_per_block=layers,
                       latent_channels=lat)


# ---------------------------------------------------------------------------
# Model assembly
# ---------------------------------------------------------------------------

def random_init_(module: torch.nn.Module, seed: int) -> None:
    """Seeded random weights, drawn on the CPU in parameter order so a seed
    gives the same weights on every device: matrix and conv weights
    N(0, 1/fan_in) (flax's lecun-normal scale, which keeps activations of
    order one through the residual stack), biases 0, norm scales 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2:
                std = 1.0 / math.sqrt(math.prod(p.shape[1:]))
                p.copy_(torch.randn(p.shape, generator=gen) * std)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)


def build_sd_model(unet_cfg=None, vae_cfg=None, dtype: torch.dtype = torch.float32,
                   seed: int = 0, device: DeviceLike = None,
                   unet_state: Optional[Mapping[str, torch.Tensor]] = None,
                   vae_state: Optional[Mapping[str, torch.Tensor]] = None,
                   text_encode: Optional[Callable] = None,
                   weight_quant: bool = False, init_mode: str = "random",
                   pooled_encode: Optional[Callable] = None) -> DiffusionModel:
    """Assemble a `DiffusionModel` from `SDUNet` and `SDVAE`.

    Weights: the given state dicts (e.g. from `state_dict_from_jax` or a
    checkpoint), else seeded random weights (`random_init_`, UNet from
    `seed`, VAE from `seed + 1`), or zeros with init_mode="zeros" (the JAX
    package's mode for shape and speed checks). Parameters are cast to `dtype`; the apply
    functions cast their inputs to `dtype` and return float32, so
    `dtype=torch.bfloat16` is the JAX package's mixed-precision mode
    (scheduler math, masks and the latent scale stay float32). With
    `weight_quant` the UNet's large matrix and conv weights are stored as
    w8 after the cast (`quantize.quantize_module_`): half the bytes of
    bf16, the same API; a UNet quantised further by the caller keeps its
    w8 layers. `unet_apply` is a `sd_unet.GraphedUNet`: on a card, a call
    that needs no gradient replays a CUDA graph of the UNet's forward.
    `device=None` means CUDA. A UNet with text-time conditioning (SDXL)
    gives the bundle SDXL's latent scale, 0.13025 (any other SD's is
    0.18215), and its pooled text embeddings come from `pooled_encode`
    (prompt -> [1, pooled]), by default a hash stub as the text
    embeddings' `HashTextEncoder`.
    """
    if init_mode not in ("random", "zeros"):
        raise ValueError(f"build_sd_model: init_mode {init_mode!r} not in ('random', 'zeros')")
    dev = resolve_device(device)
    unet_cfg = unet_cfg or SD15_UNET_CONFIG
    vae_cfg = vae_cfg or SD_VAE_CONFIG
    unet, vae = _empty_module(SDUNet, unet_cfg), _empty_module(SDVAE, vae_cfg)
    for module, state, s in ((unet, unet_state, seed), (vae, vae_state, seed + 1)):
        if state is None and init_mode == "zeros":
            with torch.no_grad():
                for p in module.parameters():
                    p.zero_()
        elif state is None:
            random_init_(module, s)
        else:
            module.load_state_dict(state)
        module.requires_grad_(False).eval().to(device=dev, dtype=dtype)
    if weight_quant:
        from .quantize import quantize_module_
        quantize_module_(unet, dtype)
    if unet_cfg.text_time and pooled_encode is None:
        stub = HashTextEncoder(dim=unet_cfg.pooled_dim, max_length=1, device=dev)
        pooled_encode = lambda text: stub(text)[:, 0]  # noqa: E731

    return DiffusionModel(
        unet_apply=GraphedUNet(unet, dtype),
        vae_encode=lambda x: vae.encode(x.to(dtype)).float(),
        vae_decode=lambda z: vae.decode(z.to(dtype)).float(),
        text_encode=text_encode or HashTextEncoder(
            dim=unet_cfg.cross_attention_dim, device=dev),
        device=dev,
        latent_channels=vae_cfg.latent_channels,
        context_dim=unet_cfg.cross_attention_dim,
        unet_in_channels=unet_cfg.in_channels,
        unet=unet, vae=vae,
        latent_scale=SDXL_LATENT_SCALE if unet_cfg.text_time else LATENT_SCALE,
        pooled_encode=pooled_encode if unet_cfg.text_time else None)


def _find_safetensors(d: str, names=("diffusion_pytorch_model.safetensors",
                                     "model.safetensors")) -> Optional[str]:
    for name in names:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    return None


def load_sd_from_diffusers_dir(model_dir: str, unet_cfg=None, vae_cfg=None,
                               text_encode: Optional[Callable] = None,
                               dtype: Optional[torch.dtype] = None,
                               device: DeviceLike = None) -> DiffusionModel:
    """Load a diffusers-layout directory (unet/ + vae/ + text_encoder/ +
    tokenizer/) into a `build_sd_model` bundle on `device` (None means
    CUDA), in `dtype` (None: float32), each state dict checked against its
    module's own. Configs are inferred from the shapes unless given. A
    caller's `text_encode` conditions the prompts in place of the
    directory's CLIP, which is then not read; otherwise the checkpoint's own
    CLIP and BPE vocab do, and the `HashTextEncoder` stand-in is used only
    when the directory lacks text_encoder/ or tokenizer/."""
    def load(sub):
        path = _find_safetensors(os.path.join(model_dir, sub))
        if path is None:
            raise FileNotFoundError(f"no safetensors found under {os.path.join(model_dir, sub)}")
        return load_safetensors(path)

    dev = resolve_device(device)
    unet_sd, vae_sd = load("unet"), load("vae")
    unet_cfg = unet_cfg or infer_unet_config(unet_sd)
    vae_cfg = vae_cfg or infer_vae_config(vae_sd)
    unet_sd, vae_sd = normalize_state_dict(unet_sd), normalize_state_dict(vae_sd)
    check_port(_meta_state(SDUNet, unet_cfg), unet_sd)
    check_port(_meta_state(SDVAE, vae_cfg), vae_sd)

    if text_encode is None:
        text_encode = load_clip_text_from_dir(model_dir, dtype=dtype, device=dev)
        if text_encode is None:
            print(f"[comfystereo-tpu] {model_dir} has no text_encoder/ + "
                  "tokenizer/; prompts fall back to the hash-stub embedding")
    return build_sd_model(unet_cfg, vae_cfg, dtype=dtype or torch.float32, device=dev,
                          unet_state=unet_sd, vae_state=vae_sd, text_encode=text_encode)


def _module_state(module) -> Dict[str, torch.Tensor]:
    """A module's state dict where it lives: nothing is copied until the
    keys and shapes are checked (`load_state_dict` then copies)."""
    return {k: v.detach() for k, v in module.state_dict().items()}


def port_torch_unet(unet_module, cfg=None):
    """torch UNet module (diffusers or LDM/ComfyUI layout) -> (the port's
    state dict, SDUNetConfig), shape-checked. The weights then run in the
    port's `SDUNet`, so null-text optimisation differentiates through them
    (and through the flash kernel). Head counts are not recoverable from
    shapes: pass `cfg` for layouts other than SD1's and SD2's."""
    sd = _module_state(unet_module)
    if looks_like_ldm(sd):
        sd = ldm_unet_to_diffusers(sd, layers_per_block=2)  # SD1/SD2 topology
    cfg = cfg or infer_unet_config(sd)
    sd = normalize_state_dict(sd)
    check_port(_meta_state(SDUNet, cfg), sd)
    return sd, cfg


def port_torch_vae(vae_module, cfg=None):
    """torch VAE module (diffusers or LDM layout) -> (the port's state dict,
    SDVAEConfig), shape-checked."""
    sd = _module_state(vae_module)
    if any(k.startswith(("encoder.down.", "decoder.up.", "first_stage_model.")) for k in sd):
        sd = ldm_vae_to_diffusers(sd)
    cfg = cfg or infer_vae_config(sd)
    sd = normalize_state_dict(sd)
    check_port(_meta_state(SDVAE, cfg), sd)
    return sd, cfg


def _strip_to_text_model(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Normalise nested text-encoder prefixes (ComfyUI wraps the CLIP tower
    as cond_stage_model.transformer.text_model..., transformers as
    text_model...) down to the bare ``text_model.`` layout."""
    out = {}
    for k, v in state_dict.items():
        i = k.find("text_model.")
        if i >= 0:
            out[k[i:]] = v
    return out


def port_text_encoder_state(state_dict: Mapping[str, Any], cfg=None):
    """transformers/ComfyUI CLIP text state dict -> (the port's state dict,
    CLIPTextConfig), shape-checked against `CLIPTextModel`'s own."""
    from .clip_text import CLIPTextModel, infer_text_config

    sd = _strip_to_text_model(state_dict)
    if not sd:
        raise ValueError("no text_model.* keys found in state_dict")
    cfg = cfg or infer_text_config(sd)
    sd = normalize_state_dict(sd)
    check_port(_meta_state(CLIPTextModel, cfg), sd)
    return sd, cfg


def port_torch_text_encoder(text_module, cfg=None):
    """torch CLIPTextModel (or any module wrapping one) -> (the port's state
    dict, CLIPTextConfig)."""
    return port_text_encoder_state(_module_state(text_module), cfg=cfg)


def clip_text_model(state: Mapping[str, torch.Tensor], cfg) -> torch.nn.Module:
    """A `CLIPTextModel(cfg)` holding `state` (float32 CPU parameters)."""
    from .clip_text import CLIPTextModel

    model = _empty_module(CLIPTextModel, cfg)
    model.load_state_dict(state)
    return model


def load_clip_text_from_dir(model_dir: str, dtype: Optional[torch.dtype] = None,
                            device: DeviceLike = None):
    """A `NativeCLIPTextEncoder` from a diffusers directory's
    ``text_encoder/`` + ``tokenizer/`` (no transformers), on `device` (None
    means CUDA), in `dtype` (None: the stored dtype, as the JAX package
    keeps the loaded arrays'). None when either piece is absent."""
    from .clip_text import NativeCLIPTextEncoder, config_from_json
    from .clip_tokenizer import CLIPBPETokenizer

    te_dir = os.path.join(model_dir, "text_encoder")
    st_path = _find_safetensors(te_dir, ("model.safetensors",
                                         "diffusion_pytorch_model.safetensors"))
    tok_dir = os.path.join(model_dir, "tokenizer")
    if st_path is None or not os.path.exists(os.path.join(tok_dir, "vocab.json")):
        return None
    sd = load_safetensors(st_path)
    cfg = None
    cfg_path = os.path.join(te_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path, encoding="utf-8") as f:
            cfg = config_from_json(json.load(f))
    state, cfg = port_text_encoder_state(sd, cfg=cfg)
    stored = state["text_model.embeddings.token_embedding.weight"].dtype
    tokenizer = CLIPBPETokenizer.from_dir(tok_dir, max_length=cfg.max_position_embeddings)
    return NativeCLIPTextEncoder(tokenizer, clip_text_model(state, cfg), cfg,
                                 dtype=dtype or stored, device=device)
