"""The port's public surface against the JAX package's, name by name and
argument by argument.

Every module of `comfystereo_tpu` has a counterpart of the same dotted name
in `comfystereo_tpu_torch`, except the Pallas package, whose counterpart is
`kernels/` (`PALLAS`: each Pallas entry and the wrapper of its CUDA kernel;
the kernels' own tests hold their contracts). For every public function and
class that a JAX module defines, the port's counterpart must exist and
accept every parameter name of the JAX signature. The exceptions are
JAX-only by design and listed in `JAX_ONLY`, each with its reason; besides
them only `parent` and `name`, the fields flax gives every flax module (its
place in flax's module tree), are not asked of a torch module. Each
subpackage's exported names, after a fresh import of both packages, must be
the port's exported names too.
"""
import importlib
import inspect
import os
import pkgutil
import subprocess
import sys

import flax.linen as fnn
import pytest

import comfystereo_tpu as cs
import comfystereo_tpu_torch  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Pallas module -> kernels module, and Pallas entry -> the port's wrapper.
PALLAS_MODULES = {"distance": "distance", "flash_attention": "flash_attention",
                  "gather": "gather", "polylines_exact_kernel": "polylines_exact",
                  "polylines_kernel": "polylines", "warp_kernel": "warp_kernel"}
PALLAS = {"distance.edge_distances": "distance.edge_distances",
          "flash_attention.flash_attention": "flash_attention.flash_attention",
          "flash_attention.supports": "flash_attention.supports",
          "gather.bounded_take_along_w": "gather.bounded_take_along_w",
          "polylines_exact_kernel.polylines_exact_scanline":
              "polylines_exact.polylines_exact_rows",
          "polylines_kernel.polylines_scanline": "polylines.polylines_scanline",
          "warp_kernel.warp_scanline": "warp_kernel.warp_rows"}

# (module, name) -> (JAX-only parameter names, or None for the whole name; reason)
JAX_ONLY = {
    ("diffusion.adapters", "from_flax_diffusers"):
        (None, "builds the bundle from diffusers' flax modules and params trees"),
    ("diffusion.adapters", "from_torch_modules"):
        ({"port_weights"}, "JAX may keep a torch model unported behind a host callback; "
                           "the port always runs the weights in its own torch modules"),
    ("diffusion.clip_text", "NativeCLIPTextEncoder"):
        ({"params"}, "a flax params tree; the port's encoder holds a torch module"),
    ("diffusion.helpers", "init_latent"):
        ({"rng"}, "a jax.random key; the port draws from a torch.Generator"),
    ("diffusion.models", "DiffusionModel"):
        ({"unet_params", "vae_params"}, "flax params trees; the port's bundle closes over "
                                        "its torch modules"),
    ("diffusion.models", "make_toy_model"):
        ({"rng"}, "a jax.random key; the port takes a seed"),
    ("diffusion.porting", "build_sd_model"):
        ({"unet_params", "vae_params", "rng"}, "flax params trees and a jax.random key; "
                                               "the port takes state dicts and a seed"),
    ("diffusion.porting", "torch_to_flax_params"):
        (None, "converts a torch state dict into a flax params tree"),
    ("diffusion.porting", "flax_to_torch_state_dict"):
        (None, "converts a flax params tree into a torch state dict"),
    ("diffusion.porting", "tree_shapes"):
        (None, "the shapes of a flax params tree"),
    ("diffusion.porting", "save_params_orbax"):
        (None, "orbax checkpointing of a params tree"),
    ("diffusion.porting", "load_params_orbax"):
        (None, "orbax checkpointing of a params tree"),
    ("diffusion.quantize", "quantize_tree"):
        (None, "w8 over a flax params tree; the port quantises a module in place"),
    ("diffusion.quantize", "dequantize_tree"):
        (None, "w8 over a flax params tree; the port's w8 layers dequantise themselves"),
    ("diffusion.quantize", "quantized_bytes"):
        ({"params"}, "a flax params tree; the port counts a module's state"),
    ("utils.caching", "load_params"):
        ({"like"}, "a params tree to restore into (orbax); torch.load needs none"),
}

_FLAX_FIELDS = {"parent", "name"}


def _jax_modules():
    names = [cs.__name__] + [m.name for m in pkgutil.walk_packages(cs.__path__,
                                                                    cs.__name__ + ".")]
    return [n[len(cs.__name__) + 1:] if n != cs.__name__ else "" for n in names]


def _defined(mod):
    """Public callables (functions, classes, jitted functions) `mod` defines."""
    return {n: o for n, o in vars(mod).items()
            if not n.startswith("_") and callable(o) and not inspect.ismodule(o)
            and getattr(o, "__module__", None) == mod.__name__}


def _params(obj):
    return inspect.signature(getattr(obj, "__wrapped__", obj)).parameters


def signature_gaps(jax_mod: str, jax_name: str, jax_obj, port_obj):
    """The JAX parameter names that the port's counterpart does not accept."""
    want = set(_params(jax_obj))
    if inspect.isclass(jax_obj) and issubclass(jax_obj, fnn.Module):
        want -= _FLAX_FIELDS
    skip, _ = JAX_ONLY.get((jax_mod, jax_name), (set(), None))
    have = _params(port_obj)
    if any(p.kind is p.VAR_KEYWORD for p in have.values()):
        return []
    return sorted(want - set(have) - set(skip or ()))


MODULES = [m for m in _jax_modules() if m != "pallas" and not m.startswith("pallas.")]


def test_every_jax_module_has_a_counterpart():
    for mod in _jax_modules():
        top, _, rest = mod.partition(".")
        port = (f"kernels.{PALLAS_MODULES[rest]}" if top == "pallas" and rest
                else "kernels" if top == "pallas" else mod)
        importlib.import_module(f"comfystereo_tpu_torch.{port}".rstrip("."))


@pytest.mark.parametrize("mod", MODULES)
def test_module_signatures(mod):
    """Each public function and class of the JAX module exists in the port's
    module of the same name and accepts every JAX parameter name."""
    jmod = importlib.import_module(f"comfystereo_tpu.{mod}".rstrip("."))
    tmod = importlib.import_module(f"comfystereo_tpu_torch.{mod}".rstrip("."))
    problems = []
    for name, obj in _defined(jmod).items():
        skip, _ = JAX_ONLY.get((mod, name), (set(), None))
        if skip is None:
            continue
        port = getattr(tmod, name, None)
        if port is None:
            problems.append(f"{name}: missing")
            continue
        gaps = signature_gaps(mod, name, obj, port)
        if gaps:
            problems.append(f"{name}: does not accept {gaps}")
    assert not problems, f"{mod}: " + "; ".join(problems)


def test_jax_only_names_are_jax_only():
    """The allowlist names only what the JAX package has and the port lacks,
    each with a reason."""
    for (mod, name), (params, reason) in JAX_ONLY.items():
        assert reason
        jobj = getattr(importlib.import_module(f"comfystereo_tpu.{mod}"), name)
        port = getattr(importlib.import_module(f"comfystereo_tpu_torch.{mod}"), name, None)
        if params is None:
            assert port is None, f"{mod}.{name} exists in the port"
            continue
        assert params <= set(_params(jobj)), (mod, name)
        assert not params & set(_params(port)), f"{mod}.{name} accepts {params}"


def test_pallas_entries_have_wrappers():
    """Each Pallas entry (the functions that reach pl.pallas_call, and the
    flash kernel's `supports`) has its CUDA kernel's wrapper in kernels/."""
    seen = set()
    for jname, tname in PALLAS.items():
        jm, jf = jname.split(".")
        tm, tf = tname.split(".")
        assert callable(getattr(importlib.import_module(f"comfystereo_tpu.pallas.{jm}"), jf))
        assert callable(getattr(importlib.import_module(f"comfystereo_tpu_torch.kernels.{tm}"),
                                tf))
        seen.add(jname)
    for jm in PALLAS_MODULES:
        mod = importlib.import_module(f"comfystereo_tpu.pallas.{jm}")
        assert {f"{jm}.{n}" for n in _defined(mod)} <= seen, jm


_EXPORTS = r"""
import importlib, pkgutil, sys
import comfystereo_tpu as cs, comfystereo_tpu_torch  # noqa: F401
gaps = []
for m in pkgutil.iter_modules(cs.__path__):
    if not m.ispkg:
        continue
    jp = importlib.import_module("comfystereo_tpu." + m.name)
    tp = importlib.import_module("comfystereo_tpu_torch." + {"pallas": "kernels"}.get(m.name, m.name))
    gaps += [f"{m.name}.{n}" for n in dir(jp) if not n.startswith("_") and not hasattr(tp, n)]
print(" ".join(gaps))
sys.exit(1 if gaps else 0)
"""


def test_subpackage_exports():
    """After a fresh `import comfystereo_tpu, comfystereo_tpu_torch` and of
    each subpackage, every name a JAX subpackage exports (its own names and
    the modules its __init__ imports) is exported by the port's."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    r = subprocess.run([sys.executable, "-c", _EXPORTS], cwd=_ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"missing exports: {r.stdout.strip()}\n{r.stderr[-2000:]}"
