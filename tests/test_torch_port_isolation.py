"""The port imports neither JAX nor the JAX package, nor does chip_smoke.py."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
import comfystereo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(comfystereo_tpu_torch.__path__,
                                                "comfystereo_tpu_torch.")]
for n in names:
    importlib.import_module(n)
{extra}
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "comfystereo_tpu"))
assert not bad, bad
assert len(names) >= 15, names
for need in ("parallel.sharding", "parallel.pipeline", "parallel.data_parallel",
             "graft_entry", "native", "viewer.core", "viewer.headless",
             "nodes.native_nodes", "ops.backward_warp", "utils.profiling",
             "utils.tensors"):
    assert "comfystereo_tpu_torch." + need in names, need
print("ok", len(names))
"""


def _run(extra=""):
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _CHECK.format(extra=extra)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_port_imports_no_jax():
    _run()


def test_chip_smoke_imports_no_jax():
    _run("import importlib.util\n"
         "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
         "spec.loader.exec_module(importlib.util.module_from_spec(spec))")
