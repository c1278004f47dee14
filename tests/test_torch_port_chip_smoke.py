"""chip_smoke.py's phase 6 on the CPU: the plain pass of a BASELINE line
swaps in a plain version at every kernel call site of the pipeline's ops,
and a line's pass equals its plain pass at a toy size."""
import importlib
import inspect
import pkgutil

import pytest
import torch

import chip_smoke as smoke
from comfystereo_tpu_torch.config import FILL_TECHNIQUES, StereoConfig


def _launching(fn) -> bool:
    names = fn.__code__.co_names
    return "LAUNCHES" in names or "_launch" in names


def test_chip_smoke_plain_pass_covers_every_kernel_call_site():
    """chip_smoke.py's plain pass of a line swaps in a plain version at
    every place where the pipeline's ops hold a kernel wrapper."""
    import comfystereo_tpu_torch.ops as ops
    held = set()
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"comfystereo_tpu_torch.ops.{info.name}")
        for name, obj in vars(mod).items():
            if (inspect.isfunction(obj) and obj.__module__.startswith(
                    "comfystereo_tpu_torch.kernels.") and _launching(obj)):
                held.add((mod.__name__, name))
    sites = {(mod.__name__, name) for mod, name, _ in smoke.plain_call_sites()}
    assert held and held == sites
    wrappers = {(mod, name): getattr(mod, name) for mod, name, _ in smoke.plain_call_sites()}
    with smoke.plain_kernels():
        assert not any(_launching(getattr(mod, name)) for mod, name in wrappers)
    assert all(getattr(mod, name) is fn for (mod, name), fn in wrappers.items())


@pytest.mark.parametrize("n", [4, 5])
def test_chip_smoke_plain_pass_on_the_cpu(n, monkeypatch):
    """The plain pass of configs 4 and 5 at a toy size: on the CPU both
    passes run the plain versions, so every output agrees exactly. Config
    5 runs every fill of the port at both balances."""
    monkeypatch.setattr(smoke, "sync", lambda: None)
    (name, (_, fields)), = [(k, v) for k, v in smoke.BASELINE_LINES.items()
                            if k.startswith(f"{n}_")]
    cfgs = [StereoConfig(**f) for f in fields]
    if n == 5:
        assert [(c.fill_technique, c.stereo_balance) for c in cfgs] == [
            (t, b) for t in FILL_TECHNIQUES for b in (0.0, 0.5)]
    imgs, dms = smoke.baseline_inputs(name, 36, 64, 2)
    assert smoke.check_bench_plain(f"config {n}", cfgs, imgs, dms, torch.device("cpu")) == 0.0
