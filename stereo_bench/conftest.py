"""Fixtures of the benchmark's own tests: a copy of the benchmark's folder
and of BENCHMARK.json whose traffic mixes are cut to a tiny size, so that a
cell runs end to end on the CPU through the program's plain versions. Each
driver gives the tiny sizes of the mixes that drive it, in its `TINY`."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from stereo_bench import run

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny_copy(dst: Path, src: Path = HERE) -> Path:
    """dst/stereo_bench: the benchmark's folder `src` with each traffic mix
    cut to the `TINY` sizes of the driver it names, beside a copy of the
    BENCHMARK.json next to `src`. Returns the folder."""
    root = dst / "stereo_bench"
    shutil.copytree(src, root, ignore=shutil.ignore_patterns("__pycache__", "test_*.py",
                                                             "conftest.py"))
    for path in sorted((root / "traffic").glob("*.json")):
        t = json.loads(path.read_text())
        driver = run._load(root / "drivers" / f"{t['entry']}.py", f"tiny_driver_{t['entry']}")
        if not isinstance(getattr(driver, "TINY", None), dict):
            raise ValueError(f"driver {t['entry']!r} (drivers/{t['entry']}.py), which "
                             f"traffic/{path.name} names, has no TINY sizes")
        t.update(driver.TINY)
        path.write_text(json.dumps(t))
    shutil.copy(src.parent / "BENCHMARK.json", dst / "BENCHMARK.json")
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return tiny_copy(tmp_path)
