"""Fixtures of the benchmark's own tests: a copy of the benchmark's folder
and of BENCHMARK.json whose traffic mixes, and the configurations of models,
are cut to a tiny size, so that a cell runs end to end on the CPU through
the program's plain versions. Each driver gives the tiny sizes of the mixes
that drive it, in its `TINY`, and may give in its `TINY_SETTINGS` the tiny
settings (model widths) that the copy applies to the configuration of
every cell whose mix names that driver."""
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
    cut to the `TINY` sizes of the driver it names, and the settings of each
    configuration whose cells' mixes name a driver with `TINY_SETTINGS` cut
    to those, beside a copy of the BENCHMARK.json next to `src`. A file
    that nothing cuts is copied byte for byte. Returns the folder."""
    root = dst / "stereo_bench"
    shutil.copytree(src, root, ignore=shutil.ignore_patterns("__pycache__", "test_*.py",
                                                             "conftest.py"))
    drivers = {}
    entries = {}  # traffic mix -> the entry its driver runs
    for path in sorted((root / "traffic").glob("*.json")):
        t = json.loads(path.read_text())
        entry = entries[path.stem] = t["entry"]
        if entry not in drivers:
            drivers[entry] = run._load(root / "drivers" / f"{entry}.py", f"tiny_driver_{entry}")
        if not isinstance(getattr(drivers[entry], "TINY", None), dict):
            raise ValueError(f"driver {entry!r} (drivers/{entry}.py), which "
                             f"traffic/{path.name} names, has no TINY sizes")
        t.update(drivers[entry].TINY)
        path.write_text(json.dumps(t))
    shutil.copy(src.parent / "BENCHMARK.json", dst / "BENCHMARK.json")
    settings = {}  # configuration -> (driver, its tiny settings)
    for w in json.loads((dst / "BENCHMARK.json").read_text())["workloads"]:
        entry = entries[w["traffic"]]
        tiny = getattr(drivers[entry], "TINY_SETTINGS", None)
        if tiny is None:
            continue
        first = settings.setdefault(w["config"], (entry, tiny))
        if first[1] != tiny:
            raise ValueError(f"drivers {first[0]!r} (drivers/{first[0]}.py) and {entry!r} "
                             f"(drivers/{entry}.py) give configuration {w['config']!r} "
                             f"different TINY_SETTINGS: {first[1]} and {tiny}")
    for name, (_, tiny) in sorted(settings.items()):
        path = root / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["settings"].update(tiny)
        path.write_text(json.dumps(cfg))
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return tiny_copy(tmp_path)
