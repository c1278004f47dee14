"""Fixtures of the benchmark's own tests: a copy of the benchmark's folder
and of BENCHMARK.json whose traffic mixes are cut to a tiny size, so that a
cell runs end to end on the CPU through the program's plain versions."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
TINY = {"video_chunk": dict(height=24, width=48, frames_per_call=3, distinct=6, check_among=4,
                            trace_calls=3)}


def tiny_copy(dst: Path) -> Path:
    """dst/stereo_bench: the benchmark's folder with tiny traffic, beside a
    copy of BENCHMARK.json. Returns the folder."""
    root = dst / "stereo_bench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__", "test_*.py",
                                                              "conftest.py"))
    for path in (root / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(TINY[t["entry"]])
        path.write_text(json.dumps(t))
    (dst / "BENCHMARK.json").write_text(json.dumps(BENCH))
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return tiny_copy(tmp_path)
