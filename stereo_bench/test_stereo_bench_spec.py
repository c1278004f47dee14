"""BENCHMARK.json keeps to the benchmark contract, and every name in it has
its files."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["stereo_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert (HERE.parent / BENCH["command"][1]).is_file()
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"stereo_bench/configs/{cfg['name']}.json"
    data = json.loads((HERE.parent / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    assert data["source"] == cfg["source"] and cfg["source"].startswith("https://")
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])  # each keeps a cell


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (HERE / "drivers" / f"{traffic['entry']}.py").is_file()
    assert (HERE / "limits" / f"{cell['name']}.json").is_file()
    e2e = [m for m in BENCH["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    per = [m for m in BENCH["per_layer"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_files_and_keys(metric):
    assert (HERE / "metrics" / f"{metric['name']}.py").is_file()
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= allowed | {"bound"} and "bound" in metric
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= allowed | {"layer", "moves"} and "moves" in metric
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_and_workloads_agree(metric):
    """Every cell a per-layer metric names reports the end-to-end metric it
    moves."""
    moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in metric["workloads"]:
        assert w in cells
        assert w in moved.get("workloads", cells)


def test_layers_are_named_alike():
    by_module = {}
    for m in BENCH["per_layer"]:
        by_module.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_module.values())

