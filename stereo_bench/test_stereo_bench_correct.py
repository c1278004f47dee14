"""What decides `correct` fails when it should: the cell's control in the
program's place, and a run whose timed path is broken underneath by each of
the faults that the driver of the cell's traffic gives in its `FAULTS` (the
chunk path's: a step that returns its state unchanged, half of a chunk left
out, one output value altered where it is produced). A cell whose driver
gives none fails `test_driver_gives_faults`, which names the driver's file.
On the CPU, at a tiny size, through the program's plain versions; the
harness's look for a card is skipped with `--device cpu`. Run these tests
on their own (`pytest stereo_bench`): the runs refuse a process in which
JAX is loaded."""
from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from stereo_bench import run
from stereo_bench.conftest import BENCH, CELLS, HERE


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(tiny_root, workload):
    bench = json.loads((tiny_root.parent / "BENCHMARK.json").read_text())
    cell = run.load_cell(bench, workload, False, tiny_root)
    dev = torch.device("cpu")
    settings = cell.config["settings"]
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        inputs = cell.driver.inputs(cell.traffic, seed)
        submit = cell.driver.control(settings, cell.config["control"], dev)
        keep = list(range(cell.limits["calls"]))
        _, kept = run.run_window(submit, cell.driver.collect, inputs, 0.0, keep,
                                 int(cell.traffic.get("in_flight", 0)), min_calls=len(keep))
        chk = run.checks(run.judge(cell, inputs, kept, dev, seed), cell.limits)
        assert not run.passed(chk), chk


def _run(tiny_root, workload):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(2 ** 31 + 5), "--seconds", "0.3",
                       "--trace", "0", "--device", "cpu"],
                      bench_path=tiny_root.parent / "BENCHMARK.json", root=tiny_root)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _faults(workload):
    """The driver file of the cell's traffic, as `run.load_cell` finds it,
    and the faults that driver gives."""
    cell = run.load_cell(BENCH, workload, False, HERE)
    entry = cell.traffic["entry"]
    return f"stereo_bench/drivers/{entry}.py", getattr(cell.driver, "FAULTS", None)


FAULTS = [(c, f) for c in CELLS for f in (_faults(c)[1] or ())]


@pytest.mark.parametrize("workload", CELLS)
def test_driver_gives_faults(workload):
    path, faults = _faults(workload)
    assert faults and all(callable(f) for f in faults), (
        f"{path}, the driver of cell {workload}, gives no FAULTS: a tuple of functions "
        "fault(monkeypatch), each breaking its timed path underneath in one way")


def test_sound_run_is_correct(tiny_root):
    assert _run(tiny_root, CELLS[0])["correct"] is True


@pytest.mark.parametrize("workload, fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    fault(monkeypatch)
    assert _run(tiny_root, workload)["correct"] is False
