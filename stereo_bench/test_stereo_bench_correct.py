"""What decides `correct` fails when it should: the cell's control in the
program's place, and a run whose timed path is broken underneath (a step
that returns its state unchanged, half of a chunk left out, one output
value altered where it is produced). On the CPU, at a tiny size, through
the program's plain versions; the harness's look for a card is skipped
with `--device cpu`. Run these tests on their own (`pytest stereo_bench`):
the runs refuse a process in which JAX is loaded."""
from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from stereo_bench import run
from stereo_bench.conftest import CELLS


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


def _unchanged(monkeypatch):
    """Each eye is the source, never warped or filled."""
    from comfystereo_tpu_torch import pipeline

    def eye(src, eye_d, div, sign, cfg, depth_range=None):
        gap = torch.zeros(eye_d.shape, dtype=torch.bool, device=eye_d.device)
        return src, (gap if cfg.fill_technique == "gpu_warp" else None)
    monkeypatch.setattr(pipeline, "_eye", eye)


def _half_batch(monkeypatch):
    """The chunk's second half of frames is not computed: it repeats the
    first half's results."""
    from comfystereo_tpu_torch.utils import video
    real = video.stereo_pipeline

    def half(image, depth, cfg):
        k = max(1, image.shape[0] // 2)
        out = real(image[:k], depth[:k], cfg)
        reps = -(-image.shape[0] // k)
        return {key: (tuple(torch.cat([t] * reps)[:image.shape[0]] for t in val)
                      if isinstance(val, tuple) else torch.cat([val] * reps)[:image.shape[0]])
                for key, val in out.items()}
    monkeypatch.setattr(video, "stereo_pipeline", half)


def _altered(monkeypatch):
    """One value of the packed pair moved by one step of 1/255 where the
    pipeline produces it."""
    from comfystereo_tpu_torch import pipeline
    real = pipeline._outputs

    def outputs(*a, **kw):
        out = real(*a, **kw)
        s = out["stereo"][0].clone()
        v = s.reshape(-1)
        v[7] = v[7] + 1.0 / 255 if v[7] < 0.5 else v[7] - 1.0 / 255
        out["stereo"] = (s,) + tuple(out["stereo"][1:])
        return out
    monkeypatch.setattr(pipeline, "_outputs", outputs)


FAULTS = ([(c, _unchanged) for c in CELLS] + [(c, _half_batch) for c in CELLS]
          + [(c, _altered) for c in CELLS])


def test_sound_run_is_correct(tiny_root):
    assert _run(tiny_root, CELLS[0])["correct"] is True


@pytest.mark.parametrize("workload, fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    fault(monkeypatch)
    assert _run(tiny_root, workload)["correct"] is False
