"""A run end to end on the CPU at a tiny size, its last line, its refusals,
and a cell added by new files alone."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from stereo_bench import run
from stereo_bench.conftest import BENCH, CELLS, tiny_copy

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def drive(root: Path, workload: str, trace: int, seed: int = 2 ** 31 + 99, cwd=REPO,
          device="cpu", env=None):
    """Run the cell in a fresh process, as the benchmark's command does."""
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", "0.5", "--trace",
            str(trace)] + (["--device", device] if device else [])
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); from pathlib import Path; "
            f"from stereo_bench import run; sys.exit(run.main({argv!r}, "
            f"bench_path=Path({str(root.parent / 'BENCHMARK.json')!r}), root=Path({str(root)!r})))")
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=cwd, timeout=600, env=env)


def _copy_of_the_benchmark(dst: Path) -> Path:
    """dst/stereo_bench: the benchmark's folder as it is, beside a copy of
    BENCHMARK.json. Returns the folder."""
    root = dst / "stereo_bench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    return root


def last_line(out: str):
    return json.loads(out.strip().splitlines()[-1])


def test_forbidden_names_are_whole_top_level_names():
    names = ["jax.numpy", "comfystereo_tpu.ops", "comfystereo_tpu_torch.ops", "jaxlib",
             "flax.linen", "numpy", "jaxtyping", "comfystereo_tpu_torch"]
    assert run.forbidden_modules(names) == ["comfystereo_tpu", "flax", "jax", "jaxlib"]
    assert run.forbidden_modules(["comfystereo_tpu_torch.nodes", "jaxtyping"]) == []


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_end_to_end_on_cpu(tiny_root, workload, trace):
    proc = drive(tiny_root, workload, trace)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = last_line(proc.stdout)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    group = BENCH["per_layer" if trace else "end_to_end"]
    names = {m["name"] for m in group if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names  # host-clock metrics read on any device
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert line["device"]["platform"] == "cpu"  # never a device name for a CPU run
    err = proc.stderr.strip().splitlines()
    assert all(e.startswith("check ") for e in err[-len(line["checks"]):])


def test_fill_only_where_the_configuration_names_one():
    assert run.fill_of({"fill_technique": "GPU Warp (Fast)"}) == "gpu_warp"
    assert run.fill_of({"divergence": 4.5}) is None
    with pytest.raises(KeyError):
        run.fill_of({"fill_technique": "Fill - No Such Fill"})


@pytest.mark.parametrize("in_flight", [0, 2])
def test_window_counts_every_call_and_keeps_its_outputs(in_flight):
    """Every call submitted is collected and counted, in order; with
    `in_flight` the next call is submitted before the last is collected,
    on another thread."""
    order, threads = [], set()

    def submit(v):
        order.append(("submit", v))
        return v + 1

    def collect(x):
        threads.add(threading.get_ident())
        time.sleep(0.002)
        order.append(("collect", x - 1))
        return 10 * x

    win, kept = run.run_window(submit, collect, [0, 1, 2], 0.05, [0, 4], in_flight)
    assert win.calls == len(win.latencies_s) >= 5 and win.elapsed_s >= 0.05
    assert kept == {0: 10, 4: 20}
    assert [v for k, v in order if k == "collect"] == [i % 3 for i in range(win.calls)]
    assert (threading.get_ident() in threads) == (in_flight == 0)
    assert (order[1] == ("submit", 1)) == (in_flight > 0)


def test_window_raises_what_collect_raised():
    def collect(x):
        raise RuntimeError("lost")

    with pytest.raises(RuntimeError, match="lost"):
        run.run_window(lambda v: v, collect, [0], 0.01, [0], 2)


def test_refuses_without_a_card(tiny_root):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    proc = drive(tiny_root, CELLS[0], 0, device=None)
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert "CUDA" in proc.stderr


def test_fails_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder: no result, another exit code than 0."""
    _copy_of_the_benchmark(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "stereo_bench/run.py", "--workload", CELLS[0],
                           "--seed", "5", "--seconds", "1", "--trace", "0", "--device", "cpu"],
                          capture_output=True, text=True, cwd=tmp_path, timeout=600, env=env)
    assert proc.returncode != 0
    assert not proc.stdout.strip().startswith("{") or "correct" not in proc.stdout


def _digest(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_by_new_files_alone(tiny_root):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and new entries in BENCHMARK.json run with no file of the
    benchmark edited."""
    before = _digest(tiny_root)
    cfg = json.loads((tiny_root / "configs" / "gpu_warp_default.json").read_text())
    cfg.update(name="throwaway_cfg")
    cfg["settings"]["divergence"] = 2.0
    (tiny_root / "configs" / "throwaway_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny_root / "traffic" / "video1080_b12.json").read_text())
    mix.update(name="throwaway_mix", pan=[1, 1], frames_per_call=2, distinct=4)
    (tiny_root / "traffic" / "throwaway_mix.json").write_text(json.dumps(mix))
    (tiny_root / "metrics" / "throwaway_calls.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.n_calls) if ctx.trace else None\n")
    cell = "throwaway_cfg.throwaway_mix"
    (tiny_root / "limits" / f"{cell}.json").write_text(
        (tiny_root / "limits" / "gpu_warp_default.video1080_b12.json").read_text())
    bench_path = tiny_root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "throwaway_cfg", "source": "https://example.org",
                             "file": "stereo_bench/configs/throwaway_cfg.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": cell, "config": "throwaway_cfg",
                               "traffic": "throwaway_mix", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append(cell)
    bench["per_layer"].append({"name": "throwaway_calls", "unit": "calls", "better": "higher",
                               "source": "device_trace", "layer": "harness",
                               "moves": "frames_per_s", "workloads": [cell]})
    bench_path.write_text(json.dumps(bench))
    for trace in (0, 1):
        proc = drive(tiny_root, cell, trace)
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = last_line(proc.stdout)
        assert line["correct"] is True
        if trace:
            assert line["metrics"]["throwaway_calls"]["value"] == 3.0  # the traced calls
        else:
            assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    after = _digest(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before


# A driver of an entry that no cell has, which runs a model of its own: a 3x3
# convolution of an RGB frame to `channels` maps, a group norm and a channel
# mix, under one program span; its width in the configuration, cut by its
# TINY_SETTINGS in the tests; its control the block in bfloat16; its faults
# planted in the torch functions that the block calls and the reference,
# written out in float64, does not.
THROWAWAY_DRIVER = '''"""A throwaway entry: a block of plain torch operations under one span."""
import torch

from comfystereo_tpu_torch.utils.profiling import span

TINY = dict(size=8, frames_per_call=2, distinct=4, check_among=4, trace_calls=2)
TINY_SETTINGS = dict(channels=16)


def inputs(traffic, seed):
    g = torch.Generator().manual_seed(seed)
    n, s = traffic["frames_per_call"], traffic["size"]
    return [torch.rand(n, 3, s, s, generator=g) for _ in range(traffic["distinct"] // n)]


def _weights(settings, dtype, device):
    g = torch.Generator().manual_seed(settings["weight_seed"])
    c = settings["channels"]
    k = torch.randn(c, 3, 3, 3, generator=g) / 27 ** 0.5
    w = torch.randn(c, c, generator=g) / c ** 0.5
    return k.to(device, dtype), w.to(device, dtype)


def _program(settings, device, dtype):
    k, w = _weights(settings, dtype, device)

    def submit(x):
        x = x.to(device, dtype)
        with span("throwaway.block"):
            y = torch.nn.functional.conv2d(x, k, padding=1)
            y = torch.nn.functional.group_norm(y, settings["groups"])
            return torch.matmul(w, y.flatten(2)).view_as(y)
    return submit


def program(settings, device):
    return _program(settings, device, torch.float32)


def control(settings, kind, device):
    """`program:dtype=bfloat16`: the block in bfloat16."""
    if kind != "program:dtype=bfloat16":
        raise ValueError(f"unknown control {kind!r}")
    return _program(settings, device, torch.bfloat16)


def collect(out):
    return out.cpu()


def reference(settings, inp, device, frames):
    """The block written out in float64: the convolution as a sum over its
    nine taps, the group norm from its groups' mean and variance."""
    k, w = _weights(settings, torch.float64, device)
    x = torch.nn.functional.pad(inp[frames].to(device, torch.float64), (1, 1, 1, 1))
    h, wd = x.shape[2] - 2, x.shape[3] - 2
    y = sum(torch.einsum("oc,nchw->nohw", k[:, :, i, j], x[:, :, i:i + h, j:j + wd])
            for i in range(3) for j in range(3))
    g = y.reshape(y.shape[0], settings["groups"], -1)
    g = (g - g.mean(-1, keepdim=True)) / (g.var(-1, unbiased=False, keepdim=True) + 1e-5).sqrt()
    return torch.einsum("oc,nchw->nohw", w, g.view_as(y)).cpu()


def select(out, frames):
    return out[frames]


def compare(out, exp):
    err = (out.double() - exp).abs().max() / exp.abs().max()
    return {"rel_err": float(err)}


def _no_norm(monkeypatch):
    """The group norm left out: its input passes on unchanged."""
    monkeypatch.setattr(torch.nn.functional, "group_norm", lambda x, groups, *a, **kw: x)


def _half_frames(monkeypatch):
    """Half of a call's frames computed: the convolution's second half of
    frames repeats its first half's."""
    real = torch.nn.functional.conv2d

    def conv2d(x, *a, **kw):
        k = max(1, x.shape[0] // 2)
        return torch.cat([real(x[:k], *a, **kw)] * -(-x.shape[0] // k))[:x.shape[0]]
    monkeypatch.setattr(torch.nn.functional, "conv2d", conv2d)


FAULTS = (_no_norm, _half_frames)
'''


def add_throwaway_entry(root: Path, size: int = 64) -> str:
    """A configuration with no `fill_technique`, with its model's width and
    its control, a traffic mix of a new entry, that entry's driver (with its
    tiny sizes and settings, its control and its faults), its limits and a
    per-layer reader of its span, written as new files under the
    benchmark's folder `root`, and new entries in the BENCHMARK.json beside
    it. Returns the cell's name."""
    cell = "throwaway_entry.throwaway_block"
    (root / "configs" / "throwaway_entry.json").write_text(json.dumps(
        {"name": "throwaway_entry", "source": "https://example.org", "reduced": [],
         "control": "program:dtype=bfloat16",
         "settings": {"channels": 64, "groups": 8, "weight_seed": 11}}))
    (root / "traffic" / "throwaway_block.json").write_text(json.dumps(
        {"name": "throwaway_block", "entry": "throwaway_entry", "size": size,
         "frames_per_call": 8, "distinct": 32, "check_among": 8, "trace_calls": 4}))
    (root / "drivers" / "throwaway_entry.py").write_text(THROWAWAY_DRIVER)
    (root / "limits" / f"{cell}.json").write_text(json.dumps(
        {"calls": 2, "frames": 2, "max": {"rel_err": 0.002}}))
    (root / "metrics" / "throwaway_block_ms.py").write_text(
        "from stereo_bench.spans import kernel_ms\n\n\n"
        "def read(ctx):\n    return kernel_ms(ctx.trace, [\"throwaway.block\"])\n")
    bench_path = root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "throwaway_entry", "source": "https://example.org",
                             "file": "stereo_bench/configs/throwaway_entry.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": cell, "config": "throwaway_entry",
                               "traffic": "throwaway_block", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append(cell)
    bench["per_layer"].append({"name": "throwaway_block_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "harness",
                               "moves": "frames_per_s", "workloads": [cell]})
    bench_path.write_text(json.dumps(bench))
    return cell


def test_new_entry_by_new_files_alone(tmp_path):
    """A cell of an entry that no cell had, with a configuration that names
    no fill, added as new files and new entries in BENCHMARK.json: the tiny
    copy takes the new driver's own tiny sizes, and the cell runs traced and
    untraced with no file of the benchmark edited."""
    src = _copy_of_the_benchmark(tmp_path / "src")
    before = _digest(src)
    cell = add_throwaway_entry(src)
    root = tiny_copy(tmp_path / "tiny", src)
    assert json.loads((root / "traffic" / "throwaway_block.json").read_text())["size"] == 8
    settings = json.loads((root / "configs" / "throwaway_entry.json").read_text())["settings"]
    assert settings == {"channels": 16, "groups": 8, "weight_seed": 11}
    copied = _digest(root)
    for trace in (0, 1):
        proc = drive(root, cell, trace)
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = last_line(proc.stdout)
        assert line["correct"] is True and line["checks"]["rel_err"]["value"] < 1e-5
        if trace:
            assert line["metrics"] == {}  # no kernel on the CPU: nothing to put to the span
        else:
            assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert {k: v for k, v in _digest(src).items() if k in before} == before
    assert _digest(root) == copied


def test_tiny_copy_names_a_driver_without_tiny_sizes(tmp_path):
    src = _copy_of_the_benchmark(tmp_path / "src")
    add_throwaway_entry(src)
    driver = src / "drivers" / "throwaway_entry.py"
    driver.write_text(driver.read_text().replace("TINY = ", "SMALL = "))
    with pytest.raises(ValueError, match="throwaway_entry"):
        tiny_copy(tmp_path / "tiny", src)


def test_tiny_copy_cuts_only_the_traffic_of_the_video_cells(tmp_path):
    """The chunk driver gives no TINY_SETTINGS: the tiny copy rewrites the
    traffic mixes alone, and copies every other file byte for byte."""
    root = tiny_copy(tmp_path)
    src = {k: v for k, v in _digest(HERE).items()
           if not (k.name.startswith("test_") or k.name == "conftest.py")}
    copied = _digest(root)
    assert set(copied) == set(src)
    assert {k for k in src if copied[k] != src[k]} <= {k for k in src if k.parts[0] == "traffic"}
    assert (tmp_path / "BENCHMARK.json").read_bytes() == (REPO / "BENCHMARK.json").read_bytes()


@pytest.mark.parametrize("channels, agree", [(16, True), (32, False)])
def test_tiny_copy_refuses_two_drivers_that_cut_one_configuration_unlike(tmp_path, channels,
                                                                         agree):
    """A second driver whose cell shares the throwaway configuration: with
    the same TINY_SETTINGS the copy takes them, with others it raises and
    names both drivers."""
    src = _copy_of_the_benchmark(tmp_path / "src")
    add_throwaway_entry(src)
    (src / "drivers" / "throwaway_twin.py").write_text(THROWAWAY_DRIVER.replace(
        "TINY_SETTINGS = dict(channels=16)", f"TINY_SETTINGS = dict(channels={channels})"))
    mix = json.loads((src / "traffic" / "throwaway_block.json").read_text())
    mix.update(name="throwaway_twin", entry="throwaway_twin")
    (src / "traffic" / "throwaway_twin.json").write_text(json.dumps(mix))
    bench_path = src.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["workloads"].append({"name": "throwaway_entry.throwaway_twin",
                               "config": "throwaway_entry", "traffic": "throwaway_twin",
                               "chips": 1, "why": "a test"})
    bench_path.write_text(json.dumps(bench))
    if agree:
        root = tiny_copy(tmp_path / "tiny", src)
        cfg = json.loads((root / "configs" / "throwaway_entry.json").read_text())
        assert cfg["settings"]["channels"] == 16
        return
    with pytest.raises(ValueError) as e:
        tiny_copy(tmp_path / "tiny", src)
    for name in ("throwaway_entry", "throwaway_twin"):
        assert f"drivers/{name}.py" in str(e.value)


def _own_tests(root: Path, select: str):
    """The test files of the benchmark copy `root`, run on the CPU in a fresh
    process for the cases that `select` picks, with the copy first on the
    path and the checkout's program after it."""
    shutil.copy(REPO / "pyproject.toml", root.parent / "pyproject.toml")  # the tests' markers
    path = [str(root.parent), str(REPO)] + [
        p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    proc = subprocess.run([sys.executable, "-m", "pytest", "stereo_bench", "-q", "-rA",
                           "-m", "not cuda", "-k", select, "-p", "no:cacheprovider"],
                          capture_output=True, text=True, cwd=root.parent, timeout=900,
                          env={**os.environ, "PYTHONPATH": os.pathsep.join(path)})
    cases = {}
    for ln in proc.stdout.splitlines():
        word, _, rest = ln.partition(" ")
        if word in ("PASSED", "FAILED", "ERROR") and "::" in rest:
            cases[rest.split("::", 1)[1].split(" - ")[0]] = word
    return proc, cases


def test_entry_of_a_model_passes_the_benchmarks_own_tests(tmp_path):
    """The throwaway entry brings what a new entry that runs a model has to
    bring (`TINY`, `TINY_SETTINGS`, a `control`, `FAULTS`, a `reference`):
    registered as a cell in a copy of the benchmark, every case of the
    copy's own tests for it passes; without its `FAULTS` the same run fails
    and names its driver."""
    root = _copy_of_the_benchmark(tmp_path)
    cell = add_throwaway_entry(root)
    proc, cases = _own_tests(root, "throwaway")
    assert proc.returncode == 0, proc.stdout[-4000:]
    want = [f"test_cell_runs_end_to_end_on_cpu[{cell}-0]",
            f"test_cell_runs_end_to_end_on_cpu[{cell}-1]", f"test_control_fails[{cell}]",
            f"test_driver_gives_faults[{cell}]", f"test_fault_is_not_correct[{cell}-no_norm]",
            f"test_fault_is_not_correct[{cell}-half_frames]", f"test_cells[{cell}]",
            "test_configs[throwaway_entry]", "test_metric_files_and_keys[throwaway_block_ms]"]
    assert {c: "PASSED" for c in want}.items() <= cases.items(), cases
    assert set(cases.values()) == {"PASSED"}, cases

    driver = root / "drivers" / "throwaway_entry.py"
    driver.write_text(driver.read_text().replace("\nFAULTS = (", "\nNOT_FAULTS = ("))
    proc, cases = _own_tests(root, "throwaway")
    assert proc.returncode != 0
    assert cases[f"test_driver_gives_faults[{cell}]"] == "FAILED", cases
    assert {k for k, v in cases.items() if v != "PASSED"} == {
        f"test_driver_gives_faults[{cell}]"}, cases
    assert "stereo_bench/drivers/throwaway_entry.py" in proc.stdout


@pytest.mark.cuda
def test_new_entry_on_the_card(tmp_path):
    """The throwaway entry's cell at its own size on the card, traced: every
    kernel of the stretch (cuBLAS, cuDNN and PyTorch's own) is paired with
    its launch call, and the span's reader reads its kernel time."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stereo_bench.spans import attributed
    from stereo_bench.trace import Trace
    root = _copy_of_the_benchmark(tmp_path)
    cell = add_throwaway_entry(root)
    proc = drive(root, cell, 1, device=None)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = last_line(proc.stdout)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["metrics"]["throwaway_block_ms"]["value"] > 0
    found = attributed(Trace.load(str(run.BUILD / f"{cell}.trace.json")))
    assert found is not None
    under = [name for name, _, u, _ in found if "throwaway.block" in u]
    assert len(under) >= 3 * 4 and any("gemm" in name.lower() for name in under)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(tmp_path, workload):
    """One short run of each cell at its full size on the card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = _copy_of_the_benchmark(tmp_path)
    proc = subprocess.run([sys.executable, str(root / "run.py"), "--workload", workload,
                           "--seed", "4000000001", "--seconds", "2", "--trace", "0"],
                          capture_output=True, text=True, cwd=REPO, timeout=900,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = last_line(proc.stdout)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
