"""Run one cell of the benchmark once.

    python3 stereo_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run makes its inputs from the seed, loads the program and warms up
every input of the cell (its only shapes), then calls the program in a
closed loop with one caller for `--seconds` seconds. With `--trace 1` a
`torch.profiler` trace covers the first `trace_calls` calls of the window
and the per-layer metrics are read from it; with `--trace 0` the
end-to-end metrics are reported. Either way, once the window has closed,
the outputs of a seeded sample of its calls are compared with the plain
reference (`reference/plain.py`), which runs on the same device, and each
number compared is printed beside its limit (`limits/<cell>.json`).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (with `--trace 1` also
`busy_s` and `window_s` in it), with `--trace 1` `breakdown`, and last
`checks`, the numbers compared with their limits. The run exits with
another code than 0, and prints no result, without a CUDA device (unless
`--device cpu` is asked for, which the harness's own tests use), with
fewer CUDA devices than the cell asks for, or when JAX or the JAX package
has been loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

# Top-level module names that may not be loaded in a run, compared whole
# (the port's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "comfystereo_tpu")
BUILD = CHECKOUT / "build" / "stereo_bench"


def forbidden_modules(names) -> List[str]:
    """The forbidden top-level names among module names."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Window:
    calls: int = 0
    elapsed_s: float = 0.0
    latencies_s: List[float] = field(default_factory=list)


@dataclass
class Context:
    """What a metric reader reads."""
    traffic: Dict
    settings: Dict
    fill: Optional[str]  # None for an entry whose configuration names no fill
    setup_s: float
    window: Window
    trace: object = None


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    driver: object
    limits: Dict
    metrics: Dict  # name -> (unit, reader module)


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(bench: Dict, workload: str, trace: bool, root: Path = ROOT) -> Cell:
    """The cell's entry, configuration, traffic, driver, limits and the
    readers of the metrics it reports, each found by its name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    traffic = _json(root / "traffic" / f"{w['traffic']}.json")
    metrics = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if applies(m, workload):
            metrics[m["name"]] = (m["unit"], _load(root / "metrics" / f"{m['name']}.py",
                                                   f"stereo_bench_metric_{len(metrics)}"))
    return Cell(name=workload, chips=int(w["chips"]),
                config=_json(root / "configs" / f"{w['config']}.json"), traffic=traffic,
                driver=_load(root / "drivers" / f"{traffic['entry']}.py",
                             f"stereo_bench_driver_{traffic['entry']}"),
                limits=_json(root / "limits" / f"{workload}.json"), metrics=metrics)


def fill_of(settings: Dict) -> Optional[str]:
    """The fill that the configuration's `fill_technique` names, by the
    reference's name for it; None where the configuration names none."""
    if "fill_technique" not in settings:
        return None
    from stereo_bench.reference.plain import UI_FILLS
    return UI_FILLS[settings["fill_technique"]]


def sample_calls(seed: int, traffic: Dict, limits: Dict) -> List[int]:
    """The calls of the window whose outputs are compared: `calls` of the
    first `check_among`, drawn from the seed."""
    rng = random.Random(seed * 7919 + 17)
    return sorted(rng.sample(range(traffic["check_among"]), limits["calls"]))


def sample_frames(seed: int, call: int, traffic: Dict, limits: Dict) -> List[int]:
    """The frames of a compared call whose outputs are compared: `frames`
    of the call's, drawn from the seed and the call."""
    rng = random.Random((seed * 7919 + 17) * 104729 + call)
    return sorted(rng.sample(range(traffic["frames_per_call"]),
                             min(limits["frames"], traffic["frames_per_call"])))


def run_window(submit, collect, inputs, seconds: float, keep: List[int], in_flight: int = 0,
               trace_calls: int = 0, profiler=None, min_calls: int = 1):
    """Call the program in a closed loop with one caller until `seconds` have
    passed and at least `min_calls` calls are done; the last call is the
    first to be done after that. A call is `collect(submit(input))`, and it
    is done when `collect` has brought its output to the host.

    With `in_flight` 0 both run on this thread. With `in_flight` n, as a
    converter with a writer thread: this thread submits, puts each result
    on a queue of n places and submits the next, while a second thread
    collects them in order; the calls still in the queue when the window
    closes are collected and counted. The first `trace_calls` calls are
    traced, each inside a `CALL_SPAN` on this thread, the last span lasting
    until every traced call is done. Returns (Window, {call: output} for
    the calls in `keep`)."""
    import torch
    win = Window()
    kept: Dict[int, object] = {}
    keep_set = set(keep)
    starts: List[float] = []
    last: List = [None]
    lock = threading.Condition()
    state = {"done": 0, "end": 0.0, "stop": False, "error": None}
    start = time.perf_counter()
    deadline = start + seconds

    def finish(i: int, out) -> None:
        t = time.perf_counter()
        win.latencies_s.append(t - starts[i])
        if i in keep_set:
            kept[i] = out
        last[0] = (i, out)
        with lock:
            state["done"], state["end"] = i + 1, t
            state["stop"] = state["stop"] or (t >= deadline and i + 1 >= min_calls)
            lock.notify_all()

    q: "queue.Queue" = queue.Queue(maxsize=max(in_flight, 1))

    def consume() -> None:
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                finish(item[0], collect(item[1]))
        except BaseException as e:  # raised again on the caller's thread
            with lock:
                state["error"], state["stop"] = e, True
                lock.notify_all()
            while q.get() is not None:  # drain, so that no put blocks
                pass

    def one(i: int) -> None:
        res = submit(inputs[i % len(inputs)])
        if in_flight:
            q.put((i, res))
        else:
            finish(i, collect(res))

    worker = threading.Thread(target=consume) if in_flight else None
    if worker is not None:
        worker.start()
    i = 0
    try:
        while not state["stop"]:
            starts.append(time.perf_counter())
            if profiler is not None and i < trace_calls:
                from stereo_bench.trace import CALL_SPAN
                with torch.profiler.record_function(CALL_SPAN):
                    one(i)
                    if i == trace_calls - 1:
                        with lock:
                            lock.wait_for(lambda: state["done"] >= trace_calls
                                          or state["error"] is not None)
                if i == trace_calls - 1:
                    profiler.stop()
            else:
                one(i)
            i += 1
    finally:
        if worker is not None:
            q.put(None)
            worker.join()
    if state["error"] is not None:
        raise state["error"]
    if profiler is not None and i < trace_calls:
        profiler.stop()
    if not kept:  # a window shorter than the sample: its last call instead
        kept[last[0][0]] = last[0][1]
    win.calls = state["done"]
    win.elapsed_s = state["end"] - start
    return win, kept


def judge(cell: Cell, inputs, kept: Dict, device, seed: int) -> Dict[str, float]:
    """The numbers compared, over the kept calls' sampled frames: each the
    largest over the calls."""
    settings = cell.config["settings"]
    numbers: Dict[str, float] = {}
    for i, out in sorted(kept.items()):
        frames = sample_frames(seed, i, cell.traffic, cell.limits)
        exp = cell.driver.reference(settings, inputs[i % len(inputs)], device, frames)
        for k, v in cell.driver.compare(cell.driver.select(out, frames), exp).items():
            numbers[k] = max(numbers.get(k, v), v)
    return numbers


def checks(numbers: Dict[str, float], limits: Dict) -> Dict[str, Dict]:
    """Every number with its limit (a number passes at or under it); a
    limit whose number is missing fails."""
    return {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits["max"].items()}


def passed(chk: Dict[str, Dict]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in chk.values())


def smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "n/a"
    except (OSError, subprocess.SubprocessError):
        return "n/a"


def main(argv=None, bench_path: Optional[Path] = None, root: Path = ROOT,
         t0: Optional[float] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", help="cuda (the benchmark), or cpu for tests")
    args = p.parse_args(argv)
    t0 = T0 if t0 is None else t0

    os.environ.setdefault("USE_FLAX", "0")
    BUILD.mkdir(parents=True, exist_ok=True)

    bench = _json(bench_path or CHECKOUT / "BENCHMARK.json")
    cell = load_cell(bench, args.workload, bool(args.trace), root)

    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"stereo_bench: the cell needs {cell.chips} CUDA device(s); {n} found",
                  file=sys.stderr)
            return 2
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"

    settings = cell.config["settings"]
    fill = fill_of(settings)
    parts = {"start": time.perf_counter() - t0}
    inputs = cell.driver.inputs(cell.traffic, args.seed)
    parts["inputs"] = time.perf_counter() - t0
    submit, collect = cell.driver.program(settings, device), cell.driver.collect
    collect(submit(inputs[0]))  # the first call loads (or builds) the kernels
    parts["first_call"] = time.perf_counter() - t0
    for inp in inputs:  # every input once: its shapes and host memory warm
        collect(submit(inp))
    from comfystereo_tpu_torch import kernels
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()

    profiler = None
    trace_calls = int(cell.traffic["trace_calls"]) if args.trace else 0
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        profiler = profile(activities=acts)
        profiler.start()
    keep = sample_calls(args.seed, cell.traffic, cell.limits)
    setup_s = time.perf_counter() - t0
    win, kept = run_window(submit, collect, inputs, args.seconds, keep,
                           int(cell.traffic.get("in_flight", 0)), trace_calls, profiler)

    launches = {k: v / win.calls for k, v in kernels.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del submit
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = judge(cell, inputs, kept, device, args.seed)
    parts["reference_s"] = time.perf_counter() - t_ref
    print(json.dumps({"card": smi() if on_card else "cpu", "memory_peak_bytes": peak,
                      "launches_per_call_by_counter": launches, "calls": win.calls,
                      "setup_parts_s": parts, "compared_calls": sorted(kept)}), flush=True)

    ctx = Context(traffic=cell.traffic, settings=settings, fill=fill, setup_s=setup_s, window=win)
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    result = {}
    if args.trace:
        from stereo_bench.trace import Trace
        path = BUILD / f"{cell.name}.trace.json"
        profiler.export_chrome_trace(str(path))
        ctx.trace = Trace.load(str(path))
        dev["busy_s"] = ctx.trace.busy_s()
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    metrics = {}
    for name, (unit, reader) in cell.metrics.items():
        value = reader.read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}

    found = forbidden_modules(sys.modules)
    if found:
        print(f"stereo_bench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    chk = checks(numbers, cell.limits)
    for k, c in chk.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    line = {"correct": passed(chk), "attempted": win.calls, "failed": 0, "metrics": metrics,
            "device": dev, **result, "checks": chk}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
