"""Read the numbers that decide `correct`, for the program over many seeds
and for the cell's control in the program's place over a few, at the
cell's own sizes, in one process:

    python3 stereo_bench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2]

Each seed gets its own inputs and a short window at the cell's own load;
the program's seeds compare the calls a benchmark run with that seed
would compare, the control's its first `calls` (`limits/<cell>.json`). The control
is the configuration's `control`: the program's own lower-precision path
(`program:...`) or the reference computed in a lower precision
(`reference:...`). One JSON line per seed; all of them also go to
`<out>/<cell>.json` (by default under `build/stereo_bench/calibrate/`).
The limits in `limits/<cell>.json` are set from these readings.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from stereo_bench import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=str(run.BUILD / "calibrate"))
    p.add_argument("--root", default=str(run.ROOT), help="the benchmark's folder (tests)")
    args = p.parse_args(argv)
    import torch
    root = Path(args.root)
    bench = run._json(root.parent / "BENCHMARK.json")
    cell = run.load_cell(bench, args.workload, False, root)
    device = torch.device(args.device)
    settings = cell.config["settings"]
    tr = cell.traffic
    rows = []
    plans = [("program", int(s)) for s in args.seeds.split(",") if s]
    plans += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    calls = {"program": cell.driver.program(settings, device),
             "control": cell.driver.control(settings, cell.config["control"], device)}
    for kind, seed in plans:
        inputs = cell.driver.inputs(tr, seed)
        submit = calls[kind]
        cell.driver.collect(submit(inputs[0]))  # built and warm before its window
        keep = (run.sample_calls(seed, tr, cell.limits) if kind == "program"
                else list(range(cell.limits["calls"])))
        win, kept = run.run_window(submit, cell.driver.collect, inputs, args.seconds, keep,
                                   int(tr.get("in_flight", 0)), min_calls=max(keep) + 1)
        numbers = run.judge(cell, inputs, kept, device, seed)
        row = {"workload": args.workload, "kind": kind, "seed": seed, "calls": win.calls,
               "compared": sorted(kept), **numbers}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    try:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{args.workload}.json").write_text(json.dumps(rows, indent=1))
    except OSError as e:
        print(f"calibrate: could not write {args.out}: {e}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
