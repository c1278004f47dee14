"""The benchmark of `comfystereo_tpu_torch`, the PyTorch and CUDA port.

`run.py` runs one cell of `BENCHMARK.json` (at the checkout's root) once:

    python3 stereo_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by its name: `configs/<config>.json`,
`traffic/<traffic>.json`, `drivers/<entry>.py` (the entry a traffic mix
drives), `metrics/<metric>.py`, `limits/<cell>.json` (the limits of the
comparison that decides `correct`). `scenes.py` makes the inputs from the
seed, `trace.py` reduces a profiler trace, `counts/` holds the peaks and
the byte and operation counts, and `reference/plain.py` the plain reference
that the outputs are judged against. `calibrate.py` reads the compared
numbers of the program and of the control over many seeds.
"""
