"""One reader per metric of `BENCHMARK.json`, in a file named after the
metric: `read(ctx)` gives its value, or None where the run has nothing to
read for it."""
