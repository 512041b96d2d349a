"""The port's benchmark: one cell a run, driven by BENCHMARK.json."""
