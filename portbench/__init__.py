"""The port's benchmark: one cell of BENCHMARK.json per run (see run.py and README.md)."""
