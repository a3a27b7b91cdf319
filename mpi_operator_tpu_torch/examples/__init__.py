"""The port's benchmark entry points (see lm_benchmark.py)."""
