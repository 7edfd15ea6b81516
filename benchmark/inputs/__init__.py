"""Initial conditions made by the benchmark from `--seed` (numpy only)."""
