"""Input generators of the benchmark, driven by the configurations."""
