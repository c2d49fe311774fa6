"""The port's benchmark (benchmark/README.md)."""
