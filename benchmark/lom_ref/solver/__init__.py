"""Part of the benchmark's plain reference; see the package docstring."""
