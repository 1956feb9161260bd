"""Part of the benchmark's log generator; see the package docstring."""
