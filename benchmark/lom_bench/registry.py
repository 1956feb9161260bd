"""Finds what ``BENCHMARK.json`` names: a cell's configuration file (the
entry's ``file``), its traffic mix (``traffic/<name>.json``) and each
per-layer metric's reader (``metrics/<name>.py``, a module with
``read(ctx)``). A new configuration, mix or metric is a new file and a new
entry; nothing here changes."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


class Registry:
    def __init__(self, bench_dir: Path | str = BENCH_DIR):
        self.bench_dir = Path(bench_dir)
        self.root = self.bench_dir.parent
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)
        self._readers: dict = {}

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.bench_dir / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def metrics(self, kind: str, workload: str) -> list:
        """The ``end_to_end`` or ``per_layer`` metrics that ``workload``
        reports: those without ``workloads`` and those that list it."""
        return [m for m in self.spec[kind] if workload in m.get("workloads", [workload])]

    def reader(self, name: str):
        """``read(ctx) -> float | None`` of per-layer metric ``name``."""
        if name not in self._readers:
            path = self.bench_dir / "metrics" / f"{name}.py"
            spec = importlib.util.spec_from_file_location(f"_bench_metric_{name}", path)
            if spec is None or not path.exists():
                raise KeyError(f"no reader metrics/{name}.py for the metric {name!r}")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._readers[name] = mod.read
        return self._readers[name]
