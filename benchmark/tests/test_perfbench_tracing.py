"""The readers of the program's spans, counters and host reads: each gives
its value from a hand-made window of stage samples, and nothing where the
program recorded no such sample (the program before it had them)."""
import math

import pytest

from lom_bench.cli import Context
from lom_bench.registry import Registry

# a window of two sessions: 5 scans, 3 keyframes (2 solved), 1 closure attempt
STAGES = {
    "odometry": [0.02] * 5,
    "backend": [0.3, 0.2, 0.4],
    "fusion.ingest": [0.01, 0.02, 0.03],
    "fusion.match": [0.1, 0.3],
    "fusion.solve": [0.05, 0.07],
    "fusion.lm_iters": [3, 15],
    "odometry.gn_steps": [24, 12, 4, 5, 6],
    "host_read.odometry": [0.001] * 5,
    "host_read.odometry_gn": [0.0005] * 10,
    "host_read.fusion_lm": [0.002] * 4,
    "host_read.icp_fitness": [0.004],
}

EXPECTED = {
    "fusion_ingest_ms": 20.0,
    "fusion_match_ms": 200.0,
    "fusion_solve_ms": 60.0,
    "fusion_lm_iters": 9.0,
    "odometry_gn_steps": 10.2,
    "host_reads_per_scan": 20 / 5,
    "host_read_ms": 1e3 * (0.005 + 0.005 + 0.008 + 0.004) / 5,
}


def _ctx(stages):
    return Context(stages=stages, trace=None, trace_scans=0, knn_work=[])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_the_window(name):
    v = Registry().reader(name)(_ctx(STAGES))
    assert math.isclose(v, EXPECTED[name], rel_tol=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_without_samples(name):
    read = Registry().reader(name)
    assert read(_ctx({})) is None
    # the program before the tracer: its stages, and no span, counter or read
    before = {k: v for k, v in STAGES.items()
              if k in ("odometry", "backend", "preprocess", "densify", "fusion")}
    assert read(_ctx(before)) is None


def test_every_new_metric_is_declared_for_every_cell():
    reg = Registry()
    spec = {m["name"]: m for m in reg.spec["per_layer"]}
    for name in EXPECTED:
        assert spec[name]["source"] == "program_span" and "workloads" not in spec[name]
        for cell in reg.spec["workloads"]:
            assert name in {m["name"] for m in reg.metrics("per_layer", cell["name"])}
