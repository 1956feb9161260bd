"""The reader of the fusion's LM replay share: the window's replays over
its iterations, and nothing where the program recorded no replay counter
(a program whose LM loop runs eagerly, as before the graph)."""
import math

from lom_bench.cli import Context
from lom_bench.registry import Registry

NAME = "fusion_lm_replay_share"


def _read(stages):
    return Registry().reader(NAME)(Context(stages=stages, trace=None, trace_scans=0,
                                           knn_work=[]))


def test_reader_reads_the_window():
    stages = {"fusion.lm_iters": [3, 15, 6], "fusion.lm_replays": [3, 15, 6]}
    assert _read(stages) == 1.0
    # a keyframe whose loop ran eagerly lowers the share
    stages["fusion.lm_replays"] = [3, 15]
    assert math.isclose(_read(stages), 18 / 24, rel_tol=1e-12)


def test_reader_finds_nothing_without_replays():
    assert _read({}) is None
    assert _read({"fusion.lm_iters": [3, 15], "odometry": [0.02] * 5}) is None
    assert _read({"fusion.lm_iters": [], "fusion.lm_replays": []}) is None


def test_metric_is_declared_for_every_cell():
    reg = Registry()
    m = {m["name"]: m for m in reg.spec["per_layer"]}[NAME]
    assert (m["source"], m["layer"], m["moves"]) == ("program_counter", "backend", "scan_p95_ms")
    assert reg.spec["per_layer"][-1]["name"] == NAME and "workloads" not in m
    for cell in reg.spec["workloads"]:
        assert NAME in {x["name"] for x in reg.metrics("per_layer", cell["name"])}
