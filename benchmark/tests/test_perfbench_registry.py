"""The registry finds a configuration, a traffic mix and a per-layer
metric that were added as files and entries only."""
import json

from lom_bench.registry import Registry


def test_registry_finds_files_added_by_name(tmp_path):
    bench = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics"):
        (bench / d).mkdir(parents=True)
    (bench / "configs" / "new_cfg.json").write_text(json.dumps({"name": "new_cfg", "x": 1}))
    (bench / "traffic" / "burst.json").write_text(json.dumps({"name": "burst", "rate": 3}))
    (bench / "metrics" / "new_ms.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx['x']\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "new_cfg", "file": "bench/configs/new_cfg.json"}],
        "workloads": [{"name": "new_cfg.burst", "config": "new_cfg", "traffic": "burst",
                       "chips": 1},
                      {"name": "other", "config": "new_cfg", "traffic": "burst", "chips": 1}],
        "end_to_end": [{"name": "rate", "unit": "1/s"},
                       {"name": "only_other", "unit": "s", "workloads": ["other"]}],
        "per_layer": [{"name": "new_ms", "unit": "ms"}]}))
    reg = Registry(bench)
    cell = reg.workload("new_cfg.burst")
    assert reg.config(cell["config"]) == {"name": "new_cfg", "x": 1}
    assert reg.traffic(cell["traffic"])["rate"] == 3
    assert [m["name"] for m in reg.metrics("end_to_end", "new_cfg.burst")] == ["rate"]
    assert [m["name"] for m in reg.metrics("end_to_end", "other")] == ["rate", "only_other"]
    assert reg.reader("new_ms")({"x": 4}) == 8.0


def test_every_named_piece_of_the_benchmark_has_its_file():
    reg = Registry()
    for cell in reg.spec["workloads"]:
        cfg = reg.config(cell["config"])
        assert cfg["name"] == cell["config"]
        assert reg.traffic(cell["traffic"])["name"] == cell["traffic"]
        for m in reg.metrics("per_layer", cell["name"]):
            assert callable(reg.reader(m["name"]))
        kinds = {m["name"] for m in reg.metrics("end_to_end", cell["name"])}
        assert "setup_s" in kinds and len(kinds) >= 2
