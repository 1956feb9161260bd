"""The metric arithmetic: the rate over the whole window, the p95 over every
scan, the idle share from overlapping device intervals, the roofline
count from shapes and masks, the trace reader's attribution, and how the
check folds and judges its numbers."""
import json
import math

import numpy as np
import pytest
import torch

from lom_bench import check, roofline, stats, trace


def test_rate_is_all_work_over_all_time():
    assert stats.rate(300, 30.0) == 10.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p95_takes_every_scan():
    xs = [0.1] * 95 + [1.0] * 5
    assert stats.p95(xs) == pytest.approx(np.percentile(xs, 95))
    assert stats.p95(list(range(1, 101))) == pytest.approx(95.05)


def test_busy_and_gaps_from_overlapping_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert stats.merged_busy(iv) == pytest.approx(3 + 1 + 1)
    assert stats.idle_gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert stats.merged_busy([]) == 0.0


def test_roofline_count_from_shapes_and_masks():
    ops, nbytes = roofline.work(4, 10, 2, 3, 7, True, True)
    assert ops == 8 * 3 * 7
    assert nbytes == 12 * 14 + 4 + 10 + 4 * 2 * (4 + 8)
    ops, nbytes = roofline.work(4, 10, 2, 4, 10, False, False)
    assert ops == 8 * 40 and nbytes == 12 * 14 + 4 * 2 * 12
    assert roofline.bound_seconds(67e12, 1.0) == pytest.approx(1.0)
    assert roofline.bound_seconds(1.0, 3.35e12) == pytest.approx(1.0)


def test_spy_counts_valid_rows_after_the_fact():
    spy = roofline.KnnSpy()
    q = torch.zeros(5, 3)
    spy._record(q, 8, 3, torch.tensor([True, False, True, True, False]), None)
    (ops, nbytes), = spy.work()
    assert ops == 8 * 3 * 8
    assert nbytes == 12 * 13 + 5 + 5 * 3 * 12


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "pid": 1, "args": args}


def test_trace_reader_attributes_kernels_to_knn_spans(tmp_path):
    events = [
        _ev("user_annotation", "bench.scan", 0, 100),
        _ev("user_annotation", "bench.knn", 10, 10),
        _ev("user_annotation", "bench.knn_prep", 60, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=5),
        _ev("cuda_runtime", "cudaLaunchKernel", 25, 1, correlation=6),
        _ev("cuda_runtime", "cudaLaunchKernel", 61, 1, correlation=7),
        _ev("kernel", "knn_counted", 15, 3, tid=7, correlation=5),
        _ev("kernel", "other", 30, 10, tid=7, correlation=6),
        _ev("kernel", "knn_map", 62, 2, tid=7, correlation=7),
        _ev("gpu_memcpy", "Memcpy DtoH", 35, 10, tid=7, correlation=8),
        _ev("cpu_op", "aten::item", 70, 20),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    d = trace.read(str(path))
    assert d.window_s == pytest.approx(100e-6)
    assert d.busy_s == pytest.approx((3 + 15 + 2) * 1e-6)
    assert d.n_kernels == 3
    assert d.knn_times == [pytest.approx(3e-6)]
    assert d.knn_prep_s == pytest.approx(2e-6)
    assert d.idle_gaps[0] == ["bench.knn_prep/python", pytest.approx(36e-6)]
    assert ["bench.scan/python", pytest.approx(17e-6)] in d.idle_gaps
    assert d.device_ops[0] == ["other", pytest.approx(10e-6)]
    assert not path.exists()
    assert math.isclose(100 * (1 - d.busy_s / d.window_s), 80.0)


def test_check_folds_medians_low_and_judges_every_limit():
    # the odometry's and the fused window's medians take the lower middle
    # value; other numbers the largest
    assert check.fold("fusion_gap_m", [4.0, 1.0, 3.0, 2.0]) == 2.0
    assert check.fold("fusion_rebuild_gap_m", [5e-3, 1e-6]) == 1e-6
    assert check.fold("odo_gap_m", [1.0, 3.0, 2.0]) == 2.0
    assert check.fold("odo_map_gap_m", [2.8e-4, 0.0, 1e-7, 2e-7]) == 1e-7
    assert check.fold("icp_gap_m", [1.0, 3.0, 2.0]) == 3.0
    assert check.fold("fusion_warmup_gap", [0.0, 1e-9]) == 1e-9
    assert check.fold("odo_gap_m", []) == math.inf
    lap = {"check": {"closures": 0}}
    gaps = {n: [0.0] for n in check.ODOMETRY + check.FUSION}
    limits = {n: 0.0 for n in check.ODOMETRY + check.FUSION}
    assert check.judge(gaps, limits, lap)[0]
    # a null limit is a number the configuration does not compare; a missing one fails
    ok, numbers = check.judge(dict(gaps, fusion_ba_gap=[1.0]), dict(limits, fusion_ba_gap=None), lap)
    assert ok and "fusion_ba_gap" not in [n.name for n in numbers]
    assert not check.judge(gaps, {k: v for k, v in limits.items() if k != "odo_gap_m"}, lap)[0]
    assert not check.judge(dict(gaps, fusion_warmup_gap=[1e-9]), limits, lap)[0]
    # a closure cell compares the closure numbers too, and a planned call that never came fails
    revisit = {"check": {"closures": 2}}
    assert not check.judge(gaps, limits, revisit)[0]
