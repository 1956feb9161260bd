"""A run with the timed path broken underneath comes out not correct: the
whole run (set-up, window, check) at a size the CPU holds, with the
harness's look for a card skipped, once clean and once for each fault the
cells can have. One card, so no exchange between chips to leave out."""
import time

import pytest
import torch

import lili_om_tpu_torch.models.pose_graph as pose_graph
import lili_om_tpu_torch.models.system as system
from lom_bench import cli
from lom_bench.registry import Registry
from small import small_cell


def _run(workload, seed=4242):
    reg = Registry()
    cell = reg.workload(workload)
    cfg, traffic = small_cell(cell["config"], cell["traffic"])
    return cli.run(cell, cfg, traffic, reg, seed, 1.0, False, time.perf_counter(),
                   device="cpu")


def _unchanged_state(orig):
    def step(state, *args, **kw):
        _, out = orig(state, *args, **kw)
        return state, out
    return step


def _half_the_scan(orig):
    def step(state, surf, surf_mask, *args, **kw):
        keep = surf_mask.clone()
        keep[1::2] = False
        return orig(state, surf, keep, *args, **kw)
    return step


def _pose_altered(orig):
    def step(*args, **kw):
        state, out = orig(*args, **kw)
        return state, out._replace(t=out.t + 1e-3)
    return step


def _fused_altered(orig):
    def step(*args, **kw):
        state, out = orig(*args, **kw)
        return state._replace(t=state.t + 1e-3), out
    return step


def _motion_unchanged(orig):
    def step(state, *args, **kw):
        new, out = orig(state, *args, **kw)
        return new._replace(v=state.v, ba=state.ba, bg=state.bg), out
    return step


def _graph_unchanged(orig):
    def solve(g, n, *args, **kw):
        return g.t[:n].cpu().numpy().copy(), g.q[:n].cpu().numpy().copy()
    return solve


def _loop_columns_wrong(orig):
    # the resolve of U's 6L loop columns (every resolve wider than the
    # gradient's one column) comes back halved
    def resolve(factor, rhs):
        x = orig(factor, rhs)
        return x * 0.5 if rhs.shape[-1] > 1 else x
    return resolve


def _submap_leaf_wrong(orig):
    def downsample(pts, leaf):
        return orig(pts, leaf * 1.5)
    return downsample


def _icp_altered(orig):
    def icp(*args, **kw):
        res = orig(*args, **kw)
        return res._replace(t=res.t + 1e-3)
    return icp


FAULTS = {
    "odometry_unchanged_state": ("odometry_step", _unchanged_state),
    "fusion_unchanged_state": ("fusion_step", _unchanged_state),
    "half_the_scan": ("odometry_step", _half_the_scan),
    "pose_altered": ("odometry_step", _pose_altered),
    "fused_window_altered": ("fusion_step", _fused_altered),
    "fused_motion_unchanged": ("fusion_step", _motion_unchanged),
}

# faults of the closure path, planted in the module that holds the function
CLOSURE_FAULTS = {
    "icp_altered": (system, "icp_point_to_plane", _icp_altered, "icp_gap_m"),
    "graph_unchanged": (system, "solve_graph_incremental", _graph_unchanged, "graph_pose_gap"),
    "loop_columns_wrong": (pose_graph, "block_tridiag_resolve", _loop_columns_wrong,
                           "graph_step_gap"),
    "submap_leaf_wrong": (system, "voxel_downsample_np", _submap_leaf_wrong, "submap_gap_m"),
}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 4))
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("workload", ["rot64.lap", "horizon.lap"])
def test_clean_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(fault, monkeypatch):
    name, make = FAULTS[fault]
    monkeypatch.setattr(system, name, make(getattr(system, name)))
    res = _run("rot64.lap")
    assert not res["correct"], res["checks"]


def test_clean_closure_run_is_correct():
    clean = _run("rot64.revisit")
    assert clean["correct"], clean["checks"]


@pytest.mark.parametrize("fault", sorted(CLOSURE_FAULTS))
def test_closure_fault_is_caught(fault, monkeypatch):
    module, name, make, number = CLOSURE_FAULTS[fault]
    monkeypatch.setattr(module, name, make(getattr(module, name)))
    res = _run("rot64.revisit")
    assert not res["correct"], res["checks"]
    c = res["checks"][number]
    assert not isinstance(c["value"], float) or c["value"] > c["limit"], res["checks"]
