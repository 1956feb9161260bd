"""The port's tracer (``utils/metrics.py``) on the CPU, in the system
sessions of test_torch_common: ``tiny_system`` over a short simulated run
(every keyframe stage, warm-up and solved), and the handcrafted revisit of
test_torch_system.py, whose closure fires (the submaps, ICP and the suffix
graph solve).

* The counters equal counts taken apart from them: spies on the fusion's
  ``solve_normal_lm`` / ``solve_normal`` (one call an LM iteration) and on
  the odometry's ``solve_normal`` (one a GN step).
* The fusion's sub-spans: ``fusion.ingest`` a keyframe, ``fusion.match``
  and ``fusion.solve`` a solved keyframe, inside the ``backend`` stage.
* The ``host_read.*`` sites are the main path's explicit device reads.
* Under ``torch.profiler`` the Chrome trace holds the ``lom.*`` spans nested
  as the stages are, and each entry's ordinal under ``lom.id/<n>``; with no
  profiler running ``record_function`` is never entered.
* With no stage current (``fusion_step`` called directly, another thread)
  nothing is recorded.
"""
import json
import threading

import numpy as np
import pytest
import torch

import lili_om_tpu_torch.models.fusion as TFUS
import lili_om_tpu_torch.models.odometry as TODO
import lili_om_tpu_torch.models.system as TSYS
from lili_om_tpu_torch.models.fusion import FusionConfig
from lili_om_tpu_torch.models.odometry import OdometryConfig
from lili_om_tpu_torch.models.pose_graph import add_node
from lili_om_tpu_torch.ops.features_spin import SpinFeatureConfig
from lili_om_tpu_torch.sim.lidar import simulate_scan, spinning_pattern
from lili_om_tpu_torch.sim.trajectory import circle_trajectory, simulate_imu
from lili_om_tpu_torch.sim.world import make_room_world
from lili_om_tpu_torch.utils import metrics as M
from lili_om_tpu_torch.utils.config import LoopClosureConfig
from test_torch_common import CPU, npy, tiny_system

RINGS, COLS, PERIOD, N_SCANS = 16, 360, 0.1, 10

# every span the program opens on the profiler's timeline
STAGE_SPANS = {"lom.preprocess", "lom.odometry", "lom.backend", "lom.fusion",
               "lom.fusion.ingest", "lom.fusion.match", "lom.fusion.solve", "lom.densify",
               "lom.submaps", "lom.icp", "lom.graph_solve", "lom.lc_inlock"}
ENTRY_SPANS = {"lom.scan", "lom.closure"}
# the main path's explicit device reads, by the code that makes them
SCAN_SITES = {"odometry", "odometry_gn", "fusion_lm", "densify"}
CLOSURE_SITES = {"graph_poses", "kf_cloud", "icp_fitness", "correction", "graph_gn",
                 "graph_suffix"}


def _sweeps(n0, n1):
    """Sweeps ``n0..n1-1`` of tiny_run's circle, as ``process_scan`` takes them."""
    world = make_room_world(dtype=torch.float64, device=CPU)
    traj = circle_trajectory(radius=8.0, period=40.0)
    pattern = spinning_pattern(n_rings=RINGS, n_cols=COLS, dtype=torch.float64, device=CPU)
    for k in range(n0, n1):
        sc = simulate_scan(world, traj, k * PERIOD, pattern, period=PERIOD)
        yield (npy(sc.pts).reshape(RINGS, COLS, 3), npy(sc.valid).reshape(RINGS, COLS),
               npy(sc.rel_time).reshape(RINGS, COLS), k * PERIOD)


def _tiny_session():
    """tiny_system with tiny_run's IMU stream pushed (for scans up to 2 s)."""
    traj = circle_trajectory(radius=8.0, period=40.0)
    imu = simulate_imu(traj, 0.0, 2.0, rate=200.0, device=CPU)
    s = tiny_system()
    s.push_imu(npy(imu.stamps), npy(imu.accs), npy(imu.gyrs))
    return s


class _Calls:
    """A function that counts its calls and passes them on."""

    def __init__(self, fn):
        self.fn, self.n = fn, 0

    def __call__(self, *a, **kw):
        self.n += 1
        return self.fn(*a, **kw)


@pytest.fixture(scope="module")
def session():
    """N_SCANS scans of tiny_system, a closure attempt after each, with the
    spies in place: per scan the odometry's GN steps, per fusion call its LM
    iterations, the calls of ``record_function``, and the last fusion call's
    arguments."""
    mp = pytest.MonkeyPatch()
    odo_solve = _Calls(TODO.solve_normal)
    fus_solves = [_Calls(TFUS.solve_normal), _Calls(TFUS.solve_normal_lm)]
    rf = _Calls(torch.profiler.record_function)
    fusion_calls = []

    def fusion_step(*a, **kw):
        fusion_calls.append((a, kw, sum(c.n for c in fus_solves)))
        out = TSYS_FUSION(*a, **kw)
        fusion_calls[-1] += (sum(c.n for c in fus_solves),)
        return out

    TSYS_FUSION = TSYS.fusion_step
    mp.setattr(TODO, "solve_normal", odo_solve)
    mp.setattr(TFUS, "solve_normal", fus_solves[0])
    mp.setattr(TFUS, "solve_normal_lm", fus_solves[1])
    mp.setattr(torch.profiler, "record_function", rf)
    mp.setattr(TSYS, "fusion_step", fusion_step)
    try:
        s = _tiny_session()
        gn_per_scan = []
        for args in _sweeps(0, N_SCANS):
            n0 = odo_solve.n
            s.process_scan(*args)
            gn_per_scan.append(odo_solve.n - n0)
            s.try_loop_closure()
        assert not s.health_check_and_recover()
    finally:
        mp.undo()
    lm_per_fusion = [c[3] - c[2] for c in fusion_calls]
    return dict(sys=s, gn=gn_per_scan, lm=lm_per_fusion, rf_calls=rf.n,
                last_fusion=fusion_calls[-1][:2])


def test_counters_equal_the_solver_calls(session):
    s, smp = session["sys"], session["sys"].metrics.samples
    assert smp["odometry.gn_steps"] == session["gn"] and len(session["gn"]) == N_SCANS
    solved = [n for n in session["lm"] if n]
    assert smp["fusion.lm_iters"] == solved and len(solved) >= 2
    assert len(session["lm"]) == len(s.kf_stamps) > len(solved)  # warm-up keyframes too
    assert s.metrics.kinds == {"odometry.gn_steps": "count", "fusion.lm_iters": "count"}
    # the first two frames run max_rounds of up to gn_iters steps, the rest scan_match_cnt
    cfg = s.odo_cfg
    assert all(1 <= n <= cfg.gn_iters * cfg.max_rounds for n in session["gn"])
    assert all(n <= cfg.gn_iters * cfg.scan_match_cnt for n in session["gn"][2:])


def test_fusion_sub_spans_lie_in_the_backend(session):
    s, smp = session["sys"], session["sys"].metrics.samples
    n_kf, n_solved = len(s.kf_stamps), len(smp["fusion.lm_iters"])
    assert len(smp["backend"]) == len(smp["fusion"]) == len(smp["fusion.ingest"]) == n_kf
    assert len(smp["fusion.match"]) == len(smp["fusion.solve"]) == n_solved
    parts = sum(sum(smp[k]) for k in ("fusion.ingest", "fusion.match", "fusion.solve"))
    assert parts <= sum(smp["fusion"]) <= sum(smp["backend"])


def test_host_read_sites_of_a_session(session):
    smp = session["sys"].metrics.samples
    sites = {k.split(".", 1)[1] for k in smp if k.startswith("host_read.")}
    # no candidate: the attempts read the graph's poses and stop
    assert sites == SCAN_SITES | {"graph_poses", "isfinite"}
    assert len(smp["host_read.odometry"]) == N_SCANS
    assert len(smp["host_read.odometry_gn"]) == sum(session["gn"])  # gn_tol > 0: a read a step
    assert len(smp["host_read.fusion_lm"]) == sum(smp["fusion.lm_iters"])
    assert all(x >= 0.0 for k in smp if k.startswith("host_read.") for x in smp[k])


def test_no_record_function_without_a_profiler(session):
    assert not torch.autograd._profiler_enabled()
    assert session["rf_calls"] == 0


def test_report_and_pretty_print_counts_as_counts(session):
    m = session["sys"].metrics
    rep = m.report()
    gn = rep["odometry.gn_steps"]
    assert set(gn) == {"n", "mean", "p50", "p95", "total"}
    assert gn["total"] == sum(session["gn"]) and gn["n"] == N_SCANS
    assert "mean_ms" in rep["odometry"] and "mean_ms" in rep["host_read.odometry"]
    lines = {ln.split()[0]: ln for ln in m.pretty().splitlines()}
    for name in ("odometry.gn_steps", "fusion.lm_iters"):
        assert " ms" not in lines[name] and lines[name].endswith("(count)")
        assert f"mean={rep[name]['mean']:7.2f}" in lines[name]
    assert " ms " in lines["fusion.solve"] and " ms " in lines["host_read.odometry"]


def test_fusion_step_outside_any_stage_records_nothing(session):
    s = session["sys"]
    before = {k: len(v) for k, v in s.metrics.samples.items()}
    a, kw = session["last_fusion"]
    state, out = TFUS.fusion_step(*a, **kw)
    assert torch.all(torch.isfinite(out.t_latest))
    assert M._CURRENT.get() is None
    assert {k: len(v) for k, v in s.metrics.samples.items()} == before
    with M.span("fusion.match"), M.host_read("odometry"):
        M.count("fusion.lm_iters", 3)
    assert {k: len(v) for k, v in s.metrics.samples.items()} == before


def test_stages_nest_and_threads_keep_their_own():
    m = M.StageMetrics()
    seen = []

    def other_thread():
        seen.append(M._CURRENT.get())
        M.count("c")
        with M.span("s"), M.host_read("x"):
            pass

    with m.stage("outer"):
        M.count("c", 2)
        with m.stage("inner"):
            M.count("c", 5)
            with M.span("s"):
                pass
        M.count("c", 3)
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
    assert seen == [None]
    assert m.samples["c"] == [5, 5]  # inner's, then outer's 2 + 3
    assert len(m.samples["s"]) == 1 and "host_read.x" not in m.samples
    assert len(m.samples["inner"]) == len(m.samples["outer"]) == 1
    assert M._CURRENT.get() is None


def _spans(path):
    """{tid: [(start, end, name)]} of the trace's lom.* spans, by start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("name", "").startswith("lom."):
            ts = float(ev["ts"])
            out.setdefault(ev["tid"], []).append((ts, ts + float(ev.get("dur", 0.0)),
                                                 ev["name"]))
    return {tid: sorted(v, key=lambda x: (x[0], -x[1])) for tid, v in out.items()}


def _parent(spans, i):
    """The innermost span that holds span ``i`` (None at the top)."""
    s, e, _ = spans[i]
    for j in range(i - 1, -1, -1):
        if spans[j][0] <= s and e <= spans[j][1]:
            return spans[j][2]
    return None


PARENTS = {"lom.preprocess": "lom.scan", "lom.odometry": "lom.scan", "lom.backend": "lom.scan",
           "lom.fusion": "lom.backend", "lom.densify": "lom.backend",
           "lom.fusion.ingest": "lom.fusion", "lom.fusion.match": "lom.fusion",
           "lom.fusion.solve": "lom.fusion", "lom.submaps": "lom.closure",
           "lom.icp": "lom.closure", "lom.graph_solve": "lom.closure",
           "lom.lc_inlock": "lom.closure", "lom.scan": None, "lom.closure": None}


def test_profiler_trace_holds_the_spans_and_ordinals(tmp_path):
    """Scans 3–7 profiled, the backend deferred (``process_keyframe``, as
    the runner calls it), an attempt after each scan."""
    from torch.profiler import ProfilerActivity, profile

    s = _tiny_session()
    for args in _sweeps(0, 3):
        s.process_scan(*args)
    kf_scans = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k, args in enumerate(_sweeps(3, 8), start=3):
            _, fc = s.process_scan(*args, defer_backend=True)
            if fc is not None:
                kf_scans.append(k)
                s.process_keyframe(fc, args[-1])
            s.try_loop_closure()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    (spans,) = _spans(path).values()  # one thread
    names = [n for _, _, n in spans]
    assert set(names) - STAGE_SPANS - ENTRY_SPANS == {n for n in names if "/" in n}
    assert {"lom.fusion.solve", "lom.lc_inlock"} <= set(names) and kf_scans
    ids = {}
    for i, (_, _, name) in enumerate(spans):
        if name.startswith("lom.id/"):
            parent = _parent(spans, i)
            assert parent in ENTRY_SPANS
            ids.setdefault(parent, []).append(int(name.split("/")[1]))
        else:
            assert _parent(spans, i) == PARENTS[name], name
    # each entry holds one ordinal: the scan's (its deferred keyframe's too)
    # and the newest keyframe's for an attempt
    assert names.count("lom.scan") == len(ids["lom.scan"]) == 5 + len(kf_scans)
    assert sorted(ids["lom.scan"]) == sorted(list(range(3, 8)) + kf_scans)
    assert len(ids["lom.closure"]) == 5 and ids["lom.closure"][-1] == len(s.kf_stamps) - 1


@pytest.fixture(scope="module")
def revisit():
    """test_torch_system.py's handcrafted revisit, the port alone, the
    keyframe clouds archived on the device: the closure fires."""
    world = make_room_world(dtype=torch.float64, device=CPU)
    pattern = spinning_pattern(n_rings=RINGS, n_cols=720, dtype=torch.float64, device=CPU)
    still = lambda t: (torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64).expand(  # noqa: E731
        *torch.as_tensor(t).shape, 3), torch.tensor([1.0, 0, 0, 0], dtype=torch.float64))
    scan = simulate_scan(world, still, 0.0, pattern, period=PERIOD)
    pts = npy(scan.pts)[npy(scan.valid)]
    pts = torch.as_tensor(pts[::max(1, len(pts) // 4000)])
    s = TSYS.LiliOmSystem(
        odo_cfg=OdometryConfig(n_recent_frames=6, scan_cap=2048, query_cap=1024, map_cap=8192,
                               frame_cap=1024),
        fusion_cfg=FusionConfig(window=3, local_map_width=6, kf_surf_cap=2048,
                                kf_edge_cap=1024, map_surf_cap=8192, map_edge_cap=1024),
        feat_cfg=SpinFeatureConfig(surf_cap=2048),
        lc_cfg=LoopClosureConfig(time_thres=5.0, search_radius=5.0, icp_thres=0.2,
                                 map_width=2, latest_width=1, submap_cap=4096),
        graph_capacity=64, dtype=torch.float64, device=CPU)
    drift = np.array([0.35, -0.2, 0.1])
    poses = [np.zeros(3), np.array([20.0, 0, 0]), np.array([20.0, 20.0, 0]),
             np.array([0.0, 20.0, 0]), drift, drift + np.array([0.5, 0.0, 0.0]),
             drift + np.array([1.0, 0.0, 0.0])]
    for t, stamp in zip(poses, [0.0, 3.0, 6.0, 9.0, 12.0, 13.0, 14.0]):
        s.graph = add_node(s.graph, torch.as_tensor(t),
                           torch.tensor([1.0, 0, 0, 0], dtype=torch.float64))
        s.kf_stamps.append(stamp)
        s.kf_positions.append(t.copy())
        s.kf_clouds.append((pts, torch.ones(len(pts), dtype=torch.bool)))
    fired = s.try_loop_closure()
    return s, fired


def test_closure_records_its_stages_and_reads(revisit):
    s, fired = revisit
    smp = s.metrics.samples
    assert fired and int(s.graph.n_loops) == 1
    for stage in ("lc_inlock", "submaps", "icp", "graph_solve"):
        assert smp[stage], stage
    sites = {k.split(".", 1)[1] for k in smp if k.startswith("host_read.")}
    assert sites == CLOSURE_SITES
    assert len(smp["host_read.icp_fitness"]) == 1
    # submaps of keyframes 4 (latest) and 0–2 (history): one copy each
    assert len(smp["host_read.kf_cloud"]) == 4
    assert not s.metrics.kinds
