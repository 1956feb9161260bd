"""The port's soak and backend-diagnostic apps (``apps/soak_long_run.py``,
``apps/diag_backend.py``) against the JAX examples
(``examples/soak_long_run.py``, ``examples/diag_backend.py``) on the CPU.

Both sides are cut alike: the JAX examples' simulator calls are served by
the port's simulator (test_torch_common.port_sim_for_jax), so both systems
see the same scans and IMU samples; ``LiliOmSystem`` is wrapped on both
sides to shrink the capacities the examples pass (``SMALL_*``: the map,
window, feature, IMU-interval and iteration caps, the same for both apps so
that JAX compiles its steps once for the module; each system's other
settings as the app sets them). The soak keeps the example's trajectory
(the 8 s speed-up ramp) and its 20 s lap time; its lap is cut to
``SOAK_FRAMES`` scans (``FRAMES_PER_LAP``), with a keyframe target reached
within the first lap, an attempt every ``SOAK_LOOP_EVERY`` scans
(``--loop-every`` on both sides) and the closures' age gate lowered to
``SOAK_TIME_THRES`` (``time_thres``, 12 s in the example), so that closures
fire within the cut (the ramp starts from rest, so keyframes 1 s apart lie
within the search radius): the candidate search, the ICP, the loop factor
and the graph solve run on both sides, and both return the verdict's exit
code. The verdict's two timed invariants read each side's host clock,
which a loaded CPU makes vary from run to run, so the clocks that the
soaks and the ``StageMetrics`` of both packages read are counters there
(``_step_clock``: every read 1 ms later than the one before); then both
verdicts depend only on the runs' keyframes, closures and archives. The
diagnostic's circle is pinned to one lap on both sides, since the
two compute the lap from the frame count differently below 130 frames
(``apps/diag_backend.py``). The examples and the apps ask for float32; the
wrapper runs both in float64. In float32 the two packages' roundings part
the soak's trajectories by more than the 1e-3 m that test_torch_frame.py
holds over a few frames before the cut's scans end; in float64 they agree
to 1e-6 m (``TOL_M``, test_torch_system.py's system bound): keyframe stamps
equal, the per-frame trajectory, the graph's keyframes (solved after each
closure), the closures' outcomes, each run's ATE.
"""
import dataclasses
import itertools
import re
import time
import types

import jax.numpy as jnp
import numpy as np
import torch

import examples.diag_backend as JDIAG
import examples.soak_long_run as JSOAK
import lili_om_tpu.models.system as JS
import lili_om_tpu.sim.lidar as JL
import lili_om_tpu.sim.trajectory as JT
import lili_om_tpu.sim.world as JW
import lili_om_tpu.utils.metrics as JM
import lili_om_tpu_torch.models.system as TS
import lili_om_tpu_torch.sim.trajectory as TT
import lili_om_tpu_torch.utils.metrics as TM
from lili_om_tpu_torch.apps import diag_backend, soak_long_run
from test_torch_common import CPU, npy, port_sim_for_jax

TOL_M = 1e-6
SMALL_ODO = dict(n_recent_frames=4, scan_cap=1024, query_cap=256, map_cap=2048)
SMALL_FUSION = dict(local_map_width=4, kf_surf_cap=512, kf_edge_cap=128, map_surf_cap=2048,
                    map_edge_cap=512, max_num_iter=4, imu_cap=64)
SMALL_FEAT = dict(surf_cap=1024)
SOAK_FRAMES, SOAK_KF, SOAK_LOOP_EVERY, SOAK_TIME_THRES = 24, 3, 4, 1.0
DIAG_FRAMES = 12


def _shrunk(monkeypatch, module, made, dtype, **lc):
    """``module.LiliOmSystem`` built with the ``SMALL_*`` caps in ``dtype``
    and the loop-closure fields ``lc`` replaced; each system made is
    appended to ``made`` with the dtype it asked for."""
    cls = module.LiliOmSystem

    def make(**kw):
        kw["odo_cfg"] = kw["odo_cfg"]._replace(**SMALL_ODO)
        kw["fusion_cfg"] = kw["fusion_cfg"]._replace(**SMALL_FUSION)
        kw["feat_cfg"] = kw["feat_cfg"]._replace(**SMALL_FEAT)
        if lc:
            kw["lc_cfg"] = dataclasses.replace(kw["lc_cfg"], **lc)
        asked, kw["dtype"] = kw["dtype"], dtype
        made.append((cls(**kw), asked))
        return made[-1][0]

    monkeypatch.setattr(module, "LiliOmSystem", make)


def _same_systems(t, j):
    """Keyframe stamps equal; trajectory and graph keyframes to ``TOL_M``."""
    assert t.kf_stamps == list(j.kf_stamps) and len(t.kf_stamps) >= 2
    nk = len(t.kf_stamps)
    np.testing.assert_allclose(np.stack(t.trajectory), np.stack(j.trajectory), rtol=0.0,
                               atol=TOL_M)
    np.testing.assert_allclose(npy(t.graph.t[:nk]), np.asarray(j.graph.t[:nk]), rtol=0.0,
                               atol=TOL_M)
    np.testing.assert_allclose(npy(t.graph.q[:nk]), np.asarray(j.graph.q[:nk]), rtol=0.0,
                               atol=TOL_M)
    assert int(t.graph.n_loops) == int(j.graph.n_loops)


def _step_clock(monkeypatch):
    """The ``time`` module of each soak and of each package's metrics
    replaced by one of its own whose ``perf_counter`` advances 1 ms a read:
    every keyframe's latency reads 1 ms and every stage a few ms."""
    for mod in (JSOAK, soak_long_run, JM, TM):
        ticks = itertools.count()
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=time.time, perf_counter=lambda ticks=ticks: next(ticks) * 1e-3))


def test_soak_matches_jax(monkeypatch, tmp_path, capsys):
    """One cut lap of the example's trajectory to ``SOAK_KF`` keyframes with
    ``--spill``, closures within the cut: the same keyframes, trajectory,
    closure attempts' outcomes, solved graph and exit code (both PASS under
    the step clock); the closures' count printed by both."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    made_j, made_t = [], []
    _shrunk(monkeypatch, JSOAK, made_j, jnp.float64, time_thres=SOAK_TIME_THRES)
    _shrunk(monkeypatch, TS, made_t, torch.float64, time_thres=SOAK_TIME_THRES)
    port_sim_for_jax(monkeypatch, (JSOAK,))
    _step_clock(monkeypatch)
    for mod in (JSOAK, soak_long_run):
        monkeypatch.setattr(mod, "FRAMES_PER_LAP", SOAK_FRAMES)
    args = [str(SOAK_KF), "--spill", "--loop-every", str(SOAK_LOOP_EVERY)]
    monkeypatch.setattr("sys.argv", ["soak_long_run.py", *args])
    rc_j = JSOAK.main()
    out_j = capsys.readouterr().out
    rc_t = soak_long_run.main([*args, "--cpu"])
    out_t = capsys.readouterr().out
    ((j, j_asked),), ((t, t_asked),) = made_j, made_t
    assert t_asked == torch.float32 and j_asked == jnp.float32
    _same_systems(t, j)
    assert t.lc_rejects == j.lc_rejects
    n_solved = len(t.metrics.samples["graph_solve"])
    assert n_solved == len(j.metrics.samples["graph_solve"]) >= 1 and int(t.graph.n_loops) >= 1
    assert t.archive_keep_recent == j.archive_keep_recent == soak_long_run.KEEP_RECENT
    assert rc_t == rc_j == 0
    for out in (out_j, out_t):
        assert (f"keyframes: {len(t.kf_stamps)}, frames: {SOAK_FRAMES}, closures: {n_solved}, "
                f"loop factors: {int(t.graph.n_loops)}") in out
        assert re.search(r"^SOAK PASS$", out, re.M)
    assert "resident surf archives" in out_t
    # every solve's GN steps counted, none of them zeroed for a non-finite entry
    steps = re.search(r"^graph-solve GN steps: (\d+) in (\d+) solves .*non-finite steps "
                      r"\(zeroed\): (\d+) in (\d+) solves$", out_t, re.M)
    assert steps and int(steps[2]) == n_solved and int(steps[1]) >= n_solved
    assert steps[3] == steps[4] == "0"


def test_soak_counts_gn_steps():
    """``GnSteps``: one step a GN iteration of the chain solver, a step with
    a non-finite entry counted as such, ``_clamp_step`` restored after."""
    from lili_om_tpu_torch.models import pose_graph as TG

    clamp = TG._clamp_step
    g = TG.init_graph(8, 4, dtype=torch.float64, device="cpu")
    for i in range(6):
        g = TG.add_node(g, torch.tensor([0.5 * i, 0.1 * i * i, 0.0], dtype=torch.float64),
                        torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64))
    with soak_long_run.GnSteps() as steps:
        TG.optimize_graph_chain(g, n_iters=3)
        assert (steps.iters, steps.nonfinite) == (3, 0)
        zero = TG._clamp_step(torch.full((2, 6), float("nan"), dtype=torch.float64))
        assert (steps.iters, steps.nonfinite) == (4, 1) and not bool(zero.any())
    assert TG._clamp_step is clamp


def test_soak_verdict_invariants():
    """The verdict: latency ratio below 1.5, the last quartile's solve p50
    under 1 s, and under spill the resident archives within the bound."""
    class Sys:
        archive_keep_recent = 4

    ok = {"kf_lat": [0.02] * 8, "solve_t": [0.1] * 4, "resident": 4, "system": Sys()}
    assert soak_long_run.verdict(ok, spill=True)
    assert not soak_long_run.verdict({**ok, "kf_lat": [0.02] * 6 + [0.04] * 2}, spill=False)
    assert not soak_long_run.verdict({**ok, "solve_t": [0.1] * 3 + [1.5]}, spill=False)
    assert not soak_long_run.verdict({**ok, "resident": 5}, spill=True)
    assert soak_long_run.verdict({**ok, "resident": 5}, spill=False)


def test_diag_backend_matches_jax(monkeypatch, capsys):
    """``DIAG_FRAMES`` frames on a pinned circle: the same keyframes,
    trajectory and graph, both ATEs to ``TOL_M``; the port prints the ATEs
    of its run."""
    made_j, made_t = [], []
    _shrunk(monkeypatch, JS, made_j, jnp.float64)
    _shrunk(monkeypatch, TS, made_t, torch.float64)
    circle = TT.circle_trajectory
    monkeypatch.setattr(TT, "circle_trajectory",
                        lambda radius, period, speed_up: circle(radius=2.0, period=10.0,
                                                                speed_up=speed_up))
    port_sim_for_jax(monkeypatch, (JW, JT, JL))
    monkeypatch.setattr("sys.argv", ["diag_backend.py", "--cpu", "--frames", str(DIAG_FRAMES)])
    JDIAG.main()
    capsys.readouterr()
    r = diag_backend.run(DIAG_FRAMES, device=CPU, log=lambda *a: None)
    assert diag_backend.main(["--cpu", "--frames", str(DIAG_FRAMES)]) == 0
    out_t = capsys.readouterr().out
    (j, j_asked), (t, t_asked) = made_j[0], made_t[0]
    assert t_asked == torch.float32 and j_asked == jnp.float32 and t.deskew_translation
    _same_systems(t, j)
    nk = len(t.kf_stamps)
    fe_j = np.linalg.norm(np.stack(j.trajectory) - r["gt"], axis=1)
    be_j = np.linalg.norm(np.asarray(j.graph.t[:nk]) - r["gt"][r["kf_frames"]], axis=1)
    np.testing.assert_allclose(r["frontend_ate"], np.sqrt((fe_j ** 2).mean()), atol=TOL_M)
    np.testing.assert_allclose(r["backend_ate"], np.sqrt((be_j ** 2).mean()), atol=TOL_M)
    assert np.isfinite(r["frontend_ate"]) and np.isfinite(r["backend_ate"])
    printed = {k: float(v) for k, v in re.findall(r"^(\w+)\s+ATE RMSE ([\d.]+) m", out_t, re.M)}
    np.testing.assert_allclose(printed["frontend"], r["frontend_ate"], atol=5e-4)
    np.testing.assert_allclose(printed["backend"], r["backend_ate"], atol=5e-4)
