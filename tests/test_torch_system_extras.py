"""models/system: two options of ``LiliOmSystem`` against the JAX one, both
in float64 on the CPU at the small caps of tests/test_torch_system.py.

* ``if_to_deskew``, the reference's republish re-skew (JAX side:
  tests/test_round4_fixes.py): with it on, every keyframe's archived surf,
  edge and full clouds are shifted by their sweep-time fraction of the
  frame's relative translation. Spin (2 scans of 16×720) and Livox (2
  Horizon sweeps of 6 × 680): the archived clouds and the trajectory agree
  with the JAX system's to 1e-6, as the runs of test_torch_system.py do,
  and the option moves the clouds by at most one sweep's motion.
* ``spill_archives`` / ``archive_spill_dir`` (JAX side:
  tests/test_round5_fixes.py): keyframe clouds older than
  ``archive_keep_recent`` go to .npy files, the resident archive stays
  bounded, a spilled cloud reloads bit for bit and is not cached again, loop
  closure reads the spilled clouds (the same closure as without spilling,
  and as the JAX system's), and with no directory set it is a no-op.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.models.pose_graph import add_node as j_add_node
from lili_om_tpu.models.system import LiliOmSystem as JSystem
from lili_om_tpu.utils.config import load_config as j_load_config
from lili_om_tpu_torch.models.pose_graph import add_node as t_add_node
from lili_om_tpu_torch.models.system import LiliOmSystem as TSystem
from lili_om_tpu_torch.sim.lidar import livox_pattern, simulate_scan, spinning_pattern
from lili_om_tpu_torch.sim.trajectory import circle_trajectory, pose_at, simulate_imu
from lili_om_tpu_torch.sim.world import make_room_world
from lili_om_tpu_torch.utils.config import load_config as t_load_config
from lili_om_tpu_torch.utils.math import quat_conj_np, quat_rotate_np
from test_torch_common import CPU, npy
from test_torch_system import LIVOX_PTS, PERIOD, R, C, TOL, _livox_cfgs, _revisit_cloud, \
    make_port_system, make_systems

N_DESKEW = 2  # scans: two keyframes, the second one in motion (rel_trans nonzero)
RADIUS, LAP_S = 8.0, 40.0


def _archives(s):
    """Every keyframe's surf, edge and full cloud on the host."""
    return [s._kf_cloud_np(i, a) for a in (s.kf_clouds, s.kf_edge_clouds, s.kf_full_clouds)
            for i in range(len(a))]


def _spin_run(js, *ts):
    world = make_room_world(dtype=torch.float64, device=CPU)
    traj = circle_trajectory(radius=RADIUS, period=LAP_S)
    pattern = spinning_pattern(n_rings=R, n_cols=C, dtype=torch.float64, device=CPU)
    imu = simulate_imu(traj, 0.0, N_DESKEW * PERIOD + PERIOD, rate=200.0, device=CPU)
    _, q0 = pose_at(traj, 0.0, device=CPU)
    for s in (js, *ts):
        assert s.set_initial_orientation(npy(q0))
        s.push_imu(npy(imu.stamps), npy(imu.accs), npy(imu.gyrs))
    for k in range(N_DESKEW):
        scan = simulate_scan(world, traj, k * PERIOD, pattern, period=PERIOD)
        args = (npy(scan.pts).reshape(R, C, 3), npy(scan.valid).reshape(R, C),
                npy(scan.rel_time).reshape(R, C), k * PERIOD)
        for s in (js, *ts):
            s.process_scan(*args)


def _livox_run(js, *ts):
    kw = _livox_cfgs(t_load_config)
    fus = kw["fusion_cfg"]
    q_sl = quat_conj_np(np.asarray(fus.q_lb, float)[None])[0]
    t_sl = -quat_rotate_np(q_sl[None], np.asarray(fus.t_lb, float)[None])[0]
    world = make_room_world(dtype=torch.float64, device=CPU)
    traj = circle_trajectory(radius=RADIUS, period=LAP_S)
    pattern = livox_pattern(pts_per_line=LIVOX_PTS, dtype=torch.float64, device=CPU)
    imu = simulate_imu(traj, 0.0, N_DESKEW * PERIOD + PERIOD, rate=200.0, device=CPU)
    _, q0 = pose_at(traj, 0.0, device=CPU)
    for s in (js, *ts):
        assert s.set_initial_orientation(npy(q0))
        s.push_imu(npy(imu.stamps), npy(imu.accs), npy(imu.gyrs))
    for k in range(N_DESKEW):
        sc = simulate_scan(world, traj, k * PERIOD, pattern, period=PERIOD, t_sl=t_sl,
                           q_sl=q_sl)
        args = (npy(sc.pts), npy(sc.line), npy(sc.rel_time), npy(sc.reflectivity),
                npy(sc.valid), k * PERIOD)
        for s in (js, *ts):
            s.process_scan_livox(*args)


def _deskew_systems(variant):
    if variant == "spin":
        js, ts = make_systems()
        t_off = make_port_system()
    else:
        js = JSystem(**_livox_cfgs(j_load_config), dtype=jnp.float64)
        ts, t_off = (TSystem(**_livox_cfgs(t_load_config), dtype=torch.float64, device=CPU)
                     for _ in range(2))
    js.if_to_deskew = ts.if_to_deskew = True
    (_spin_run if variant == "spin" else _livox_run)(js, ts, t_off)
    return js, ts, t_off


@pytest.mark.parametrize("variant", ["spin", "livox"])
def test_if_to_deskew_matches_jax(variant):
    js, ts, t_off = _deskew_systems(variant)
    assert ts.kf_stamps == js.kf_stamps == t_off.kf_stamps and len(ts.kf_stamps) >= 2
    np.testing.assert_allclose(np.asarray(ts.trajectory), np.asarray(js.trajectory),
                               rtol=TOL, atol=TOL)
    for a, b in zip(_archives(ts), _archives(js), strict=True):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=TOL)
    # the option moved the clouds of the keyframes after the first (the
    # relative translation is nonzero in motion), by at most one sweep's
    # travel; the frontend does not see it
    np.testing.assert_array_equal(np.asarray(ts.trajectory), np.asarray(t_off.trajectory))
    moved = 0.0
    for i in range(1, len(ts.kf_stamps)):
        a, b = ts._kf_cloud_np(i), t_off._kf_cloud_np(i)
        assert a.shape == b.shape
        moved = max(moved, float(np.linalg.norm(a - b, axis=1).max()))
    speed = 2 * np.pi * RADIUS / LAP_S
    assert 1e-4 < moved <= speed * PERIOD + 1e-3


def _spill_fill(s, cloud, n, add_node, arr):
    """n keyframes with the same clouds in all three archives, spilling
    after each as the system does."""
    for i in range(n):
        s.graph = add_node(s.graph, arr(np.array([float(i), 0.0, 0.0])),
                           arr(np.array([1.0, 0.0, 0.0, 0.0])))
        s.kf_stamps.append(float(i))
        s.kf_positions.append(np.array([float(i), 0.0, 0.0]))
        for archive in (s.kf_clouds, s.kf_edge_clouds, s.kf_full_clouds):
            archive.append(cloud.copy())
        s.spill_archives()


def test_spill_bounds_residency_like_jax(tmp_path):
    cloud = np.random.default_rng(0).uniform(-5.0, 5.0, (900, 3))
    js, ts = make_systems()
    for s, name in ((js, "jax"), (ts, "port")):
        s.archive_spill_dir = str(tmp_path / name)
        s.archive_keep_recent = 3
    _spill_fill(js, cloud, 10, j_add_node, jnp.asarray)
    _spill_fill(ts, cloud, 10, t_add_node, torch.as_tensor)
    for a_t, a_j in ((ts.kf_clouds, js.kf_clouds), (ts.kf_edge_clouds, js.kf_edge_clouds),
                     (ts.kf_full_clouds, js.kf_full_clouds)):
        kinds = [isinstance(c, str) for c in a_t]
        assert kinds == [isinstance(c, str) for c in a_j] == [True] * 7 + [False] * 3
        assert [c.rsplit("/", 1)[1] for c in a_t[:7]] == [c.rsplit("/", 1)[1] for c in a_j[:7]]
    # a spilled cloud reloads bit for bit and stays a path (no re-caching)
    np.testing.assert_array_equal(ts._kf_cloud_np(0), cloud)
    np.testing.assert_array_equal(ts._kf_cloud_np(0, ts.kf_full_clouds),
                                  js._kf_cloud_np(0, js.kf_full_clouds))
    assert isinstance(ts.kf_clouds[0], str)
    # spilling again moves nothing: the watermarks stand
    assert ts.spill_archives() == js.spill_archives() == 0


def test_spill_disabled_is_noop():
    js, ts = make_systems()
    for s in (js, ts):
        s.kf_stamps.append(0.0)
        s.kf_clouds.append(np.ones((4, 3)))
    assert ts.spill_archives() == js.spill_archives() == 0
    assert isinstance(ts.kf_clouds[0], np.ndarray)


def test_loop_closure_reads_spilled_clouds(tmp_path):
    """The revisit of test_torch_system.py at 1024-row submaps, with every
    keyframe but the last two spilled: the closure fires on the reloaded
    clouds, with the same graph as the JAX system spilling alike and as the
    port without spilling. The submaps decimate the scan 4-fold, which
    raises the fitness of the aligned pair to ~0.3 on both sides, so the
    gate is 1.0 here (0.2 at the full cloud)."""
    pts = _revisit_cloud()[::4]
    lc = dict(time_thres=5.0, search_radius=5.0, icp_thres=1.0, map_width=2, latest_width=1,
              submap_cap=1024)
    js, ts = make_systems(**lc)
    t_ref = make_port_system(**lc)
    for s, name in ((js, "jax"), (ts, "port")):
        s.archive_spill_dir = str(tmp_path / name)
        s.archive_keep_recent = 2
    drift = np.array([0.35, -0.2, 0.1])
    poses = [np.zeros(3), np.array([20.0, 0, 0]), np.array([20.0, 20.0, 0]),
             np.array([0.0, 20.0, 0]), drift, drift + np.array([0.5, 0.0, 0.0]),
             drift + np.array([1.0, 0.0, 0.0])]
    qid = np.array([1.0, 0, 0, 0])
    for t, stamp in zip(poses, [0.0, 3.0, 6.0, 9.0, 12.0, 13.0, 14.0]):
        js.graph = j_add_node(js.graph, jnp.asarray(t), jnp.asarray(qid))
        for s in (ts, t_ref):
            s.graph = t_add_node(s.graph, torch.as_tensor(t), torch.as_tensor(qid))
        for s in (js, ts, t_ref):
            s.kf_stamps.append(stamp)
            s.kf_positions.append(t.copy())
            s.kf_clouds.append(pts.copy())
            s.spill_archives()
    assert [isinstance(c, str) for c in ts.kf_clouds] == [True] * 5 + [False] * 2
    assert js.try_loop_closure() and ts.try_loop_closure() and t_ref.try_loop_closure()
    assert ts._loop_pairs == js._loop_pairs == t_ref._loop_pairs == [(4, 0)]
    for f in ("t", "q", "loop_t", "loop_q", "loop_weight"):
        np.testing.assert_allclose(npy(getattr(ts.graph, f)), np.asarray(getattr(js.graph, f)),
                                   atol=TOL, err_msg=f)
        assert torch.equal(getattr(ts.graph, f), getattr(t_ref.graph, f)), f
    # the spilled clouds stayed on disk
    assert all(isinstance(c, str) for c in ts.kf_clouds[:5])
