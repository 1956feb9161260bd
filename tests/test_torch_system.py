"""models/system: the port's ``LiliOmSystem`` (spin variant) against the JAX
one, both in float64 on the CPU, at the sizes of tests/test_system.py.

* A short run: 9 simulated scans (16×720) with the whole IMU stream pushed
  up front, free-running on both sides. The frontend trajectories, the
  keyframe stamps, the graph poses and the densified every-frame poses
  agree to 1e-6 (measured ≤ 5e-8). The odometry is wired as the
  fr_iosb_rot preset at the small caps of test_torch_common (one matching
  round of up to 12 GN steps): with tests/test_system.py's two rounds of
  four steps the second round's search meets a near-tie at scan 4 of this
  run, and the 1e-11 rounding gap of the two packages becomes 1.5e-4 m.
* The handcrafted revisit of tests/test_system.py: seven keyframes whose
  last mature one revisits the first with a drift. Both systems must fire;
  the graph after the closure, the corrected window and ring poses and the
  dropped prior agree to 1e-6 (ICP and the suffix solve agree to 1e-9 on
  their own, test_torch_icp.py and test_torch_pose_graph.py).
* The Livox variant: 9 simulated Horizon sweeps of 6 × 680 points, binned
  at ``n_cols = 680`` (matched to the density: the Horizon's 4000 columns
  would starve the extractor), cast from the ``fr_iosb`` preset's sensor
  pose on the same circle, the preset wired whole (reflectivity-weighted
  fusion, 15 GN and LM iterations) at tests/test_golden_motion.py's reduced
  caps. Trajectories, keyframes, graph poses and the archived clouds agree
  to 1e-6 (measured ≤ 3e-8). The port runs it twice, inline and with
  ``defer_backend`` + ``process_keyframe``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.models.fusion import FusionConfig as JF
from lili_om_tpu.models.odometry import OdometryConfig as JO
from lili_om_tpu.models.pose_graph import add_node as j_add_node
from lili_om_tpu.models.system import LiliOmSystem as JSystem
from lili_om_tpu.models.system import LoopClosureConfig as JLC
from lili_om_tpu.ops.features_spin import SpinFeatureConfig as JS
from lili_om_tpu.utils.config import load_config as j_load_config
from lili_om_tpu_torch.models.fusion import FusionConfig as TF
from lili_om_tpu_torch.models.odometry import OdometryConfig as TO
from lili_om_tpu_torch.models.pose_graph import add_node as t_add_node
from lili_om_tpu_torch.models.system import LiliOmSystem as TSystem
from lili_om_tpu_torch.models.system import LivoxKeyframePayload
from lili_om_tpu_torch.models.system import LoopClosureConfig as TLC
from lili_om_tpu_torch.ops.features_spin import SpinFeatureConfig as TS
from lili_om_tpu_torch.sim.lidar import livox_pattern, simulate_scan, spinning_pattern
from lili_om_tpu_torch.sim.trajectory import circle_trajectory, pose_at, simulate_imu
from lili_om_tpu_torch.sim.world import make_room_world
from lili_om_tpu_torch.utils.config import load_config as t_load_config
from lili_om_tpu_torch.utils.math import quat_conj_np, quat_rotate_np
from test_torch_common import CPU, npy

R, C, PERIOD, N_SCANS = 16, 720, 0.1, 9
TOL = 1e-6

ODO = dict(n_recent_frames=6, scan_cap=2048, query_cap=1024, map_cap=8192, frame_cap=1024,
           scan_match_cnt=1, gn_iters=12)
FUS = dict(window=3, local_map_width=6, kf_surf_cap=2048, kf_edge_cap=1024,
           map_surf_cap=8192, map_edge_cap=1024, use_reflectivity=False, weight_gate=0.3,
           lidar_const=7.5, max_num_iter=3, imu_cap=64)


def make_port_system(**lc):
    """tests/test_system.py's make_system, the port's side only."""
    return TSystem(odo_cfg=TO(**ODO), fusion_cfg=TF(**FUS), feat_cfg=TS(surf_cap=2048),
                   lc_cfg=TLC(**lc), graph_capacity=64, dtype=torch.float64, device=CPU)


def make_systems(**lc):
    """tests/test_system.py's make_system, on both sides."""
    j = JSystem(odo_cfg=JO(**ODO), fusion_cfg=JF(**FUS), feat_cfg=JS(surf_cap=2048),
                lc_cfg=JLC(**lc), graph_capacity=64, dtype=jnp.float64)
    return j, make_port_system(**lc)


@pytest.fixture(scope="module")
def short_run():
    world = make_room_world(dtype=torch.float64, device=CPU)
    traj = circle_trajectory(radius=8.0, period=40.0)
    pattern = spinning_pattern(n_rings=R, n_cols=C, dtype=torch.float64, device=CPU)
    imu = simulate_imu(traj, 0.0, N_SCANS * PERIOD + PERIOD, rate=200.0, device=CPU)
    _, q0 = pose_at(traj, 0.0, device=CPU)
    js, ts = make_systems()
    for s in (js, ts):
        assert s.set_initial_orientation(npy(q0))
        s.push_imu(npy(imu.stamps), npy(imu.accs), npy(imu.gyrs))
    for k in range(N_SCANS):
        scan = simulate_scan(world, traj, k * PERIOD, pattern, period=PERIOD)
        args = (npy(scan.pts).reshape(R, C, 3), npy(scan.valid).reshape(R, C),
                npy(scan.rel_time).reshape(R, C), k * PERIOD)
        js.process_scan(*args)
        ts.process_scan(*args)
    return js, ts


def test_frames_and_keyframes_flow(short_run):
    js, ts = short_run
    assert ts.n_frames == js.n_frames == N_SCANS
    assert ts.kf_stamps == js.kf_stamps and 3 <= len(ts.kf_stamps) <= N_SCANS
    assert int(ts.graph.n_nodes) == len(ts.kf_stamps)
    assert set(ts.metrics.report()) >= {"preprocess", "odometry", "backend", "_throughput"}


def test_trajectory_matches_jax(short_run):
    js, ts = short_run
    np.testing.assert_allclose(np.asarray(ts.trajectory), np.asarray(js.trajectory),
                               rtol=TOL, atol=TOL)


def test_graph_poses_match_jax(short_run):
    js, ts = short_run
    n = len(js.kf_stamps)
    np.testing.assert_allclose(npy(ts.graph.t[:n]), np.asarray(js.graph.t[:n]), atol=TOL)
    np.testing.assert_allclose(npy(ts.graph.q[:n]), np.asarray(js.graph.q[:n]), atol=TOL)
    np.testing.assert_allclose(npy(ts.graph.rel_t[:n]), np.asarray(js.graph.rel_t[:n]),
                               atol=TOL)


def test_dense_trajectory_matches_jax(short_run):
    js, ts = short_run
    assert [s for s, _, _ in ts.dense_trajectory] == [s for s, _, _ in js.dense_trajectory]
    for (_, tj, qj), (_, tt_, qt) in zip(js.dense_trajectory, ts.dense_trajectory):
        np.testing.assert_allclose(tt_, np.asarray(tj), atol=TOL)
        np.testing.assert_allclose(qt, np.asarray(qj), atol=TOL)


def test_archive_matches_jax(short_run):
    """Archives stay device tensors until first use; the materialized
    keyframe clouds equal the JAX ones."""
    js, ts = short_run
    assert len(ts.kf_clouds) == len(ts.kf_stamps) == len(ts.kf_positions)
    assert isinstance(ts.kf_edge_clouds[0], tuple)
    for i in range(len(ts.kf_clouds)):
        a, b = js._kf_cloud_np(i), ts._kf_cloud_np(i)
        assert b.shape == a.shape and len(b) > 0
        np.testing.assert_allclose(b, a, atol=TOL)
    assert isinstance(ts.kf_clouds[0], np.ndarray)  # cached on the host now


def test_no_loop_closure_on_short_run(short_run):
    js, ts = short_run
    assert not ts.try_loop_closure() and not js.try_loop_closure()
    assert int(ts.graph.n_loops) == 0 and ts.lc_rejects == js.lc_rejects


def _revisit_cloud():
    """One real room scan from the origin, subsampled (tests/test_system.py)."""
    world = make_room_world(dtype=torch.float64, device=CPU)
    pattern = spinning_pattern(n_rings=R, n_cols=C, dtype=torch.float64, device=CPU)
    still = lambda t: (torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64).expand(
        *torch.as_tensor(t).shape, 3), torch.tensor([1.0, 0, 0, 0], dtype=torch.float64))
    scan = simulate_scan(world, still, 0.0, pattern, period=PERIOD)
    pts = npy(scan.pts)[npy(scan.valid)]
    return pts[::max(1, len(pts) // 4000)]


def test_revisit_closes_like_jax():
    pts = _revisit_cloud()
    # submaps of 4096 rows (the scan's 0.4 m voxels decimated by stride to
    # fit) keep the CPU run short: 21 plain float64 searches of 16384×16384
    # take minutes here
    js, ts = make_systems(time_thres=5.0, search_radius=5.0, icp_thres=0.2, map_width=2,
                          latest_width=1, submap_cap=4096)
    drift = np.array([0.35, -0.2, 0.1])
    qid = np.array([1.0, 0, 0, 0])
    poses = [np.zeros(3), np.array([20.0, 0, 0]), np.array([20.0, 20.0, 0]),
             np.array([0.0, 20.0, 0]), drift, drift + np.array([0.5, 0.0, 0.0]),
             drift + np.array([1.0, 0.0, 0.0])]
    for t, s in zip(poses, [0.0, 3.0, 6.0, 9.0, 12.0, 13.0, 14.0]):
        js.graph = j_add_node(js.graph, jnp.asarray(t), jnp.asarray(qid))
        ts.graph = t_add_node(ts.graph, torch.as_tensor(t), torch.as_tensor(qid))
        for sys_ in (js, ts):
            sys_.kf_stamps.append(s)
            sys_.kf_positions.append(t.copy())
            sys_.kf_clouds.append(pts.copy())
    assert js.try_loop_closure() and ts.try_loop_closure()
    assert int(ts.graph.n_loops) == int(js.graph.n_loops) == 1
    assert ts._loop_pairs == js._loop_pairs == [(4, 0)]
    for f in ("t", "q", "loop_t", "loop_q", "loop_weight"):
        np.testing.assert_allclose(npy(getattr(ts.graph, f)), np.asarray(getattr(js.graph, f)),
                                   atol=TOL, err_msg=f)
    # the drifted node moved back toward the origin, as in the JAX test
    assert np.linalg.norm(npy(ts.graph.t[4])) < 0.6 * np.linalg.norm(drift)
    jf, tf = js.fusion_state, ts.fusion_state
    for f in ("t", "q", "hist_t", "hist_q"):
        np.testing.assert_allclose(npy(getattr(tf, f)), np.asarray(getattr(jf, f)), atol=TOL,
                                   err_msg=f)
    assert not bool(tf.prior.valid) and bool(tf.sb_anchor_on)
    assert ts._maps_dirty and js._maps_dirty
    np.testing.assert_allclose(np.asarray(ts.kf_positions), np.asarray(js.kf_positions),
                               atol=TOL)


def test_health_check_recovers():
    _, ts = make_systems()
    assert not ts.health_check_and_recover()
    ts.graph = t_add_node(ts.graph, torch.tensor([1.0, 2.0, 0.0], dtype=torch.float64),
                          torch.tensor([1.0, 0, 0, 0], dtype=torch.float64))
    ts.kf_positions.append(np.array([1.0, 2.0, 0.0]))
    ts.kf_stamps.append(0.0)
    t = ts.fusion_state.t.clone()
    t[1, 0] = float("nan")
    ts.fusion_state = ts.fusion_state._replace(t=t)
    assert ts.health_check_and_recover()
    assert torch.all(torch.isfinite(ts.fusion_state.t))
    np.testing.assert_allclose(npy(ts.fusion_state.t[0]), [1.0, 2.0, 0.0])
    assert not bool(ts.fusion_state.prior.valid)


def test_imu_buffer_bulk_push_and_trim():
    _, ts = make_systems()
    t = np.arange(0, 30.0, 0.005)
    ts.push_imu(t, np.zeros((len(t), 3)), np.zeros((len(t), 3)))
    assert ts._imu_slice(0.1, 0.2) is not None and ts._imu_slice(25.0, 25.1) is not None
    ts._trim_imu(1.0)
    assert ts._imu_slice(0.1, 0.2) is None and ts._imu_slice(1.0, 1.1) is not None


class _OneRankMesh:
    """What ``LiliOmSystem.__init__`` reads of a 1-rank CPU mesh (building
    the system runs no collective)."""

    device_type, mesh_dim_names = "cpu", ("kf",)

    def size(self):
        return 1

    def get_local_rank(self):
        return 0


def test_unported_options_raise(tmp_path):
    """``mesh`` is ported (tests/test_torch_map_fusion.py), and so is
    ``PipelineRunner`` over a mesh system: on a one-rank gloo world the
    runner takes the mesh system, gives it its two process groups, counts
    closures in scans and checks the replicated state at ``stop()``. Still
    refused: a ``device`` other than the mesh's."""
    import torch.distributed as dist

    from lili_om_tpu_torch.parallel.sharded import make_mesh
    from lili_om_tpu_torch.runtime.pipeline import PipelineRunner

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0)
    try:
        sys_ = TSystem(mesh=make_mesh(1, "kf", device=CPU), device=CPU)
        runner = PipelineRunner(sys_, loop_period_s=1.0, scan_period=0.1)
        assert runner.mesh is sys_.mesh and runner.closure_every == 10
        assert sys_._closure_group is runner._back_group is not sys_.mesh.get_group()
        runner.start()
        runner.stop(drain=True)
        assert runner.replicated is True and runner.n_processed == 0
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError):
        TSystem(mesh=_OneRankMesh(), device="cuda")


def test_mesh_runner_drops_by_rank0(tmp_path):
    """On a mesh with ``drop_when_full`` the runner's queue never drops on
    its own (unbounded): when the frontend takes a scan, rank 0 drops it if
    ``queue_size`` scans or more wait behind it, and every rank gets that
    decision (here a one-rank gloo world)."""
    import torch.distributed as dist

    from lili_om_tpu_torch.parallel.sharded import make_mesh
    from lili_om_tpu_torch.runtime.pipeline import PipelineRunner

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0)
    try:
        runner = PipelineRunner(TSystem(mesh=make_mesh(1, "kf", device=CPU), device=CPU),
                                queue_size=2, drop_when_full=True)
        for k in range(4):
            runner._ready.put_nowait(k)
        taken = [(runner._ready.get_nowait(), runner._rank0_drops()) for _ in range(4)]
        assert taken == [(0, True), (1, True), (2, False), (3, False)]
    finally:
        dist.destroy_process_group()


# --- the Livox variant ------------------------------------------------------

LIVOX_PTS = 680


def _livox_cfgs(load):
    """The fr_iosb preset at tests/test_golden_motion.py's reduced caps."""
    c = load("fr_iosb")
    odo = c.odometry._replace(scan_cap=4096, query_cap=1024, map_cap=8192, frame_cap=1024,
                              n_recent_frames=10)
    fus = c.fusion._replace(kf_surf_cap=1024, kf_edge_cap=512, map_surf_cap=8192,
                            map_edge_cap=1024, local_map_width=12, imu_cap=64)
    return dict(odo_cfg=odo, fusion_cfg=fus, livox_cfg=c.livox_features._replace(
        n_cols=LIVOX_PTS), lc_cfg=c.loop_closure, noise=c.imu_noise, graph_capacity=64)


@pytest.fixture(scope="module")
def livox_run():
    """The JAX system inline, the port inline and the port deferred, over
    the same sweeps. Returns (jax, port inline, port deferred, payloads)."""
    kw = _livox_cfgs(t_load_config)
    fus = kw["fusion_cfg"]
    q_sl = quat_conj_np(np.asarray(fus.q_lb, float)[None])[0]
    t_sl = -quat_rotate_np(q_sl[None], np.asarray(fus.t_lb, float)[None])[0]
    world = make_room_world(dtype=torch.float64, device=CPU)
    traj = circle_trajectory(radius=8.0, period=40.0)
    pattern = livox_pattern(pts_per_line=LIVOX_PTS, dtype=torch.float64, device=CPU)
    imu = simulate_imu(traj, 0.0, N_SCANS * PERIOD + PERIOD, rate=200.0, device=CPU)
    _, q0 = pose_at(traj, 0.0, device=CPU)
    js = JSystem(**_livox_cfgs(j_load_config), dtype=jnp.float64)
    ts = TSystem(**kw, dtype=torch.float64, device=CPU)
    td = TSystem(**kw, dtype=torch.float64, device=CPU)
    for s in (js, ts, td):
        assert s.set_initial_orientation(npy(q0))
        s.push_imu(npy(imu.stamps), npy(imu.accs), npy(imu.gyrs))
    payloads = []
    for k in range(N_SCANS):
        sc = simulate_scan(world, traj, k * PERIOD, pattern, period=PERIOD, t_sl=t_sl,
                           q_sl=q_sl)
        args = (npy(sc.pts), npy(sc.line), npy(sc.rel_time), npy(sc.reflectivity),
                npy(sc.valid), k * PERIOD)
        js.process_scan_livox(*args)
        ts.process_scan_livox(*args)
        out, payload = td.process_scan_livox(*args, defer_backend=True)
        assert (payload is not None) == out.is_keyframe
        if payload is not None:
            payloads.append(payload)
            td.process_keyframe(payload, k * PERIOD)
    return js, ts, td, payloads


@pytest.mark.parametrize("which", ["inline", "deferred"])
def test_livox_run_matches_jax(livox_run, which):
    js, ts, td, _ = livox_run
    t = ts if which == "inline" else td
    assert t.n_frames == js.n_frames == N_SCANS
    assert t.kf_stamps == js.kf_stamps and len(t.kf_stamps) >= 3
    np.testing.assert_allclose(np.asarray(t.trajectory), np.asarray(js.trajectory),
                               rtol=TOL, atol=TOL)
    n = len(js.kf_stamps)
    for f in ("t", "q"):
        np.testing.assert_allclose(npy(getattr(t.graph, f)[:n]),
                                   np.asarray(getattr(js.graph, f)[:n]), atol=TOL, err_msg=f)
    for i in range(n):
        np.testing.assert_allclose(t._kf_cloud_np(i), js._kf_cloud_np(i), atol=TOL)
    # the reflectivity-weighted fusion matched surfaces on the last keyframe
    assert int(t.last_fusion_out.n_surf_corr) == int(js.last_fusion_out.n_surf_corr) > 100
    # the keyframe ring carries the reflectivity channel (0.1·reflectivity)
    refl = npy(t.fusion_state.hist_surf_refl)[npy(t.fusion_state.hist_surf_mask)]
    np.testing.assert_allclose(refl, np.asarray(js.fusion_state.hist_surf_refl)[
        np.asarray(js.fusion_state.hist_surf_mask)], atol=TOL)
    assert 0.5 < refl.min() and refl.max() < 1.7


def test_livox_deferred_payloads(livox_run):
    """``defer_backend`` hands the backend a LivoxKeyframePayload per
    keyframe: the downsampled surf cloud with its reflectivity, the edge
    cloud padded to the keyframe edge capacity, and the full sweep."""
    js, _, td, payloads = livox_run
    fus = td.fusion_cfg
    assert len(payloads) == len(js.kf_stamps)
    for p in payloads:
        assert isinstance(p, LivoxKeyframePayload)
        assert p.surf.shape == (td.odo_cfg.scan_cap, 3) and p.surf_refl.shape == p.surf_mask.shape
        assert p.edge.shape == (fus.kf_edge_cap, 3) and p.full_pts.shape == (6 * LIVOX_PTS, 3)
        assert bool(p.surf_mask.any()) and bool(p.edge_mask.any())
        assert bool((p.surf_refl[p.surf_mask] > 0.0).all())
