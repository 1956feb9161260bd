"""parallel/map_fusion.py and ``LiliOmSystem(mesh=…)``: the port's
map-sharded backend on 2 spawned gloo ranks on the CPU (one world for the
module, torch_dist_ranks.py), against the JAX package on the conftest's
virtual CPU mesh of 2 devices and against the port on one process, in
float64.

* The map-sharded step on tests/test_map_fusion.py's filled ring (every
  slot a plane patch 10 m from the next, so no voxel spans two ranks'
  slots and the per-rank deduplication equals the global one): the new
  state and ``FusionOut`` to 1e-8 against JAX's sharded step, JAX's
  single-device ``fusion_step(incremental_map=False)`` and the port's, the
  marginal prior through JᵀJ and Jᵀr0 (its square root is unique only up to
  signs) relative to its largest entry. The merge makes the same
  candidates as one search over the whole map (bit for bit on the port's
  side); what remains is the packages' rounding through two LM iterations.
* The warmup variant (no search) on a fresh state, to 1e-8.
* The port's single-process ``fusion_step`` with ``incremental_map=False``
  against JAX's on the same ring, to 1e-8.
* ``LiliOmSystem(mesh=…)``'s config rounding at the ``fr_iosb_rot`` preset
  (M = 50) on 4 ranks, field for field against JAX's system on a 4-device
  mesh; the port's system is built on a one-process stand-in of a 4-rank
  mesh (construction runs no collective).
* The slice as a whole: ``LiliOmSystem(mesh=…)`` on 2 ranks over 6
  simulated 16×720 scans against JAX's ``LiliOmSystem(mesh=make_mesh(2))``
  (trajectory, keyframe stamps and graph to 1e-6 m: the systems run the
  same per-shard maps, and the gap is the packages' rounding carried
  through the odometry, measured ≤ 5e-8 as in test_torch_system.py), and
  against the port's single-device system, whose incremental map tables
  deduplicate voxels over the whole ring (0.05 m, JAX's own bound,
  tests/test_sharded_frontend.py). Every rank's replicated-state digest is
  equal, and ``check_replicated`` finds nothing to repair.
* Loop closure under the mesh: the same system with closure attempts after
  every scan from the fourth on (rank 0 attempts, the others take its
  outcome) fires on the same scans as the port's single-device system with
  the same configuration, and their graphs agree to 0.05 m. When one rank's
  state is moved, ``check_replicated`` finds it on every rank and every
  rank takes rank 0's state.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from lili_om_tpu.models import fusion as JFu
from lili_om_tpu.models.odometry import OdometryConfig as JO
from lili_om_tpu.models.system import LiliOmSystem as JSystem
from lili_om_tpu.models.system import LoopClosureConfig as JLC
from lili_om_tpu.ops.features_spin import SpinFeatureConfig as JS
from lili_om_tpu.ops.preintegration import ImuNoise as JNoise
from lili_om_tpu.parallel.map_fusion import make_map_sharded_fusion
from lili_om_tpu.parallel.sharded import make_mesh
from lili_om_tpu.utils.config import load_config as j_load_config
from lili_om_tpu_torch.models import fusion as TFu
from lili_om_tpu_torch.models.system import LiliOmSystem as TSystem
from lili_om_tpu_torch.ops.preintegration import ImuNoise as TNoise
from lili_om_tpu_torch.utils.config import load_config as t_load_config
from test_torch_common import CPU, assert_close_dicts, npy, state_dict, tree_dict

R_, C_, PERIOD, N_SCANS, N_LC_SCANS = 16, 720, 0.1, 6, 10
STATE_TOL, PRIOR_TOL = 1e-8, 1e-8
SYS_TOL, SHARD_TOL = 1e-6, 0.05


def _jax_cfg():
    return JFu.FusionConfig(**R.fusion_config()._asdict())


def _jax_args(cfg):
    return [jnp.asarray(a) for a in R.scan_inputs(cfg, JNoise().g_norm)]


def _jax_filled(cfg, noise):
    st = JFu.init_fusion_state(cfg, noise, dtype=jnp.float64)
    return st._replace(**{k: jnp.asarray(v) for k, v in R.filled_ring(cfg).items()})


def sim_scans(n):
    """``n`` simulated 16×720 sweeps on tests/test_sharded_frontend.py's
    circle and the IMU over them, as numpy."""
    from lili_om_tpu_torch.sim.lidar import simulate_scan, spinning_pattern
    from lili_om_tpu_torch.sim.trajectory import circle_trajectory, simulate_imu
    from lili_om_tpu_torch.sim.world import make_room_world

    world = make_room_world(dtype=torch.float64, device=CPU)
    traj = circle_trajectory(radius=8.0, period=40.0)
    pattern = spinning_pattern(n_rings=R_, n_cols=C_, dtype=torch.float64, device=CPU)
    imu = simulate_imu(traj, 0.0, (n + 2) * PERIOD, rate=200.0, device=CPU)
    out = {"n": n, "imu_stamps": npy(imu.stamps), "imu_accs": npy(imu.accs),
           "imu_gyrs": npy(imu.gyrs)}
    for k in range(n):
        s = simulate_scan(world, traj, k * PERIOD, pattern, period=PERIOD)
        out.update({f"img_{k}": npy(s.pts).reshape(R_, C_, 3),
                    f"valid_{k}": npy(s.valid).reshape(R_, C_),
                    f"rel_{k}": npy(s.rel_time).reshape(R_, C_), f"stamp_{k}": k * PERIOD})
    return out


@pytest.fixture(scope="module")
def scans():
    return sim_scans(N_LC_SCANS)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, scans):
    work = tmp_path_factory.mktemp("map_fusion_ranks")
    np.savez(work / "scans.npz", n_sys=N_SCANS, **scans)
    return R.Ranks(R.map_fusion_ranks, 2, work, axis="kf")


@pytest.fixture(scope="module")
def jax_steps(ranks):
    """JAX's map-sharded main step on the filled ring and warmup step on a
    fresh state (2 devices), and its single-device batch-map step (the
    ranks run meanwhile)."""
    cfg, noise = _jax_cfg(), JNoise()
    mesh = make_mesh(2, axis="kf")
    args = _jax_args(cfg)
    main, _ = make_map_sharded_fusion(mesh, cfg, noise)
    warm, _ = make_map_sharded_fusion(mesh, cfg, noise, warmup=True)
    filled = _jax_filled(cfg, noise)
    return {"main": main(filled, *args), "single": JFu.fusion_step(filled, *args, cfg, noise),
            "warm": warm(JFu.init_fusion_state(cfg, noise, dtype=jnp.float64), *args)}


def _port(ranks, prefix):
    ranks = ranks.results()
    for r in ranks[1:]:
        for k in ranks[0]:
            if k.startswith(prefix):
                np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    return {k[len(prefix):]: v for k, v in ranks[0].items() if k.startswith(prefix)}


def _prior_packed(d):
    """A flat state dict with the prior's (J, r0) as JᵀJ and Jᵀr0."""
    J, r0 = d.pop("prior.J"), d.pop("prior.r0")
    d["prior.JtJ"], d["prior.Jtr0"] = J.T @ J, J.T @ r0
    return d


def _same_states(port_state, port_out, jax_pair, what):
    js, jo = state_dict(jax_pair[0]), state_dict(jax_pair[1])
    ts = _prior_packed(dict(port_state))
    assert_close_dicts(jo, port_out, rtol=0.0, atol=STATE_TOL, what=f"{what} out")
    for k in ("prior.JtJ", "prior.Jtr0"):
        a, b = js.pop(k), ts.pop(k)
        np.testing.assert_allclose(b, a, rtol=0.0, atol=PRIOR_TOL * max(np.abs(a).max(), 1.0),
                                   err_msg=f"{what} {k}")
    assert_close_dicts(js, ts, rtol=0.0, atol=STATE_TOL, what=f"{what} state")


def test_map_sharded_fusion_matches_jax(ranks, jax_steps):
    st, out = _port(ranks, "main_state."), _port(ranks, "main_out.")
    assert int(out["n_surf_corr"]) > 50 and int(out["n_edge_corr"]) > 0
    _same_states(st, out, jax_steps["main"], "vs JAX sharded")
    _same_states(st, out, jax_steps["single"], "vs JAX single")
    np.testing.assert_array_equal(ranks.results()[0]["blocks"], [[0, 4], [4, 8]])


def test_map_sharded_fusion_matches_port_single(ranks):
    cfg, noise = R.fusion_config(), TNoise()
    fresh = TFu.init_fusion_state(cfg, noise, dtype=torch.float64, device=CPU)
    filled = fresh._replace(**{k: torch.as_tensor(v) for k, v in R.filled_ring(cfg).items()})
    args = [torch.as_tensor(a) for a in R.scan_inputs(cfg, noise.g_norm)]
    st, out = TFu.fusion_step(filled, *args, cfg, noise, device=CPU)
    sd, od = state_dict(st), state_dict(out)
    port = _prior_packed(_port(ranks, "main_state."))
    assert_close_dicts(od, _port(ranks, "main_out."), rtol=0.0, atol=STATE_TOL, what="out")
    assert_close_dicts(sd, port, rtol=0.0, atol=STATE_TOL, what="state")


def test_batch_map_fusion_step_matches_jax(jax_steps):
    """Single process, ``incremental_map=False``: the maps from the whole
    ring at every keyframe (``default_map_and_match``)."""
    cfg, noise = R.fusion_config(), TNoise()
    fresh = TFu.init_fusion_state(cfg, noise, dtype=torch.float64, device=CPU)
    filled = fresh._replace(**{k: torch.as_tensor(v) for k, v in R.filled_ring(cfg).items()})
    args = [torch.as_tensor(a) for a in R.scan_inputs(cfg, noise.g_norm)]
    st, out = TFu.fusion_step(filled, *args, cfg, noise, device=CPU)
    assert int(out.n_surf_corr) > 50
    _same_states(tree_dict(st), tree_dict(out), jax_steps["single"], "single process")


def test_map_sharded_warmup_matches_jax(ranks, jax_steps):
    st, out = _port(ranks, "warm_state."), _port(ranks, "warm_out.")
    assert int(st["kf_count"]) == 1
    _same_states(st, out, jax_steps["warm"], "warmup")


class _StandInMesh:
    """What ``LiliOmSystem.__init__`` reads of a 4-rank CPU mesh, in one
    process (rank 0)."""

    device_type, mesh_dim_names = "cpu", ("kf",)

    def size(self):
        return 4

    def get_local_rank(self):
        return 0


def test_mesh_config_rounding_matches_jax():
    j = j_load_config("fr_iosb_rot")
    t = t_load_config("fr_iosb_rot")
    js = JSystem(odo_cfg=j.odometry, fusion_cfg=j.fusion, lc_cfg=JLC(enabled=False),
                 mesh=make_mesh(4, axis="kf"), dtype=jnp.float64)
    ts = TSystem(odo_cfg=t.odometry, fusion_cfg=t.fusion, lc_cfg=R.LoopClosureConfig(
        enabled=False), mesh=_StandInMesh(), dtype=torch.float64)
    assert ts.fusion_cfg._asdict() == js.fusion_cfg._asdict()
    assert ts.odo_cfg._asdict() == js.odo_cfg._asdict()
    f = ts.fusion_cfg
    assert (f.local_map_width, f.map_slots_pad, f.incremental_map) == (50, 2, False)
    assert ts.fusion_state.hist_surf.shape[0] == 52
    assert ts.slot_blocks == [slice(0, 13), slice(13, 26), slice(26, 39), slice(39, 52)]


def _run_jax_mesh_system(scans):
    odo, fus, feat = R.system_configs()
    s = JSystem(odo_cfg=JO(**odo), fusion_cfg=JFu.FusionConfig(**fus), feat_cfg=JS(**feat),
                lc_cfg=JLC(enabled=False), graph_capacity=32, dtype=jnp.float64,
                mesh=make_mesh(2, axis="kf"))
    s.push_imu(scans["imu_stamps"], scans["imu_accs"], scans["imu_gyrs"])
    for k in range(N_SCANS):
        s.process_scan(scans[f"img_{k}"], scans[f"valid_{k}"], scans[f"rel_{k}"],
                       float(scans[f"stamp_{k}"]))
    return s


def test_mesh_system_matches_jax_and_single(ranks, scans):
    port = _port(ranks, "sys_")
    assert bool(port["replicated"])
    n_kf = len(port["kf_stamps"])
    assert n_kf >= 2
    js = _run_jax_mesh_system(scans)
    assert port["kf_stamps"].tolist() == js.kf_stamps
    np.testing.assert_allclose(port["trajectory"], np.asarray(js.trajectory), rtol=0.0,
                               atol=SYS_TOL)
    np.testing.assert_allclose(port["graph_t"], np.asarray(js.graph.t[:n_kf]), rtol=0.0,
                               atol=SYS_TOL)
    np.testing.assert_allclose(port["graph_q"], np.asarray(js.graph.q[:n_kf]), rtol=0.0,
                               atol=SYS_TOL)
    single = R.run_system(R.make_system(), scans, N_SCANS)
    assert single["kf_stamps"].tolist() == port["kf_stamps"].tolist()
    err = np.linalg.norm(single["graph_t"] - port["graph_t"], axis=1)
    assert err.max() < SHARD_TOL, err


def test_mesh_closures_match_single(ranks, scans):
    port = _port(ranks, "lc_")
    assert bool(port["replicated"])
    single = R.run_system(R.make_system(closures=True), scans, N_LC_SCANS, closures=True)
    assert port["fired"].tolist() == single["fired"].tolist() and port["fired"].any()
    assert int(port["n_loops"]) == int(single["n_loops"]) >= 1
    assert port["kf_stamps"].tolist() == single["kf_stamps"].tolist()
    err = np.linalg.norm(single["graph_t"] - port["graph_t"], axis=1)
    assert err.max() < SHARD_TOL, err


def test_check_replicated_repairs_a_diverged_rank(ranks):
    """Rank 1's window pose and last trajectory entry moved by 1e-9: every
    rank's ``check_replicated`` reports it, every rank then holds rank 0's
    state (equal digests, the next check passes)."""
    out = ranks.results()
    for r in out:
        assert bool(r["repair_found"]) and bool(r["repair_after"])
    np.testing.assert_array_equal(out[1]["repair_digest"], out[0]["repair_digest"])
    np.testing.assert_array_equal(out[0]["repair_digest"], out[0]["lc_digest"])
