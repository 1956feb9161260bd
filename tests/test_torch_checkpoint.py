"""``io/checkpoint.py`` and the global map: the port's checkpoints are the
JAX package's files, both ways, and a resumed run continues exactly.

One run of tests/test_pipeline.py's ``tiny_system`` (float64, 16×360 sweeps
of the port's simulator, the whole IMU stream pushed up front) in the port,
6 scans, saved; the JAX system (the one of this module) loads that
checkpoint and saves it again with the JAX writer; then 2 more scans each:

* JAX continues from the port's checkpoint; the port continues without a
  break: equal to 1e-6 (the float64 parity of the two systems, measured
  ≤ 5e-8 in tests/test_torch_system.py, which also runs both from the
  first scan);
* the port loads the JAX-written checkpoint and continues: equal to JAX's
  continuation to 1e-6, for the same reason;
* the port loads its own checkpoint and continues: equal to the run without
  a break bit for bit.

The JAX system starts from the loaded state, so it compiles only its
odometry and its full-window fusion (not its warm-up fusion: ~13 s less).
The global map of the JAX-loaded port system equals JAX's to 1e-9 (the same
keyframe clouds and graph poses through the same host downsample).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.io import checkpoint as JC
from lili_om_tpu.io import pcd as JP
from lili_om_tpu.models import fusion as jfus
from lili_om_tpu.models import odometry as jodo
from lili_om_tpu.models import pose_graph as jpg
from lili_om_tpu_torch.io import checkpoint as TC
from lili_om_tpu_torch.io import pcd as TP
from lili_om_tpu_torch.models import fusion as tfus
from lili_om_tpu_torch.models import odometry as todo
from lili_om_tpu_torch.models import pose_graph as tpg
from lili_om_tpu_torch.sim.lidar import simulate_scan, spinning_pattern
from lili_om_tpu_torch.sim.trajectory import circle_trajectory, simulate_imu
from lili_om_tpu_torch.sim.world import make_room_world
from test_torch_common import (CPU, J_FUS, J_ODO, assert_close_dicts, jax_tiny_system, npy,
                               state_dict, tiny_system, tree_dict)

R, C, PERIOD = 16, 360, 0.1
N_SAVE, N_MORE = 6, 2
TOL = 1e-6
# build_global_map's variants: every keyframe, every second, a subsample
# (the same seeded choice), the surf archive
MAP_ARGS = [{"interval": 1}, {"interval": 2}, {"cap": 300}, {"features_only": True}]


def _outcome(s):
    return {"trajectory": np.asarray(s.trajectory), "kf_stamps": list(s.kf_stamps),
            "n_frames": s.n_frames, "fusion": state_dict(s.fusion_state),
            "graph": tree_dict(s.graph), "odo": tree_dict(s.odo_state),
            "dense": [(t, np.asarray(p), np.asarray(q)) for t, p, q in s.dense_trajectory]}


def _assert_close_outcomes(got, want, tol):
    """``tol`` None: bit for bit."""
    assert got["kf_stamps"] == want["kf_stamps"] and got["n_frames"] == want["n_frames"]
    rtol, atol = (0.0, 0.0) if tol is None else (tol, tol)
    np.testing.assert_allclose(got["trajectory"], want["trajectory"], rtol=rtol, atol=atol)
    for part in ("fusion", "graph", "odo"):
        assert_close_dicts(want[part], got[part], rtol=rtol, atol=atol, what=part)
    assert [s for s, _, _ in got["dense"]] == [s for s, _, _ in want["dense"]]
    for (_, ta, qa), (_, tb, qb) in zip(got["dense"], want["dense"]):
        np.testing.assert_allclose(ta, tb, rtol=rtol, atol=atol)
        np.testing.assert_allclose(qa, qb, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ck")
    world = make_room_world(dtype=torch.float64, device=CPU)
    traj = circle_trajectory(radius=8.0, period=40.0)
    pattern = spinning_pattern(n_rings=R, n_cols=C, dtype=torch.float64, device=CPU)
    imu = simulate_imu(traj, 0.0, (N_SAVE + N_MORE + 1) * PERIOD, rate=200.0, device=CPU)
    imu = (npy(imu.stamps), npy(imu.accs), npy(imu.gyrs))
    scans = []
    for k in range(N_SAVE + N_MORE):
        sc = simulate_scan(world, traj, k * PERIOD, pattern, period=PERIOD)
        scans.append((npy(sc.pts).reshape(R, C, 3), npy(sc.valid).reshape(R, C),
                      npy(sc.rel_time).reshape(R, C), k * PERIOD))
    later = scans[N_SAVE:]

    def cont(s):
        for sc in later:
            s.process_scan(*sc)
        return _outcome(s)

    out = {}
    t = tiny_system()
    t.push_imu(*imu)
    for sc in scans[:N_SAVE]:
        t.process_scan(*sc)
    out["n_kf"] = len(t.kf_stamps)
    pj, pt = str(d / "jax"), str(d / "port")
    TC.save_system(pt, t)
    j = jax_tiny_system()
    JC.load_system(pt, j)
    JC.save_system(pj, j)
    out["paths"] = (pj, pt)
    out["j_maps"] = [j.build_global_map(**kw) for kw in MAP_ARGS]
    out["j_pcd"] = str(d / "j.pcd")
    j.export_map(out["j_pcd"])
    out["jax_from_port"] = cont(j)
    out["port_continued"] = cont(t)
    t2 = tiny_system()
    TC.load_system(pj, t2)
    out["t_maps"] = [t2.build_global_map(**kw) for kw in MAP_ARGS]
    out["t_pcd"] = str(d / "t.pcd")
    out["t_export_n"] = t2.export_map(out["t_pcd"])
    out["port_from_jax"] = cont(t2)
    t3 = tiny_system()
    TC.load_system(pt, t3)
    out["port_resumed"] = cont(t3)
    return out


def test_run_has_keyframes_to_carry(runs):
    assert 2 <= runs["n_kf"] <= N_SAVE and len(runs["port_continued"]["kf_stamps"]) > runs["n_kf"]


def test_jax_checkpoint_continues_in_the_port(runs):
    _assert_close_outcomes(runs["port_from_jax"], runs["jax_from_port"], TOL)


def test_port_checkpoint_continues_in_jax(runs):
    _assert_close_outcomes(runs["jax_from_port"], runs["port_continued"], TOL)


def test_port_resume_is_bit_identical(runs):
    _assert_close_outcomes(runs["port_resumed"], runs["port_continued"], None)


def test_files_have_the_jax_layout(runs):
    """The same archive keys and JSON keys; leaves of equal shape."""
    pj, pt = runs["paths"]
    zj, zt = np.load(pj + ".npz"), np.load(pt + ".npz")
    assert set(zj.files) == set(zt.files)
    for k in zj.files:
        if not k.endswith("__treedef") and not k.startswith("imu_"):
            assert zj[k].shape == zt[k].shape, k
    with open(pj + ".json") as f, open(pt + ".json") as g:
        assert json.load(f).keys() == json.load(g).keys()


@pytest.mark.parametrize("name", ["OdometryState", "FusionState", "PoseGraph"])
def test_leaf_order_matches_jax_tree_flatten(name):
    """Field names agree at every level, no field is None (``jax.tree``
    drops None leaves, which would shift every later index), and the leaves
    line up with ``jax.tree.flatten``'s, shape for shape."""
    noise = tiny_system().noise
    t, j = {"OdometryState": lambda: (todo.init_state(todo.OdometryConfig(**J_ODO), device=CPU),
                                      jodo.init_state(jodo.OdometryConfig(**J_ODO))),
            "FusionState": lambda: (tfus.init_fusion_state(tfus.FusionConfig(**J_FUS), noise,
                                                           device=CPU),
                                    jfus.init_fusion_state(jfus.FusionConfig(**J_FUS), noise)),
            "PoseGraph": lambda: (tpg.init_graph(8, device=CPU), jpg.init_graph(8))}[name]()
    assert type(t).__name__ == type(j).__name__ == name
    assert list(tree_dict(t)) == list(tree_dict(j))
    leaves, jleaves = TC._leaves(t), jax.tree.flatten(j)[0]
    assert len(leaves) == len(jleaves) == len(tree_dict(t))
    for a, b in zip(leaves, jleaves):
        assert tuple(a.shape) == tuple(np.shape(b))


def test_none_field_is_refused():
    g = tpg.init_graph(8, device=CPU)
    with pytest.raises(ValueError, match="None field"):
        TC._leaves(g._replace(loop_t=None))


@pytest.mark.parametrize("variant", range(len(MAP_ARGS)),
                         ids=["_".join(f"{k}{v}" for k, v in kw.items()) for kw in MAP_ARGS])
def test_global_map_matches_jax(runs, variant):
    got, want = runs["t_maps"][variant], runs["j_maps"][variant]
    assert got.shape == want.shape and len(got) >= 300
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-9)
    n_all = len(runs["t_maps"][0])
    assert len(got) == 300 if "cap" in MAP_ARGS[variant] else len(got) <= n_all


def test_export_map_matches_jax(runs):
    """The two PCDs: the same header and point count; the float32 points of
    maps equal to 1e-9 agree to a float32 ulp at the map's ~30 m extent."""
    got, want = TP.read_pcd(runs["t_pcd"]), JP.read_pcd(runs["j_pcd"])
    assert got.shape == want.shape == (runs["t_export_n"], 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)
    with open(runs["t_pcd"], "rb") as f, open(runs["j_pcd"], "rb") as g:
        assert f.read(200).split(b"DATA")[0] == g.read(200).split(b"DATA")[0]


def test_spilled_archives_are_saved_as_clouds(runs, tmp_path):
    """Keyframe clouds spilled to disk are read back into the checkpoint,
    not saved as paths, and load equal."""
    s = tiny_system()
    TC.load_system(runs["paths"][1], s)
    want = [s._kf_cloud_np(i, a) for a in (s.kf_clouds, s.kf_edge_clouds, s.kf_full_clouds)
            for i in range(len(a))]
    s.archive_spill_dir, s.archive_keep_recent = str(tmp_path / "spill"), 1
    assert s.spill_archives() == 3 * (len(s.kf_stamps) - 1)
    assert isinstance(s.kf_clouds[0], str)
    TC.save_system(str(tmp_path / "spilled"), s)
    z = np.load(str(tmp_path / "spilled.npz"))
    assert z["kf_cloud__0"].dtype == np.float64
    s2 = tiny_system()
    TC.load_system(str(tmp_path / "spilled.npz"), s2)
    got = [s2._kf_cloud_np(i, a) for a in (s2.kf_clouds, s2.kf_edge_clouds, s2.kf_full_clouds)
           for i in range(len(a))]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
