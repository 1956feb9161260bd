"""The port's apps on the CPU: ``evaluate_presets.run_preset`` against the
JAX harness's (``examples/evaluate_presets.py``) on the same golden loop,
its table and exit code, and ``run_synthetic``, ``run_pipeline`` and
``run_loop_closure`` (with ``--export-dir``) at a few frames each.

The preset parity feeds both harnesses the same inputs and is cut to CI
size in both alike: the JAX harness's simulator calls are served by the
port's simulator (held against JAX's by test_torch_sim.py; the JAX one
evaluates its trajectory op by op, ~0.3 s a pose on the CPU), so both
systems see bit-identical scans and IMU samples; the ``synthetic``
preset's capacities are shrunk (``_small``: the backend's to
``tiny_system``'s, which halves the JAX run's execution on the CPU; its
gates, weights and noises as shipped); the systems run in float64. The
rows agree to 1e-6 m (measured: ≤ 4.1e-10 m apart).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lili_om_tpu.sim.lidar as JL
import lili_om_tpu.sim.trajectory as JT
import lili_om_tpu.sim.world as JW
import lili_om_tpu.utils.config as JC
import lili_om_tpu_torch.utils.config as TC
from examples.evaluate_presets import run_preset as jax_run_preset
from lili_om_tpu_torch.apps import evaluate_presets, run_loop_closure, run_pipeline, run_synthetic
from lili_om_tpu_torch.utils.evaluation import load_tum
from test_torch_common import CPU, port_sim_for_jax, tiny_system

N_PRESET = 18  # the first frame count with an RPE@5 value (7 keyframes > delta 5)


def _small(load_config):
    def load(name, overrides=None):
        c = load_config(name, overrides)
        c.odometry = c.odometry._replace(scan_cap=1024, query_cap=512, map_cap=4096,
                                         frame_cap=1024, n_recent_frames=6)
        c.fusion = c.fusion._replace(local_map_width=4, kf_surf_cap=1024, kf_edge_cap=256,
                                     map_surf_cap=2048, map_edge_cap=512, max_num_iter=3)
        c.spin_features = c.spin_features._replace(surf_cap=2048)
        return c
    return load


def test_run_preset_matches_jax(monkeypatch, tmp_path):
    for mod in (JC, TC):
        monkeypatch.setattr(mod, "load_config", _small(mod.load_config))
    port_sim_for_jax(monkeypatch, (JW, JT, JL))
    got = evaluate_presets.run_preset("synthetic", N_PRESET, torch.float64,
                                      tum_dir=str(tmp_path), device=CPU)
    want = jax_run_preset("synthetic", N_PRESET, jnp.float64)
    for k in ("preset", "frames", "keyframes", "loops"):
        assert got[k] == want[k], k
    assert got["keyframes"] >= 7
    for k in ("frame_ate", "kf_ate", "kf_rpe5"):
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, err_msg=k)
    s, t, _ = load_tum(str(tmp_path / "synthetic_gt.tum"))
    assert len(s) == N_PRESET and t.shape == (N_PRESET, 3)
    s, _, _ = load_tum(str(tmp_path / "synthetic_keyframes.tum"))
    assert len(s) == got["keyframes"]


def test_evaluate_presets_table_and_exit_code(monkeypatch, capsys):
    """``main`` runs each named preset, prints the table, and exits 1 when
    a keyframe ATE misses its bound (or is NaN)."""
    ates = {"synthetic": 0.2, "fr_iosb": 1.5, "fr_iosb_rot": float("nan")}

    def fake(name, frames, dtype, tum_dir, device=None):
        assert frames == 7 and dtype == torch.float32 and device == CPU
        return {"preset": name, "frames": frames, "keyframes": 3, "loops": 1,
                "frame_ate": 0.1, "kf_ate": ates[name], "kf_rpe5": 0.05, "scans_per_s": 1.0,
                "system": object()}

    monkeypatch.setattr(evaluate_presets, "run_preset", fake)
    assert evaluate_presets.main(["--cpu", "--frames", "7", "--presets", "synthetic"]) == 0
    assert evaluate_presets.main(["--cpu", "--frames", "7"]) == 1
    out = capsys.readouterr().out
    assert "kf_ATE" in out and "✗" in out and "synthetic" in out


@pytest.mark.parametrize("corridor", [False, True])
def test_run_synthetic(monkeypatch, corridor):
    """The frontend over a few sweeps of the room or the corridor stays
    within the example's 0.3 m ATE bound (the odometry map cut from 16384 to
    4096 rows: the plain kNN of the full map takes 0.5 s a round on the
    CPU)."""
    monkeypatch.setattr(run_synthetic, "ODO_CFG",
                        run_synthetic.ODO_CFG._replace(map_cap=4096, query_cap=512))
    r = run_synthetic.run(3, corridor=corridor, device=CPU, log=lambda *a: None)
    assert r["est"].shape == (3, 3) and np.all(np.isfinite(r["est"]))
    assert r["ate"] < run_synthetic.ATE_BOUND_M


def test_run_pipeline_serial_and_overlapped():
    """The same stream through both runner modes, on tiny_system: every
    scan processed, none dropped, and the two keyframe sequences equal."""
    scans, imu = run_pipeline.simulate(6, 16, 360, device=CPU)
    out = {}
    for overlap in (False, True):
        sys_, runner, rate = run_pipeline.run_mode(scans, imu, overlap, device=CPU,
                                                   system=tiny_system())
        assert runner.n_processed == 6 and runner.n_dropped == 0 and rate > 0
        out[overlap] = sys_
    assert out[False].kf_stamps == out[True].kf_stamps
    np.testing.assert_allclose(np.stack(out[True].trajectory), np.stack(out[False].trajectory),
                               atol=1e-9)


def test_run_loop_closure_exports(tmp_path):
    """The full-loop demo on tiny_system with ``--export-dir``'s files: the
    TUM keyframes reload to the graph's poses within the format's 5e-7."""
    r = run_loop_closure.run(12, device=CPU, export_dir=str(tmp_path), system=tiny_system(),
                             log=lambda *a: None)
    sys_ = r["system"]
    nk = len(sys_.kf_stamps)
    assert nk >= 3 and r["gt"].shape == (12, 3) and np.isfinite(r["kf_ate"])
    s, t, q = load_tum(r["paths"]["trajectory_tum"])
    np.testing.assert_allclose(t, sys_.graph.t[:nk].numpy(), atol=5e-7)
    np.testing.assert_allclose(q, sys_.graph.q[:nk].numpy(), atol=5e-7)
    for key in ("map_pcd", "map_ply", "overview_png"):
        assert (tmp_path / r["paths"][key].split("/")[-1]).stat().st_size > 0, key
