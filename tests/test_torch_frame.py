"""The whole slice: ``Frame`` (spin features → scan-to-map odometry →
sliding-window fusion) over six simulated scans against the same loop built
from the JAX functions (the ``frame`` body of bench.py: fusion on every
scan, never in warmup mode), at the small caps of tests/test_split.py.

* float64: the odometry and fusion poses agree to 1e-6 m and 1e-6 rad;
  the measured gap is ≤ 5e-8 (odometry: a GN step more or less where a step
  norm lands within rounding of its 1e-5 stopping threshold; see
  test_torch_odometry.py).
* float32: to 1e-3. The jitted JAX program rounds the voxel keys and the
  curvature stencil differently from op-by-op execution (which the port
  matches exactly, test_torch_features_spin.py), so the downsampled clouds
  come in another slot order, a few gated correspondences differ, and each
  side's float32 pose is itself up to 6e-4 m from its float64 pose here.
* mid-run: after three JAX scans both carried states go into the port
  (interop.py); one more scan on each side agrees to 1e-7, which separates
  per-step parity from accumulated drift.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.models.fusion import fusion_step as j_fusion_step
from lili_om_tpu.models.fusion import init_fusion_state as j_init_fusion_state
from lili_om_tpu.models.odometry import init_state as j_init_state
from lili_om_tpu.models.odometry import odometry_step as j_odometry_step
from lili_om_tpu.ops.features_spin import extract_features_spin as j_extract
from lili_om_tpu_torch import interop
from lili_om_tpu_torch.frame import Frame, FrameConfigs, ScanInputs
from test_torch_common import CPU, port_sim_frames, small_configs, tree_dict


N_SCANS = 6
MID = 3  # scans run on the JAX side before the mid-run carry
FIELDS = ("img", "valid", "rel", "dts", "accs", "gyrs", "vm")


@pytest.fixture(scope="module")
def frames():
    return port_sim_frames(N_SCANS)[0]


def _jax_frame(ostate, fstate, fr, cfgs, dtype):
    """bench.py's ``frame`` body on the CPU."""
    fcfg, ocfg, bcfg, noise = cfgs
    a = {k: jnp.asarray(v) if v.dtype == np.bool_ else jnp.asarray(v, dtype)
         for k, v in fr.items()}
    fc = j_extract(a["img"], a["valid"], a["rel"], fcfg)
    ostate, out = j_odometry_step(ostate, fc.surf_pts, fc.surf_mask, ocfg,
                                  n_rounds=ocfg.scan_match_cnt)
    fstate, fout = j_fusion_step(fstate, fc.surf_pts, fc.surf_mask,
                                 jnp.zeros_like(fc.surf_pts[:, 0]), fc.edge_pts, fc.edge_mask,
                                 a["dts"], a["accs"], a["gyrs"], a["vm"], bcfg, noise)
    return ostate, fstate, out, fout


def _scan(fr, dtype):
    return ScanInputs(*(torch.as_tensor(fr[k]) if fr[k].dtype == np.bool_
                        else torch.as_tensor(fr[k], dtype=dtype) for k in FIELDS))


def _poses(out, fout):
    """(odometry t, odometry q, fusion latest t, fusion latest q) as numpy."""
    return [np.asarray(x, np.float64) if not isinstance(x, torch.Tensor)
            else x.numpy().astype(np.float64)
            for x in (out.t, out.q, fout.t_latest, fout.q_latest)]


def _rot_gap(qa, qb):
    """Angle (rad) between two unit quaternions."""
    return 2.0 * np.arccos(min(1.0, abs(float(np.dot(qa, qb)))))


def _assert_poses(ja, tb, tol, what):
    jt, jq, jft, jfq = ja
    tt_, tq, tft, tfq = tb
    assert np.abs(jt - tt_).max() <= tol and np.abs(jft - tft).max() <= tol, \
        (what, np.abs(jt - tt_).max(), np.abs(jft - tft).max())
    assert _rot_gap(jq, tq) <= tol and _rot_gap(jfq, tfq) <= tol, \
        (what, _rot_gap(jq, tq), _rot_gap(jfq, tfq))


def _run(frames, dtype_name):
    jcfgs, tcfgs = small_configs()
    jdt, tdt = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    ostate = j_init_state(jcfgs[1], dtype=jdt)
    fstate = j_init_fusion_state(jcfgs[2], jcfgs[3], dtype=jdt)
    frame = Frame(FrameConfigs(*tcfgs), dtype=tdt, device=CPU)
    jposes, tposes, mid_states = [], [], None
    for k, fr in enumerate(frames):
        if k == MID:
            mid_states = (tree_dict(ostate), tree_dict(fstate))
        ostate, fstate, out, fout = _jax_frame(ostate, fstate, fr, jcfgs, jdt)
        jposes.append(_poses(out, fout))
        tposes.append(_poses(*frame.step(_scan(fr, tdt))))
    return jposes, tposes, mid_states, tcfgs


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-6), ("float32", 1e-3)])
def test_frame_matches_jax_loop(frames, dtype, tol):
    jposes, tposes, mid_states, tcfgs = _run(frames, dtype)
    # the run moved: the last pose is centimetres from the first
    assert np.linalg.norm(jposes[-1][0]) > 0.01
    for k, (ja, tb) in enumerate(zip(jposes, tposes)):
        _assert_poses(ja, tb, tol, f"scan {k}")
    if dtype == "float64":
        # mid-run: the JAX states after MID scans, carried into the port
        frame = Frame(FrameConfigs(*tcfgs), dtype=torch.float64, device=CPU)
        frame.ostate = interop.odometry_state_from_numpy(mid_states[0], torch.float64, CPU)
        frame.fstate = interop.fusion_state_from_numpy(mid_states[1], torch.float64, CPU)
        got = _poses(*frame.step(_scan(frames[MID], torch.float64)))
        _assert_poses(jposes[MID], got, 1e-7, "mid-run step")


def test_interop_round_trip(frames):
    """Port state → numpy → port state is the identity, field by field."""
    _, tcfgs = small_configs()
    frame = Frame(FrameConfigs(*tcfgs), dtype=torch.float64, device=CPU)
    for fr in frames[:3]:
        frame.step(_scan(fr, torch.float64))
    for to_np, from_np, state in (
            (interop.odometry_state_to_numpy, interop.odometry_state_from_numpy, frame.ostate),
            (interop.fusion_state_to_numpy, interop.fusion_state_from_numpy, frame.fstate)):
        d = to_np(state)
        back = to_np(from_np(d, torch.float64, CPU))
        assert set(d) == set(back)
        for key in d:
            assert d[key].dtype == back[key].dtype, key
            np.testing.assert_array_equal(back[key], d[key], err_msg=key)
