"""models/odometry: ``odometry_step`` against the JAX one over a few
simulated scans, at the small caps of tests/test_split.py, comparing the
full ``OdometryOut`` and the carried ``OdometryState``.

Two ways:
* free-running: each side carries its own state; in float64 the poses agree
  to 1e-6;
* per step: the JAX state is carried into the port (interop.py) before each
  step, so both start from the same numbers; then poses agree to 1e-7.
Neither is bit-exact: the voxel sums round in another order, and the GN
loop stops at a step norm of 1e-5, so where a step norm lands within
rounding of that threshold one side takes one more step. Convergence is
quadratic, so that step is ~1e-8 (measured: 1.8e-8 with the same state,
4e-8 free-running over these scans).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.models import odometry as JO
from lili_om_tpu_torch import interop
from lili_om_tpu_torch.models import odometry as TO
from lili_om_tpu_torch.ops.features_spin import extract_features_spin
from test_torch_common import (CPU, assert_close_dicts, port_sim_frames, small_configs,
                               state_dict, tree_dict, tt)


N_SCANS = 5


@pytest.fixture(scope="module")
def clouds():
    """Surf clouds (float64 numpy) of N_SCANS simulated scans."""
    frames, _ = port_sim_frames(N_SCANS)
    (js, _, _, _), (ts, _, _, _) = small_configs()
    out = []
    for fr in frames:
        fc = extract_features_spin(tt(fr["img"]), tt(fr["valid"]), tt(fr["rel"]), ts,
                                   device=CPU)
        out.append((fc.surf_pts.numpy(), fc.surf_mask.numpy()))
    return out


def _cfgs(**kw):
    _, (_, to, _, _) = small_configs()
    (_, jo, _, _), _ = small_configs()
    return jo._replace(**kw), to._replace(**kw)


def _rounds(i, cfg):
    # the reference runs max_rounds (8) for the first two frames, then
    # scan_match_cnt; two rounds exercise the same multi-round path cheaper
    return 2 if i < 2 else cfg.scan_match_cnt


def _run(clouds, jcfg, tcfg, dtype, carry):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    js = JO.init_state(jcfg, dtype=jdt)
    ts = TO.init_state(tcfg, dtype=tdt, device=CPU)
    outs = []
    for i, (pts, mask) in enumerate(clouds):
        if carry:
            ts = interop.odometry_state_from_numpy(tree_dict(js), dtype=tdt, device=CPU)
        n = _rounds(i, jcfg)
        js, jout = JO.odometry_step(js, jnp.asarray(pts, jdt), jnp.asarray(mask), jcfg,
                                    n_rounds=n)
        ts, tout = TO.odometry_step(ts, torch.as_tensor(pts, dtype=tdt), torch.as_tensor(mask),
                                    tcfg, n_rounds=n, device=CPU)
        outs.append((tree_dict(jout), tree_dict(tout)))
    return outs, state_dict(js), state_dict(ts)


# (dtype, carry) → (pose tolerance, state tolerance). float32: rounding
# at 1e-7 relative moves plane-fit gate values across their thresholds, so
# a few correspondences in a few hundred differ (n_corr within 5 %); on
# these small scans each side's float32 pose is itself up to 6e-4 m from
# its own float64 pose (measured), so the two agree to 1e-3, and the map
# tables built from those poses are compared through the poses only
CASES = {("float64", False): (1e-6, 1e-6), ("float64", True): (1e-7, 1e-7),
         ("float32", False): (1e-3, 1e-3)}
POSE_FIELDS = ("t", "q", "t_prev", "q_prev", "kf_t", "kf_q", "kf_frame", "frame_id",
               "write_idx")


def _same_outputs(outs, tol, dtype):
    for i, (jo, to) in enumerate(outs):
        if dtype == "float32":
            jn, tn = int(jo.pop("n_corr")), int(to.pop("n_corr"))
            assert abs(jn - tn) <= 0.05 * jn, (i, jn, tn)
        assert_close_dicts(jo, to, rtol=0.0, atol=tol, what=f"scan {i}")


@pytest.mark.parametrize("dtype,carry", sorted(CASES))
def test_odometry_step_matches_jax(clouds, dtype, carry):
    pose_tol, state_tol = CASES[dtype, carry]
    jcfg, tcfg = _cfgs()
    outs, jstate, tstate = _run(clouds, jcfg, tcfg, dtype, carry)
    assert int(outs[-1][0]["n_corr"]) > 300  # the comparison exercised matching
    _same_outputs(outs, pose_tol, dtype)
    if dtype == "float32":
        jstate, tstate = ({k: d[k] for k in POSE_FIELDS} for d in (jstate, tstate))
    assert_close_dicts(jstate, tstate, rtol=state_tol, atol=state_tol, what="final state")


def test_divergence_gate_and_own_ring_downsample(clouds):
    """With a jump limit of 1e-6 m every matched frame diverges and both
    sides fall back to the constant-velocity prior (zero motion after the
    first scan, so every pose stays at the origin); with frame_cap ≠ query_cap the
    ring entry is its own downsample of the whole surf cloud (the other
    branch of the ring update)."""
    jcfg, tcfg = _cfgs(max_frame_jump=1e-6, frame_cap=512, n_recent_frames=3)
    outs, jstate, tstate = _run(clouds[:4], jcfg, tcfg, "float64", carry=False)
    assert int(outs[-1][1]["n_corr"]) > 20
    assert all(not np.any(to["t"]) for _, to in outs)
    _same_outputs(outs, 1e-9, "float64")
    assert_close_dicts(jstate, tstate, rtol=1e-9, atol=1e-9, what="final state")
