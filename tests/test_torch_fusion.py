"""models/fusion: ``fusion_step`` against the JAX one over a few simulated
scans, at the small caps of tests/test_split.py, in warmup mode while the
window fills and in main mode after (surf and edge matching against the
incremental map tables, the adaptive LM solve and the Schur
marginalization), comparing the full ``FusionOut`` and the carried
``FusionState``. The marginal prior is compared through JᵀJ and Jᵀr0, the
only parts of its square root that are unique (test_torch_common.state_dict).

Free-running in float64 the states agree to 1e-6: the surf and edge gates
and the LM loop's stopping test see the same values to rounding, and the
measured gap over these scans is ≤ 1e-8 in the window states (≤ 7e-10 with
the JAX state carried into the port before each step, interop.py). The
prior is the exception: its information matrix has a condition number of
~2e11 here (largest eigenvalue 7.5e6), and the Schur complement through
the pseudo-inverse of such blocks amplifies a 1e-9 change of the
linearization point to ~2e-6 of its largest entry (1e-7 carried). It is
compared relative to that entry, at 1e-5 (1e-6 carried).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.models import fusion as JFu
from lili_om_tpu_torch import interop
from lili_om_tpu_torch.models import fusion as TFu
from lili_om_tpu_torch.ops.features_spin import extract_features_spin
from test_torch_common import (CPU, assert_close_dicts, port_sim_frames, small_configs,
                               state_dict, tree_dict, tt)


N_SCANS = 6
KEYS = ("surf_pts", "surf_mask", "edge_pts", "edge_mask")


@pytest.fixture(scope="module")
def inputs():
    """Per scan: the feature clouds and the padded IMU interval (numpy f64)."""
    frames, _ = port_sim_frames(N_SCANS)
    _, (ts, _, _, _) = small_configs()
    out = []
    for fr in frames:
        fc = extract_features_spin(tt(fr["img"]), tt(fr["valid"]), tt(fr["rel"]), ts,
                                   device=CPU)
        d = {k: getattr(fc, k).numpy() for k in KEYS}
        d.update({k: fr[k] for k in ("dts", "accs", "gyrs", "vm")})
        out.append(d)
    return out


def _args(d, lib, dtype, refl=False):
    """fusion_step's positional inputs for one scan: the curvature channel
    0 (as bench.py), or with ``refl`` the simulator's reflectivity for each
    point's range, ×0.1 as the Livox path packs it."""
    if lib is jnp:
        f = lambda a: jnp.asarray(a) if a.dtype == np.bool_ else jnp.asarray(a, dtype)
    else:
        f = lambda a: torch.as_tensor(a) if a.dtype == np.bool_ else torch.as_tensor(a, dtype=dtype)
    sp = d["surf_pts"]
    r = np.zeros(sp.shape[0])
    if refl:
        r = 0.1 * (5.0 + 10.0 / (1.0 + np.linalg.norm(sp, axis=1) / 20.0))
    return (f(sp), f(d["surf_mask"]), f(r), f(d["edge_pts"]),
            f(d["edge_mask"]), f(d["dts"]), f(d["accs"]), f(d["gyrs"]), f(d["vm"]))


def _livox_fusion(jf, tf):
    """The fr_iosb (Livox) fusion section — reflectivity-weighted plane fits,
    its gates, weights and LM budget — at the same small caps, with the
    extrinsic of the other cases: these scans are cast without one, and
    under fr_iosb's 180° yaw the LM loop's stopping test meets near-ties on
    them (a 1e-4 gap with the reflectivity branch off too)."""
    from lili_om_tpu.utils.config import load_config

    keep = ("local_map_width", "kf_surf_cap", "kf_edge_cap", "map_surf_cap", "map_edge_cap",
            "max_num_iter", "imu_cap", "q_lb", "t_lb")
    lf = load_config("fr_iosb").fusion._replace(**{k: getattr(jf, k) for k in keep})
    assert lf.use_reflectivity
    return lf, type(tf)(**lf._asdict())


def _run(inputs, dtype, carry, rebuild_at=None, section="fr_iosb_rot"):
    """Both fusion steps over the scans; scan ``rebuild_at`` runs with
    ``rebuild=True`` (the first keyframe after a loop closure). ``section``
    "fr_iosb" runs the Livox fusion with a nonzero curvature channel."""
    (_, _, jf, jn), (_, _, tf, tn) = small_configs()
    refl = section == "fr_iosb"
    if refl:
        jf, tf = _livox_fusion(jf, tf)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    js = JFu.init_fusion_state(jf, jn, dtype=jdt)
    ts = TFu.init_fusion_state(tf, tn, dtype=tdt, device=CPU)
    outs = []
    for i, d in enumerate(inputs):
        if carry:
            ts = interop.fusion_state_from_numpy(tree_dict(js), dtype=tdt, device=CPU)
        warm = int(js.kf_count) + 1 < jf.window
        rb = i == rebuild_at
        js, jo = JFu.fusion_step(js, *_args(d, jnp, jdt, refl), jf, jn, warmup=warm,
                                 rebuild=rb)
        ts, to = TFu.fusion_step(ts, *_args(d, torch, tdt, refl), tf, tn, warmup=warm,
                                 rebuild=rb, device=CPU)
        outs.append((warm, tree_dict(jo), tree_dict(to)))
    return outs, state_dict(js), state_dict(ts)


# carry → prior tolerance, relative to its largest entry (float64; the
# float32 run of fusion is part of tests/test_torch_frame.py)
PRIOR_TOL = {False: 1e-5, True: 1e-6}


@pytest.mark.parametrize("carry", [False, True])
def test_fusion_step_matches_jax(inputs, carry):
    outs, jstate, tstate = _run(inputs, "float64", carry)
    assert [w for w, _, _ in outs] == [True, True] + [False] * (N_SCANS - 2)
    assert int(outs[-1][1]["n_surf_corr"]) > 50 and int(outs[-1][1]["n_edge_corr"]) > 10
    assert bool(jstate["prior.valid"])  # the marginalization ran
    for i, (_, jo, to) in enumerate(outs):
        assert_close_dicts(jo, to, rtol=1e-6, atol=1e-6, what=f"scan {i}")
    for k in ("prior.JtJ", "prior.Jtr0"):
        a, b = jstate.pop(k), tstate.pop(k)
        np.testing.assert_allclose(b, a, rtol=0.0, atol=PRIOR_TOL[carry] * np.abs(a).max(),
                                   err_msg=k)
    assert_close_dicts(jstate, tstate, rtol=1e-6, atol=1e-6, what="final state")


def test_fusion_step_reflectivity_matches_jax(inputs):
    """The ``use_reflectivity`` branch of the plane fits (fr_iosb): weights
    from the curvature channel's differences, the ``reflect_thres`` gate and
    the ``exp(−Σw)`` score term, with the channel carried through the
    keyframe ring and the map tables. Free-running float64, tolerances of
    the free-running case above."""
    outs, jstate, tstate = _run(inputs, "float64", False, section="fr_iosb")
    assert int(outs[-1][1]["n_surf_corr"]) > 50
    assert np.abs(jstate["hist_surf_refl"]).max() > 0.5  # the channel is carried
    for i, (_, jo, to) in enumerate(outs):
        assert_close_dicts(jo, to, rtol=1e-6, atol=1e-6, what=f"scan {i}")
    for k in ("prior.JtJ", "prior.Jtr0"):
        a, b = jstate.pop(k), tstate.pop(k)
        np.testing.assert_allclose(b, a, rtol=0.0, atol=PRIOR_TOL[False] * np.abs(a).max(),
                                   err_msg=k)
    assert_close_dicts(jstate, tstate, rtol=1e-6, atol=1e-6, what="final state")


def test_clamp_accel():
    a = np.array([[20.0, -20.0, 30.0], [1.0, -16.0, -19.0], [0.0, 0.0, 9.8]])
    np.testing.assert_array_equal(TFu.clamp_accel(torch.as_tensor(a)).numpy(),
                                  np.asarray(JFu.clamp_accel(jnp.asarray(a))))


def test_fusion_step_rebuild_matches_jax(inputs):
    """``rebuild=True`` on a carried state (the first keyframe after a
    loop closure): the match maps and the mature tables come from the whole
    ring. The JAX state is carried in before each step, so the tolerances
    are those of the carried run above."""
    outs, jstate, tstate = _run(inputs, "float64", True, rebuild_at=N_SCANS - 1)
    assert not outs[-1][0] and int(outs[-1][1]["n_surf_corr"]) > 50
    for i, (_, jo, to) in enumerate(outs):
        assert_close_dicts(jo, to, rtol=1e-6, atol=1e-6, what=f"scan {i}")
    for k in ("prior.JtJ", "prior.Jtr0"):
        a, b = jstate.pop(k), tstate.pop(k)
        np.testing.assert_allclose(b, a, rtol=0.0, atol=PRIOR_TOL[True] * np.abs(a).max(),
                                   err_msg=k)
    assert_close_dicts(jstate, tstate, rtol=1e-6, atol=1e-6, what="final state")
    assert int(tstate["msurf_valid"].sum()) > 0  # the rebuilt table holds the mature ring


@pytest.fixture(scope="module")
def batch_map_runs(inputs):
    """The port over the scans twice: under the incremental config with
    ``match_fn=default_map_and_match`` (counting its calls), and with
    ``incremental_map=False``. Returns ({kind: (final state, outs)}, calls)."""
    _, (_, _, tf, tn) = small_configs()
    calls = []

    def match_fn(*a, **kw):
        calls.append(1)
        return TFu.default_map_and_match(*a, **kw)

    runs = {}
    for kind, cfg, kw in (("match_fn", tf, {"match_fn": match_fn}),
                          ("incremental_map", tf._replace(incremental_map=False), {})):
        ts = TFu.init_fusion_state(cfg, tn, dtype=torch.float64, device=CPU)
        outs = []
        for d in inputs:
            warm = int(ts.kf_count) + 1 < cfg.window
            ts, to = TFu.fusion_step(ts, *_args(d, torch, torch.float64), cfg, tn, warmup=warm,
                                     device=CPU, **kw)
            outs.append(tree_dict(to))
        runs[kind] = (state_dict(ts), outs)
    return runs, len(calls)


WINDOW_FIELDS = ("t", "q", "v", "ba", "bg", "hist_t", "hist_q", "hist_valid", "kf_count")


@pytest.mark.parametrize("kw", [{"match_fn": TFu.default_map_and_match},
                                {"cfg": {"incremental_map": False}}])
def test_unported_paths_raise(batch_map_runs, kw):
    """The sharded path's hooks, which raised until the multi-device slice,
    run: a ``match_fn`` replaces the incremental maps' search on every main
    step, and ``incremental_map=False`` builds the maps from the ring
    (``default_map_and_match``) and leaves the mature tables untouched. With
    the batch build as the ``match_fn`` the two runs take the same poses
    exactly. Their parity with the JAX package is
    tests/test_torch_map_fusion.py's."""
    runs, n_calls = batch_map_runs
    (ms, mouts), (bs, bouts) = runs["match_fn"], runs["incremental_map"]
    if "match_fn" in kw:
        assert n_calls == N_SCANS - 2  # every main step, no warmup step
        assert int(ms["msurf_valid"].sum()) > 0  # the tables still update
    else:
        assert bs["msurf_valid"].shape == (1,) and not bs["msurf_valid"].any()
    assert int(bouts[-1]["n_surf_corr"]) > 50 and int(bouts[-1]["n_edge_corr"]) > 10
    for a, b in zip(mouts, bouts):
        assert_close_dicts(a, b, rtol=0.0, atol=0.0, what="outputs")
    assert_close_dicts({k: ms[k] for k in WINDOW_FIELDS}, {k: bs[k] for k in WINDOW_FIELDS},
                       rtol=0.0, atol=0.0, what="window")
