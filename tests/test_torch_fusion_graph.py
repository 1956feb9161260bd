"""The fusion's LM loop as one captured CUDA graph, replayed each iteration
(``models/fusion.py``: ``_lm_iteration``, ``_lm_solve``, ``_LMGraph``).

On the CPU (every case not marked ``cuda``):

* ``lm_graph_key`` changes with each float of ``FusionConfig`` and
  ``ImuNoise`` that reaches the iteration, and with nothing else: every
  other field, changed, leaves the iteration's outputs equal bit for bit,
  so a graph keyed without it replays the right arithmetic. Presets whose
  baked floats agree share a key, whatever their names.
* ``_assemble`` builds no tensor from a Python constant once its constants
  are cached (a capture's warm-up runs it first): no ``torch.tensor`` or
  ``torch.as_tensor`` call while it runs.
* The CPU loop records no replay or capture counter.

On the card (``cuda``), a float32 system of ``tiny_system``'s caps with the
full 15 LM iterations, its keyframes' ``_finish`` calls recorded:

* each call replayed on the graph path and on the eager body gives the
  same iterations and the same window states and ``FusionOut``, bit for
  bit (both run the same kernels on the same inputs);
* a second system in the process reuses the cached graph (no capture);
  one with another ``lm_up`` captures its own;
* a window's results held are unchanged after another window ran through
  the same graph: the states are cloned out of the graph's buffers;
* ``gn_tol`` = 0 (fixed iterations, no host read) replays a graph of its
  own, equal to the eager body.
"""
import numpy as np
import pytest
import torch

import lili_om_tpu_torch.models.fusion as TFUS
from lili_om_tpu_torch.factors.lidar import EdgeFactorBatch, PlaneFactorBatch
from lili_om_tpu_torch.factors.prior import identity_prior
from lili_om_tpu_torch.models.fusion import FusionConfig, LMInputs, lm_graph_key
from lili_om_tpu_torch.models.odometry import OdometryConfig
from lili_om_tpu_torch.ops.features_livox import LivoxFeatureConfig
from lili_om_tpu_torch.ops.features_spin import SpinFeatureConfig
from lili_om_tpu_torch.ops.preintegration import ImuNoise, init_preint, sqrt_info
from lili_om_tpu_torch.sim.lidar import simulate_scan, spinning_pattern
from lili_om_tpu_torch.sim.trajectory import circle_trajectory, simulate_imu
from lili_om_tpu_torch.sim.world import make_room_world
from lili_om_tpu_torch.utils import metrics as M
from lili_om_tpu_torch.utils.config import PRESETS, LoopClosureConfig
from test_torch_common import CPU, npy

RINGS, COLS, PERIOD, N_SCANS = 16, 360, 0.1, 14

# the floats of each config that reach an LM iteration's kernels
BAKED_FUSION = ("cauchy_c", "sb_weights", "damping", "lm_up", "lm_down", "lm_max")
BAKED_NOISE = ("g_norm",)
# shape the inputs: in the key through every input's shape
SHAPING = ("window", "kf_surf_cap", "kf_edge_cap")


def _problem(cfg: FusionConfig, seed=0, dtype=torch.float64):
    """A random window problem at ``cfg``'s shapes: states near identity,
    preintegrations, a valid prior, and half-masked factor batches."""
    g = torch.Generator().manual_seed(seed)
    W, Sc, Ec = cfg.window, cfg.kf_surf_cap, cfg.kf_edge_cap
    rnd = lambda *s: torch.randn(s, generator=g, dtype=dtype)
    unit = lambda x: x / torch.linalg.norm(x, dim=-1, keepdim=True)
    q = unit(torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype) + 0.05 * rnd(W, 4))
    cur = (rnd(W, 3), q, rnd(W, 3), 0.01 * rnd(W, 3), 0.001 * rnd(W, 3))
    pre = init_preint(0.01 * rnd(3), 0.001 * rnd(3), ImuNoise())
    pre = pre._replace(dp=rnd(3), dv=rnd(3), sum_dt=torch.tensor(0.1, dtype=dtype))
    preints = type(pre)(*[x.expand((W - 1,) + x.shape).clone() for x in pre])
    prior = identity_prior(W - 1, dtype=dtype)
    D = 15 * (W - 1)
    prior = prior._replace(J=torch.eye(D, dtype=dtype) + 0.1 * rnd(D, D), r0=rnd(D),
                           t0=cur[0][:-1] + 0.01, valid=torch.ones((), dtype=torch.bool))
    surf = PlaneFactorBatch(pts=rnd(W, Sc, 3), normals=unit(rnd(W, Sc, 3)), offsets=rnd(W, Sc),
                            scores=rnd(W, Sc).abs(), mask=rnd(W, Sc) > 0)
    edge = EdgeFactorBatch(pts=rnd(W, Ec, 3), point_a=rnd(W, Ec, 3), point_b=rnd(W, Ec, 3),
                           scores=rnd(W, Ec).abs(), mask=rnd(W, Ec) > 0)
    fixed = LMInputs(preints, sqrt_info(preints), prior, torch.ones((), dtype=torch.bool),
                     (cur[2][:-1] + 0.1, cur[3][:-1], cur[4][:-1]), surf, edge)
    return cur, fixed


def _other(name, value):
    """Another valid value of a config field."""
    if isinstance(value, bool):
        return not value
    if isinstance(value, int):
        return value + 1
    if isinstance(value, float):
        return value * 1.5 + 0.25
    if isinstance(value, str):
        return {"centered": "svd"}.get(value, "centered")
    if name in ("q_lb",):
        return (0.0, 0.0, 0.0, 1.0)
    return tuple(v * 0.5 + 0.125 for v in value)


def _iterate(cur, fixed, noise, cfg, adaptive):
    """One iteration's outputs; λ is an input (``lm_lam0`` is filled into
    the graph's buffer at each loop's start, not baked)."""
    lam = torch.full((), 1e-3, dtype=cur[0].dtype)
    step = torch.full((), 0.5, dtype=cur[0].dtype)
    new, lam, step = TFUS._lm_iteration(cur, lam, step, fixed, noise, cfg, adaptive)
    return [npy(x) for x in (*new, lam, step)]


CFG = FusionConfig(window=3, kf_surf_cap=64, kf_edge_cap=32)
NOISE = ImuNoise()


@pytest.mark.parametrize("field", [f for f in FusionConfig._fields if f not in SHAPING])
def test_key_holds_each_fusion_float_that_reaches_the_iteration(field):
    cur, fixed = _problem(CFG)
    adaptive = CFG.gn_tol > 0.0 and CFG.lm_lam0 > 0.0
    other = CFG._replace(**{field: _other(field, getattr(CFG, field))})
    key = lm_graph_key(cur, fixed, NOISE, CFG, adaptive)
    if field in BAKED_FUSION:
        assert lm_graph_key(cur, fixed, NOISE, other, adaptive) != key
    else:
        # not in the key: the iteration gives the same bits without it
        assert lm_graph_key(cur, fixed, NOISE, other, adaptive) == key
        for a, b in zip(_iterate(cur, fixed, NOISE, CFG, adaptive),
                        _iterate(cur, fixed, NOISE, other, adaptive)):
            np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("field", ImuNoise._fields)
def test_key_holds_each_noise_float_that_reaches_the_iteration(field):
    cur, fixed = _problem(CFG)
    other = NOISE._replace(**{field: _other(field, getattr(NOISE, field))})
    key = lm_graph_key(cur, fixed, NOISE, CFG, True)
    if field in BAKED_NOISE:
        assert lm_graph_key(cur, fixed, other, CFG, True) != key
    else:
        assert lm_graph_key(cur, fixed, other, CFG, True) == key
        for a, b in zip(_iterate(cur, fixed, NOISE, CFG, True),
                        _iterate(cur, fixed, other, CFG, True)):
            np.testing.assert_array_equal(a, b, err_msg=field)


def test_key_holds_the_shapes_and_the_kind_of_solve():
    cur, fixed = _problem(CFG)
    key = lm_graph_key(cur, fixed, NOISE, CFG, True)
    assert lm_graph_key(cur, fixed, NOISE, CFG, False) != key
    for field in SHAPING:
        other = CFG._replace(**{field: getattr(CFG, field) + 1})
        assert lm_graph_key(*_problem(other), NOISE, other, True) != key, field
    c32, f32 = _problem(CFG, dtype=torch.float32)
    assert lm_graph_key(c32, f32, NOISE, CFG, True) != key
    # the values of the inputs are not baked in
    assert lm_graph_key(*_problem(CFG, seed=1), NOISE, CFG, True) == key


def test_presets_share_a_key_where_their_baked_floats_agree():
    """The key holds values, never a preset's name: presets that differ only
    outside the iteration (map width, lidar weight, gates, noise densities)
    share one graph; the spin and Livox presets' speed-bias weights do not."""
    def key(name):
        c = PRESETS[name]()
        return lm_graph_key(*_problem(c.fusion), c.imu_noise, c.fusion, True)

    assert key("fr_iosb") == key("fr_iosb_tree") == key("ka_urban_campus")
    assert key("fr_iosb_rot") == key("urban_hk_rot") == key("utbm_rot")
    assert key("fr_iosb") != key("fr_iosb_rot")


def test_assemble_uploads_no_python_constant(monkeypatch):
    cur, fixed = _problem(CFG)
    args = (*cur, fixed.preints, fixed.preint_Ws, fixed.prior, fixed.sb_on, fixed.sb_anchor,
            fixed.surf, fixed.edge, NOISE, CFG)
    TFUS._assemble(*args)  # fills the constant cache, as a capture's warm-up does
    calls = []
    for name in ("tensor", "as_tensor"):
        fn = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _fn=fn, _n=name, **kw:
                            calls.append(_n) or _fn(*a, **kw))
    H, g = TFUS._assemble(*args)
    TFUS._lm_iteration(cur, torch.full((), 1e-4, dtype=torch.float64),
                       torch.full((), 1.0, dtype=torch.float64), fixed, NOISE, CFG, True)
    assert calls == []
    assert torch.isfinite(H).all() and torch.isfinite(g).all()


def test_cpu_loop_records_no_replay():
    """The CPU path is eager: no capture and no replay counter, only the
    loop's host reads (``_finish`` adds ``fusion.lm_iters``)."""
    cur, fixed = _problem(CFG)
    m = M.StageMetrics()
    with m.current():
        _, n_iter = TFUS._lm_solve(cur, fixed, NOISE, CFG)
    assert 1 <= n_iter <= CFG.max_num_iter
    assert set(m.samples) == {"host_read.fusion_lm"} and m.kinds == {}
    assert len(m.samples["host_read.fusion_lm"]) == n_iter


def _sweeps(n0, n1, dtype=torch.float64):
    world = make_room_world(dtype=dtype, device=CPU)
    traj = circle_trajectory(radius=8.0, period=40.0)
    pattern = spinning_pattern(n_rings=RINGS, n_cols=COLS, dtype=dtype, device=CPU)
    for k in range(n0, n1):
        sc = simulate_scan(world, traj, k * PERIOD, pattern, period=PERIOD)
        yield (npy(sc.pts).reshape(RINGS, COLS, 3), npy(sc.valid).reshape(RINGS, COLS),
               npy(sc.rel_time).reshape(RINGS, COLS), k * PERIOD)


def _push_imu(s):
    imu = simulate_imu(circle_trajectory(radius=8.0, period=40.0), 0.0, N_SCANS * PERIOD + 0.5,
                       rate=200.0, device=CPU)
    s.push_imu(npy(imu.stamps), npy(imu.accs), npy(imu.gyrs))
    return s


# --- on the card -------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode (the CPU cases "
                    "hold the iteration body the graph replays)")
    return torch.device("cuda")


def _card_system(cuda, fusion_cfg):
    from lili_om_tpu_torch.models.system import LiliOmSystem

    return _push_imu(LiliOmSystem(
        odo_cfg=OdometryConfig(n_recent_frames=4, scan_cap=1024, query_cap=256, map_cap=2048),
        fusion_cfg=fusion_cfg, feat_cfg=SpinFeatureConfig(surf_cap=1024),
        livox_cfg=LivoxFeatureConfig(n_cols=400),
        lc_cfg=LoopClosureConfig(enabled=True, time_thres=1e9), graph_capacity=32,
        dtype=torch.float32, device=cuda))


CARD_CFG = FusionConfig(window=3, local_map_width=4, kf_surf_cap=1024, kf_edge_cap=256,
                        map_surf_cap=2048, map_edge_cap=512, use_reflectivity=False,
                        imu_cap=32)


@pytest.fixture(scope="module")
def card_run(cuda):
    """One float32 system over N_SCANS scans on the card, every ``_finish``
    call's arguments and results recorded."""
    TFUS._LM_GRAPHS.clear()
    calls = []
    orig = TFUS._finish

    def finish(*a, **kw):
        out = orig(*a, **kw)
        calls.append((a, kw, out))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(TFUS, "_finish", finish)
    try:
        s = _card_system(cuda, CARD_CFG)
        for args in _sweeps(0, N_SCANS):
            s.process_scan(*args)
        torch.cuda.synchronize()
    finally:
        mp.undo()
    solved = [c for c in calls if not c[0][6]]
    assert len(solved) >= 3
    return dict(sys=s, calls=calls, solved=solved)


def _finish_counted(args, kw, graph: bool, monkeypatch):
    monkeypatch.setattr(TFUS, "_use_graph", lambda dev: graph)
    m = M.StageMetrics()
    with m.current():
        out = TFUS._finish(*args, **kw)
    torch.cuda.synchronize()
    return out, m.samples


def _fields(new_state, out):
    d = {f"state.{k}": new_state._asdict()[k] for k in ("t", "q", "v", "ba", "bg",
                                                       "hist_t", "hist_q")}
    d.update({f"prior.{k}": v for k, v in new_state.prior._asdict().items()})
    d.update({f"out.{k}": v for k, v in out._asdict().items()})
    return {k: npy(v) for k, v in d.items()}


@pytest.mark.cuda
def test_graph_replays_equal_the_eager_body(card_run, monkeypatch):
    """Bit for bit: the graph replays the kernels the eager body launches,
    on the same inputs."""
    sys_ = card_run["sys"]
    smp = sys_.metrics.samples
    assert smp["fusion.lm_captures"] == [1]  # the first solved keyframe
    assert smp["fusion.lm_replays"] == smp["fusion.lm_iters"]
    assert max(smp["fusion.lm_iters"]) > 1
    for k, (a, kw, _) in enumerate(card_run["solved"]):
        (st_e, out_e), smp_e = _finish_counted(a, kw, False, monkeypatch)
        (st_g, out_g), smp_g = _finish_counted(a, kw, True, monkeypatch)
        assert smp_e["fusion.lm_iters"] == smp_g["fusion.lm_iters"] \
            == smp_g["fusion.lm_replays"], k
        assert "fusion.lm_replays" not in smp_e and "fusion.lm_captures" not in smp_g
        fe, fg = _fields(st_e, out_e), _fields(st_g, out_g)
        for name in fe:
            np.testing.assert_array_equal(fg[name], fe[name], err_msg=f"keyframe {k} {name}")


@pytest.mark.cuda
def test_a_second_system_reuses_the_graph(card_run, cuda):
    s = _card_system(cuda, CARD_CFG)
    for args in _sweeps(0, 8):
        s.process_scan(*args)
    smp = s.metrics.samples
    assert smp["fusion.lm_iters"] and smp["fusion.lm_replays"] == smp["fusion.lm_iters"]
    assert "fusion.lm_captures" not in smp


@pytest.mark.cuda
def test_another_lm_up_captures_its_own(card_run, cuda):
    s = _card_system(cuda, CARD_CFG._replace(lm_up=5.0))
    for args in _sweeps(0, 8):
        s.process_scan(*args)
    smp = s.metrics.samples
    assert smp["fusion.lm_captures"] == [1] and smp["fusion.lm_replays"] == smp["fusion.lm_iters"]


def _to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    vals = [_to(x, dev) for x in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


@pytest.mark.cuda
def test_outputs_held_survive_the_next_keyframe(cuda):
    """The loop's states are clones, not the graph's buffers: one window's
    results read the same after another window ran through the same graph,
    and equal the eager body's."""
    p0, p1 = (_to(_problem(CFG, seed=s, dtype=torch.float32), cuda) for s in (0, 1))
    held, n0 = TFUS._lm_solve(*p0, NOISE, CFG)
    before = [npy(x) for x in held]
    other, _ = TFUS._lm_solve(*p1, NOISE, CFG)
    torch.cuda.synchronize()
    for a, b in zip(held, before):
        np.testing.assert_array_equal(npy(a), b)
    assert not np.array_equal(npy(other[0]), before[0])
    mp = pytest.MonkeyPatch()
    mp.setattr(TFUS, "_use_graph", lambda dev: False)
    try:
        eager, n_e = TFUS._lm_solve(*p0, NOISE, CFG)
    finally:
        mp.undo()
    assert n_e == n0
    for a, b in zip(eager, before):
        np.testing.assert_array_equal(npy(a), b)


@pytest.mark.cuda
def test_fixed_iterations_take_their_own_graph(cuda):
    """``gn_tol`` = 0: every iteration runs with the ``damping`` solve and no
    host read, replayed from a graph of its own kind, equal to the eager
    body's."""
    cfg = CFG._replace(gn_tol=0.0, max_num_iter=4)
    p = _to(_problem(cfg, seed=2, dtype=torch.float32), cuda)
    n_graphs = len(TFUS._LM_GRAPHS)
    m = M.StageMetrics()
    with m.current():
        out, n = TFUS._lm_solve(*p, NOISE, cfg)
    assert n == 4 and len(TFUS._LM_GRAPHS) == n_graphs + 1
    assert m.samples["fusion.lm_captures"] == [1] and m.samples["fusion.lm_replays"] == [4]
    assert not any(k.startswith("host_read.") for k in m.samples)
    mp = pytest.MonkeyPatch()
    mp.setattr(TFUS, "_use_graph", lambda dev: False)
    try:
        eager, n_e = TFUS._lm_solve(*p, NOISE, cfg)
    finally:
        mp.undo()
    assert n_e == 4
    for a, b in zip(out, eager):
        np.testing.assert_array_equal(npy(a), npy(b))
