"""ops/icp: ``icp_point_to_plane`` against the JAX one in float64, on the
structured clouds of tests/test_pose_graph.py, with the trimmed and the
untrimmed (PCL) fitness.

Tolerance 1e-9: both sides run the same fixed-iteration point-to-plane GN on
the same exact 5-NN sets (the float64 distances differ in the last bits —
the JAX kNN expands ‖q‖²+‖p‖²−2q·p around the map centroid — but no two
candidates of these clouds lie that close), so the transforms and scores
differ by rounding only.

The pruned route (B3 with the target prepared once) and the B1 route (the
target prepared once as a ``KnnMap``) are held against the plain route bit
for bit on the CPU, with the dispatch and the launch routed to each
kernel's plain schedule.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.ops.icp import icp_point_to_plane as jicp
from lili_om_tpu.utils.math import pose_inverse, quat_normalize, quat_rotate
from lili_om_tpu_torch.ops import icp as icp_mod
from lili_om_tpu_torch.ops import knn as K
from lili_om_tpu_torch.ops.icp import icp_point_to_plane as ticp
from test_torch_common import npy, tt

TOL = 1e-9


def _cloud(seed, n=600):
    """Three orthogonal planes of a box corner, uniformly sampled."""
    a = np.random.default_rng(seed).uniform(-5.0, 5.0, (n // 3, 2))
    z = np.zeros(n // 3)
    return np.concatenate([np.stack([a[:, 0], a[:, 1], z], 1),
                           np.stack([a[:, 0], z - 5.0, a[:, 1] + 5.0], 1),
                           np.stack([z + 5.0, a[:, 0], a[:, 1] + 5.0], 1)])


def _both(src, smask, tgt, tmask, **kw):
    ident = (np.zeros(3), np.array([1.0, 0, 0, 0]))
    j = jicp(jnp.asarray(src), jnp.asarray(smask), jnp.asarray(tgt), jnp.asarray(tmask),
             *[jnp.asarray(a) for a in ident], **kw)
    t = ticp(tt(src), tt(smask), tt(tgt), tt(tmask), *[tt(a) for a in ident], **kw)
    return j, t


def _assert_same(j, t):
    for f in ("t", "q", "fitness"):
        np.testing.assert_allclose(npy(getattr(t, f)), np.asarray(getattr(j, f)),
                                   rtol=TOL, atol=TOL, err_msg=f)
    assert int(t.n_matched) == int(j.n_matched)
    assert t.n_matched.dtype == torch.int32


@pytest.mark.parametrize("trim", [0.7, 1.0])
def test_recovers_transform_like_jax(trim):
    pts = _cloud(0)
    t_true = jnp.array([0.4, -0.3, 0.2])
    q_true = quat_normalize(jnp.array([1.0, 0.02, -0.015, 0.03]))
    ti, qi = pose_inverse(t_true, q_true)
    src = np.asarray(quat_rotate(jnp.broadcast_to(qi, (len(pts), 4)), jnp.asarray(pts)) + ti)
    # padding rows in both clouds, as the system's fixed-capacity submaps have
    src = np.concatenate([src, np.zeros((40, 3))])
    tgt = np.concatenate([pts, np.full((24, 3), 3.0)])
    smask = np.arange(len(src)) < len(pts)
    tmask = np.arange(len(tgt)) < len(pts)
    j, t = _both(src, smask, tgt, tmask, n_iters=15, trim=trim)
    _assert_same(j, t)
    np.testing.assert_allclose(npy(t.t), np.asarray(t_true), atol=2e-2)
    assert float(t.fitness) < 1e-3 and int(t.n_matched) == len(pts)


@pytest.mark.parametrize("trim", [0.7, 1.0])
def test_partial_overlap_fitness_like_jax(trim):
    """A disjoint 'shadow' cluster in the source: the untrimmed score is
    dominated by it, the trimmed one is not (n_iters=0: scoring only)."""
    pts = _cloud(2)
    src = np.concatenate([pts, pts[:len(pts) // 3] + np.array([0.0, 8.0, 3.0])])
    j, t = _both(src, np.ones(len(src), bool), pts, np.ones(len(pts), bool), n_iters=0,
                 trim=trim)
    _assert_same(j, t)
    assert (float(t.fitness) > 1.0) if trim == 1.0 else (float(t.fitness) < 0.05)


def test_no_match_gives_inf_fitness():
    pts = _cloud(1)
    j, t = _both(pts, np.ones(len(pts), bool), pts + 100.0, np.ones(len(pts), bool),
                 n_iters=2)
    assert np.isinf(float(j.fitness)) and torch.isinf(t.fitness) and int(t.n_matched) == 0
    np.testing.assert_allclose(npy(t.t), np.asarray(j.t), atol=TOL)


@pytest.mark.parametrize("n_iters", [0, 6])
def test_pruned_route_equals_plain_route(monkeypatch, n_iters):
    """ICP through B3's prepared route (``K.searcher``), with the dispatch
    and the launch patched to the kernel's plain schedule (as chip_smoke.py's
    CPU rehearsal runs it): the same IcpResult bits as the plain route, the
    target prepared once per call and the source ordered once, and one
    search per iteration plus the fitness search."""
    pts = _cloud(3)
    rng = np.random.default_rng(3)
    src = np.concatenate([pts[::2] + rng.normal(scale=0.01, size=(300, 3))
                          + np.array([0.2, -0.1, 0.05]), np.zeros((20, 3))])
    tgt = np.concatenate([pts, np.full((30, 3), 2.0)])
    args = (tt(src, torch.float32), tt(np.arange(len(src)) < 300), tt(tgt, torch.float32),
            tt(np.arange(len(tgt)) < len(pts)), torch.zeros(3), torch.tensor([1.0, 0, 0, 0]))
    plain = ticp(*args, n_iters=n_iters)

    calls = {"map": 0, "order": 0, "search": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    def schedule(queries, pmap, q_mask, q_order, k):
        calls["search"] += 1
        return K.knn_pruned_schedule(queries, pmap, k, q_mask=q_mask, q_order=q_order)

    # the dispatch takes the card's route; the map and the order are their
    # plain versions (the kernels' bits)
    monkeypatch.setenv("LILI_OM_KNN_PRUNED", "1")
    monkeypatch.setattr(K, "use_kernel", lambda x: True)
    monkeypatch.setattr(K, "pruned_map", counted("map", K.pruned_map_plain))
    monkeypatch.setattr(K, "query_order", counted("order", K.morton_order_plain))
    monkeypatch.setattr(K, "_check_pruned", lambda *a: None)
    monkeypatch.setattr(K, "launch_pruned_kernel", schedule)
    pruned = ticp(*args, n_iters=n_iters)
    assert bool(torch.isfinite(plain.fitness)) and int(plain.n_matched) > 0
    for f in icp_mod.IcpResult._fields:
        assert torch.equal(getattr(pruned, f), getattr(plain, f)), f
    assert calls == {"map": 1, "order": 1, "search": n_iters + 1}


@pytest.mark.parametrize("n_iters", [0, 6])
def test_b1_route_prepares_the_map_once(monkeypatch, n_iters):
    """ICP through B1's prepared route (``K.searcher`` with the pruned switch
    unset), with the dispatch patched to the card's route, the preparation
    to ``knn_map_plain`` and the launch to ``knn_lanes_schedule``: the same
    IcpResult bits as the plain route, one map prepared per call, and one
    B1 launch per iteration plus the fitness search."""
    pts = _cloud(4)
    rng = np.random.default_rng(4)
    src = np.concatenate([pts[1::2] + rng.normal(scale=0.01, size=(300, 3))
                          + np.array([-0.15, 0.1, 0.05]), np.zeros((20, 3))])
    tgt = np.concatenate([pts, np.full((30, 3), 2.0)])
    args = (tt(src, torch.float32), tt(np.arange(len(src)) < 300), tt(tgt, torch.float32),
            tt(np.arange(len(tgt)) < len(pts)), torch.zeros(3), torch.tensor([1.0, 0, 0, 0]))
    plain = ticp(*args, n_iters=n_iters)

    calls = {"map": 0, "search": 0}

    def prepare(points, p_mask=None):
        calls["map"] += 1
        return K.knn_map_plain(points, p_mask)

    def schedule(queries, kmap, q_mask, k):
        calls["search"] += 1
        return K.knn_lanes_schedule(queries, kmap, k, q_mask=q_mask)

    monkeypatch.delenv("LILI_OM_KNN_PRUNED", raising=False)
    monkeypatch.setattr(K, "use_kernel", lambda x: True)
    monkeypatch.setattr(K, "knn_map", prepare)
    monkeypatch.setattr(K, "_check_search", lambda *a: None)
    monkeypatch.setattr(K, "launch_kernel", schedule)
    K.reset_launch_counts()
    b1 = ticp(*args, n_iters=n_iters)
    assert bool(torch.isfinite(plain.fitness)) and int(plain.n_matched) > 0
    for f in icp_mod.IcpResult._fields:
        assert torch.equal(getattr(b1, f), getattr(plain, f)), f
    assert calls == {"map": 1, "search": n_iters + 1}
    assert K.launch_count("knn_counted") == n_iters + 1 and K.launch_count() == n_iters + 1
