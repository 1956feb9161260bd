"""ops/knn, kernel B3: the pruned kNN's preparation and its plain schedule
(``knn_pruned_schedule``: the kernel's prepared map, query order, block
layout, tile ranking and skip test, walked in torch) against the JAX
package's ``_morton30``, ``_block_bounds`` and ``knn_pallas_pruned``
(interpret mode) and against the plain ``knn``, through the raw route and
through the prepared route (``pruned_map`` + ``query_order``, as ICP
searches); the ``LILI_OM_KNN_PRUNED`` switch; and, on a machine with a GPU,
the CUDA kernels against their plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.ops.knn_pallas import _block_bounds, _morton30, knn_pallas_pruned
from lili_om_tpu_torch.ops import knn as K
from test_torch_common import npy

# small blocks and tiles, so that the CI-size clouds span many of each
SMALL = dict(q_block=16, tile_p=64)


def _cloud(seed, nq=300, npts=3000, lo=-30.0, hi=30.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (nq, 3)).astype(np.float32),
            rng.uniform(lo, hi, (npts, 3)).astype(np.float32), rng)


def _t(*xs):
    return [None if x is None else torch.as_tensor(x) for x in xs]


def _assert_equals_plain(q, p, k, pm=None, qm=None, **blocks):
    """The schedule equals the plain version bit for bit, indices included.
    Returns (d², idx, share of (block, tile) pairs skipped)."""
    q, p, pm, qm = _t(q, p, pm, qm)
    d, i, visited = K.knn_pruned_schedule(q, p, k, pm, qm, **blocks)
    rd, ri = K.knn(q, p, k=k, p_mask=pm, q_mask=qm)
    assert torch.equal(d, rd), float((d - rd)[torch.isfinite(rd)].abs().max())
    assert torch.equal(i, ri), int((i != ri).sum())
    pmap = K.pruned_map_plain(p, pm, blocks.get("tile_p", K.PRUNED_TILE))
    skipped = K.pruned_skipped_share(visited, pmap)
    assert 0.0 <= skipped <= 1.0
    return d, i, skipped


def _prepared(q, p, pm, qm, **blocks):
    """The prepared route's inputs: the map and the query order, each built
    once, as ICP builds them."""
    pmap = K.pruned_map_plain(p, pm, blocks.get("tile_p", K.PRUNED_TILE))
    return pmap, K.query_order(q, qm)


@pytest.mark.parametrize("valid", ["all", "random", "none"])
def test_morton_keys_equal_jax(valid):
    q, p, rng = _cloud(0)
    m = {"all": np.ones(len(p), bool), "random": rng.uniform(size=len(p)) > 0.4,
         "none": np.zeros(len(p), bool)}[valid]
    m[:1] = valid != "none"
    want = np.asarray(_morton30(jnp.asarray(p), jnp.asarray(m)))
    got = npy(K.morton30(torch.as_tensor(p), torch.as_tensor(m)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[m], want[m])


def test_block_bounds_equal_jax():
    _, p, rng = _cloud(1, npts=2048)
    m = rng.uniform(size=len(p)) > 0.5
    m[256:512] = False  # one block without a valid row
    for a, b in zip(_block_bounds(jnp.asarray(p), jnp.asarray(m), 256),
                    K.block_bounds(torch.as_tensor(p), torch.as_tensor(m), 256)):
        np.testing.assert_array_equal(npy(b), np.asarray(a))


def _case(name):
    """(queries, points, p_mask, q_mask, block sizes) of a schedule case."""
    if name.startswith("random"):
        # masked map rows and invalid queries; at the test's small blocks and
        # at the kernel's own
        q, p, rng = _cloud(2)
        blocks = {} if name == "random_kernel_blocks" else SMALL
        return q, p, rng.uniform(size=len(p)) > 0.3, rng.uniform(size=len(q)) > 0.2, blocks
    if name == "ties":
        # a lattice queried at cell centres and corners: many equal
        # distances, resolved toward the lower original index whatever the
        # tile order
        g = np.arange(8, dtype=np.float32)
        lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        q = np.concatenate([lat[::5] + 0.5, lat[::7]]).astype(np.float32)
        return q, lat[::-1].copy(), None, None, SMALL
    if name == "duplicates":
        # every map point twice (and a third copy masked out): equal
        # distances at different indices
        q, p, _ = _cloud(3, nq=200, npts=700)
        pd = np.concatenate([p, p[::-1], p])
        return q, pd, np.arange(len(pd)) < 2 * len(p), None, SMALL
    if name == "all_masked":
        q, p, _ = _cloud(4, nq=100, npts=500)
        return q, p, np.zeros(len(p), bool), None, SMALL
    assert name == "fewer_than_k"
    pts = np.array([[0.0, 0, 0], [1, 0, 0], [2, 0, 0], [9, 9, 9], [8, 8, 8]], np.float32)
    q = np.array([[0.1, 0, 0], [5.0, 5, 5]], np.float32)
    return q, pts, np.array([1, 1, 1, 0, 0], bool), None, {}


CASES = ["random", "random_kernel_blocks", "ties", "duplicates", "all_masked",
         "fewer_than_k"]


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("case", CASES)
def test_schedule_equals_plain(case, k):
    """The raw route (map and query order prepared inside the call) and the
    prepared route (``pruned_map`` + ``query_order`` built once, as ICP
    searches): both the plain kNN's bits, the same visits per block, and
    (+inf, 0) in the slots beyond the valid points."""
    q, p, pm, qm, blocks = _case(case)
    d, i, skipped = _assert_equals_plain(q, p, k, pm, qm, **blocks)
    q, p, pm, qm = _t(q, p, pm, qm)
    pmap, order = _prepared(q, p, pm, qm, **blocks)
    pd_, pi_, visited = K.knn_pruned_schedule(q, pmap, k, None, qm, q_order=order,
                                              q_block=blocks.get("q_block", K.PRUNED_BLOCK))
    assert torch.equal(pd_, d) and torch.equal(pi_, i)
    _, _, raw_visited = K.knn_pruned_schedule(q, p, k, pm, qm, **blocks)
    assert torch.equal(visited, raw_visited)
    n_valid = len(p) if pm is None else int(pm.sum())
    assert torch.all(torch.isinf(d[:, n_valid:])) and torch.all(i[:, n_valid:] == 0)
    if n_valid == 0:
        assert skipped == 0.0  # no valid tile: nothing to skip


def test_schedule_skips_tiles_on_separated_clouds():
    """Queries around one cluster of a map with two far-apart clusters: the
    tiles of the far cluster lie beyond every block's worst distance."""
    rng = np.random.default_rng(5)
    near = rng.uniform(0, 10, (1500, 3))
    far = rng.uniform(0, 10, (1500, 3)) + np.array([200.0, 0, 0])
    p = np.concatenate([near, far]).astype(np.float32)
    q = (near[::5] + rng.normal(size=(300, 3)) * 0.1).astype(np.float32)
    _, _, skipped = _assert_equals_plain(q, p, 5, **SMALL)
    assert skipped >= 0.5, skipped


@pytest.mark.parametrize("k", [1, 5])
def test_rigidly_moved_queries_keep_their_order(k):
    """ICP's source order, taken once in the source's own frame: after a
    rigid motion the walk in that order gives the plain kNN's bits, as a
    fresh Morton sort of the moved cloud does."""
    q, p, pm, qm = _t(*_case("random")[:4])
    pmap, order = _prepared(q, p, pm, qm, **SMALL)
    c, s_ = np.cos(0.4), np.sin(0.4)
    rot = torch.tensor([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float32)
    moved = (q @ rot.T + torch.tensor([1.5, -0.7, 0.3])).contiguous()
    d, i, _ = K.knn_pruned_schedule(moved, pmap, k, None, qm, q_order=order, q_block=16)
    fd, fi, _ = K.knn_pruned_schedule(moved, pmap, k, None, qm, q_block=16)
    rd, ri = K.knn(moved, p, k=k, p_mask=pm, q_mask=qm)
    assert torch.equal(d, fd) and torch.equal(i, fi)
    assert torch.equal(d, rd) and torch.equal(i, ri)


@pytest.mark.parametrize("case", ["random", "duplicates"])
def test_plan_ranks_tiles_by_bound_then_id(case):
    """Each block walks its tiles as the kernel ranks them in shared memory,
    the stable argsort of its bounds: bounds ascending, equal bounds (ties,
    +inf tiles without a valid point) by tile id."""
    q, p, pm, qm, _ = _case(case)
    q, p, pm, qm = _t(q, p, pm, qm)
    plan = K.pruned_plan(q, K.pruned_map_plain(p, pm, 64), qm, q_block=16)
    assert torch.all(plan.lb[:, 1:] >= plan.lb[:, :-1])
    tied = plan.lb[:, 1:] == plan.lb[:, :-1]
    assert bool(tied.any()) and torch.all(plan.order[:, 1:][tied] > plan.order[:, :-1][tied])


def test_prepared_map_and_query_order():
    """The prepared map: rows in stable Morton order with the masked ones
    last, the original index beside each row, padding masked, and each
    tile's box that of its valid rows; the query order a permutation with
    the invalid queries last."""
    q, p, pm, qm = _t(*_case("random")[:4])
    pmap = K.pruned_map(p, pm)
    P, n = len(p), int(pm.sum())
    assert pmap.n_points == P and pmap.tile == K.PRUNED_TILE
    assert pmap.pts4.shape == (pmap.tile_any.shape[0] * K.PRUNED_TILE, 4)
    idx = pmap.p_idx[:P].long()
    assert torch.equal(torch.sort(idx).values, torch.arange(P))
    assert torch.all(pm[idx[:n]]) and not torch.any(pm[idx[n:]])
    assert torch.equal(pmap.pts4[:P, :3], p[idx])
    assert torch.all(pmap.pts4[:n, 3] == 0.0) and torch.all(torch.isinf(pmap.pts4[n:, 3]))
    keys = K.morton30(p, pm)[idx[:n]]
    assert torch.all(keys[1:] >= keys[:-1])
    lo, hi, any_ = K.block_bounds(pmap.pts4[:, :3], pmap.pts4[:, 3] == 0.0, K.PRUNED_TILE)
    assert torch.equal(lo, pmap.tile_lo) and torch.equal(hi, pmap.tile_hi)
    assert torch.equal(any_, pmap.tile_any)
    order = K.query_order(q, qm)
    assert torch.equal(torch.sort(order).values, torch.arange(len(q)))
    nq = int(qm.sum())
    assert torch.all(qm[order[:nq]]) and not torch.any(qm[order[nq:]])


def test_distances_match_pallas_pruned_interpret():
    """Against the TPU kernel in interpret mode (the blocks of
    tests/test_knn_pallas.py). That kernel truncates distances to 12 mantissa
    bits and expands ‖q‖²+‖p‖²−2q·p around the centroid: distances agree to
    a relative 1e-3, indices wherever no other candidate lies within it."""
    q, p, rng = _cloud(6)
    pm = rng.uniform(size=len(p)) > 0.3
    jd, ji = knn_pallas_pruned(jnp.asarray(q), jnp.asarray(p), k=5, p_mask=jnp.asarray(pm),
                               q_block=128, tile_p=256, interpret=True)
    td, ti, _ = K.knn_pruned_schedule(*_t(q, p), 5, torch.as_tensor(pm), None, **SMALL)
    pmap, order = _prepared(*_t(q, p, pm, None), **SMALL)
    pd_, pi_, _ = K.knn_pruned_schedule(torch.as_tensor(q), pmap, 5, q_order=order,
                                        q_block=16)
    assert torch.equal(pd_, td) and torch.equal(pi_, ti)
    jd, ji, td, ti = np.asarray(jd), np.asarray(ji), npy(td), npy(ti)
    np.testing.assert_allclose(td, jd, rtol=1e-3, atol=1e-4)
    d6, _ = K.knn(*_t(q, p), k=6, p_mask=torch.as_tensor(pm))
    d6 = npy(d6).astype(np.float64)
    gap = np.minimum(np.diff(d6, axis=1)[:, :5], np.diff(d6, axis=1, prepend=-np.inf)[:, :5])
    clear = gap > 1e-3 * d6[:, :5] + 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(ti[clear], ji[clear])


def test_switch_is_read_at_call_time_and_cpu_stays_plain(monkeypatch):
    q, p, rng = _cloud(7, nq=50, npts=400)
    qt, pt = torch.as_tensor(q), torch.as_tensor(p)
    monkeypatch.delenv("LILI_OM_KNN_PRUNED", raising=False)
    assert not K.pruned_enabled()
    monkeypatch.setenv("LILI_OM_KNN_PRUNED", "1")
    assert K.pruned_enabled()
    K.reset_launch_counts()
    d, i = K.knn_auto(qt, pt, k=5)
    rd, ri = K.knn(qt, pt, k=5)
    assert torch.equal(d, rd) and torch.equal(i, ri) and K.launch_count() == 0


def test_pruned_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        K.knn_pruned_cuda(torch.zeros((4, 3)), torch.zeros((8, 3)), 5)
    with pytest.raises(ValueError):  # a map prepared on the CPU, too
        K.knn_pruned_cuda(torch.zeros((4, 3)), K.pruned_map(torch.zeros((8, 3))), 5)
    with pytest.raises(ValueError):
        K.pruned_map_cuda(torch.zeros((8, 3)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode "
                    "(chip_smoke.py holds it against the plain version on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5])
def test_cuda_pruned_kernel_matches_plain(cuda, k):
    """On the card: B3 against the plain version and against B1 on the
    same f32 inputs — distances and indices equal — through the raw route
    and the prepared route; the prepared map and the query order equal
    their plain versions, and the visits per block the plain schedule's."""
    q, p, rng = _cloud(8, nq=2000, npts=6000)
    qt = torch.as_tensor(q, device=cuda)
    pt = torch.as_tensor(p, device=cuda)
    pm = torch.as_tensor(rng.uniform(size=len(p)) > 0.3, device=cuda)
    qm = torch.as_tensor(rng.uniform(size=len(q)) > 0.2, device=cuda)
    d, i = K.knn_pruned_cuda(qt, pt, k, pm, qm)
    rd, ri = K.knn(qt, pt, k=k, p_mask=pm, q_mask=qm)
    cd, ci = K.knn_counted_cuda(qt, pt, k, pm, qm)
    pmap, order = K.pruned_map(pt, pm), K.query_order(qt, qm)
    pd_, pi_ = K.knn_pruned_cuda(qt, pmap, k, q_mask=qm, q_order=order)
    _, _, visited = K.launch_pruned_kernel(qt, pmap, qm, order, k)
    _, _, plain_visited = K.knn_pruned_schedule(qt, pmap, k, q_mask=qm, q_order=order)
    torch.cuda.synchronize()
    assert torch.equal(d, rd) and torch.equal(i, ri)
    assert torch.equal(d, cd) and torch.equal(i, ci)
    assert torch.equal(pd_, rd) and torch.equal(pi_, ri)
    assert torch.equal(visited, plain_visited)
    for a, b in zip(pmap[:5], K.pruned_map_plain(pt, pm)[:5]):
        assert torch.equal(a, b)
    assert torch.equal(order, K.morton_order_plain(qt, qm))
