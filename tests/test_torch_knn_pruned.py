"""ops/knn, kernel B3: the pruned kNN's pre-pass and its plain schedule
(``knn_pruned_schedule``: the kernel's Morton sort, tile order and skip
test, walked in torch) against the JAX package's ``_morton30``,
``_block_bounds`` and ``knn_pallas_pruned`` (interpret mode) and against the
plain ``knn``; the ``LILI_OM_KNN_PRUNED`` switch; and, on a machine with a
GPU, the CUDA kernel against the plain version."""
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
    """The schedule equals the plain version bit for bit, indices included."""
    q, p, pm, qm = _t(q, p, pm, qm)
    d, i, skipped = K.knn_pruned_schedule(q, p, k, pm, qm, **blocks)
    rd, ri = K.knn(q, p, k=k, p_mask=pm, q_mask=qm)
    assert torch.equal(d, rd), float((d - rd)[torch.isfinite(rd)].abs().max())
    assert torch.equal(i, ri), int((i != ri).sum())
    assert 0.0 <= skipped <= 1.0
    return d, i, skipped


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


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("blocks", ["small", "kernel"])
def test_schedule_equals_plain_random(k, blocks):
    """Random clouds, masked map rows and invalid queries; at the test's
    small blocks and at the kernel's own (64 queries, 1024-point tiles)."""
    q, p, rng = _cloud(2)
    pm = rng.uniform(size=len(p)) > 0.3
    qm = rng.uniform(size=len(q)) > 0.2
    _assert_equals_plain(q, p, k, pm, qm, **(SMALL if blocks == "small" else {}))


@pytest.mark.parametrize("k", [1, 5])
def test_schedule_equals_plain_on_ties(k):
    """A lattice queried at cell centres and corners: many equal distances,
    resolved toward the lower original index whatever the tile order."""
    g = np.arange(8, dtype=np.float32)
    lat = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    q = np.concatenate([lat[::5] + 0.5, lat[::7]]).astype(np.float32)
    _assert_equals_plain(q, lat[::-1].copy(), k, **SMALL)


@pytest.mark.parametrize("k", [1, 5])
def test_schedule_equals_plain_on_duplicates(k):
    """Every map point twice (and a third copy masked out): equal distances
    at different indices."""
    q, p, _ = _cloud(3, nq=200, npts=700)
    pd = np.concatenate([p, p[::-1], p])
    pm = np.arange(len(pd)) < 2 * len(p)
    _assert_equals_plain(q, pd, k, pm, **SMALL)


def test_schedule_all_masked_map():
    q, p, _ = _cloud(4, nq=100, npts=500)
    d, i, skipped = _assert_equals_plain(q, p, 5, np.zeros(len(p), bool), **SMALL)
    assert torch.all(torch.isinf(d)) and torch.all(i == 0)
    assert skipped == 0.0  # no valid tile: nothing to skip


def test_schedule_fewer_points_than_k():
    pts = np.array([[0.0, 0, 0], [1, 0, 0], [2, 0, 0], [9, 9, 9], [8, 8, 8]], np.float32)
    q = np.array([[0.1, 0, 0], [5.0, 5, 5]], np.float32)
    d, i, _ = _assert_equals_plain(q, pts, 5, np.array([1, 1, 1, 0, 0], bool))
    assert torch.all(torch.isinf(d[:, 3:])) and torch.all(i[:, 3:] == 0)


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
    same f32 inputs — distances and indices equal."""
    q, p, rng = _cloud(8, nq=2000, npts=6000)
    qt = torch.as_tensor(q, device=cuda)
    pt = torch.as_tensor(p, device=cuda)
    pm = torch.as_tensor(rng.uniform(size=len(p)) > 0.3, device=cuda)
    qm = torch.as_tensor(rng.uniform(size=len(q)) > 0.2, device=cuda)
    d, i = K.knn_pruned_cuda(qt, pt, k, pm, qm)
    rd, ri = K.knn(qt, pt, k=k, p_mask=pm, q_mask=qm)
    cd, ci = K.knn_counted_cuda(qt, pt, k, pm, qm)
    torch.cuda.synchronize()
    assert torch.equal(d, rd) and torch.equal(i, ri)
    assert torch.equal(d, cd) and torch.equal(i, ci)
