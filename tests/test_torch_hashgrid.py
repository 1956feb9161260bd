"""ops/hashgrid against the JAX package: ``build_grid``'s buckets (points,
masks and indices exactly: the same int32 spatial hash, the same stable
sort), ``hashgrid_knn`` (indices exactly, d² to 1e-12 in float64 and 1e-6
relative in float32, the order of the three squared terms' sum being XLA's),
the grid carried through ``interop`` both ways, and the four cases of
tests/test_hashgrid.py on the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.ops import hashgrid as JH
from lili_om_tpu_torch import interop
from lili_om_tpu_torch.ops import hashgrid as TH
from lili_om_tpu_torch.ops.knn import knn
from test_torch_common import npy


def _cloud(seed=0, n=5000, nq=256):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-20.0, 20.0, (n, 3))
    mask = rng.uniform(size=n) > 0.1
    q = rng.uniform(-18.0, 18.0, (nq, 3))
    return pts, mask, q


@pytest.fixture(scope="module")
def grids():
    """One cloud, both packages' grids (f64) at 16384 buckets of 16, and
    their kNN (k=5) at 256 queries."""
    pts, mask, q = _cloud()
    jg = JH.build_grid(jnp.asarray(pts), jnp.asarray(mask), 1.0, n_buckets=16384,
                       bucket_cap=16)
    tg = TH.build_grid(torch.as_tensor(pts), torch.as_tensor(mask), 1.0, n_buckets=16384,
                       bucket_cap=16)
    return (pts, mask, q), jg, tg, JH.hashgrid_knn(jnp.asarray(q), jg, k=5), \
        TH.hashgrid_knn(torch.as_tensor(q), tg, k=5)


def test_hash_cells_int32_wraparound():
    """Cells whose products overflow int32, negative cells, and a cell whose
    hash is INT32_MIN (abs keeps it negative, the floor mod folds it): the
    same buckets as JAX's int32 arithmetic."""
    rng = np.random.default_rng(3)
    cells = np.concatenate([rng.integers(-2**20, 2**20, (2000, 3)),
                            [[0, 0, 0], [-1, -1, -1], [2**31 - 1, -2**31, 7]]]).astype(np.int32)
    # find a cell hashing to INT32_MIN on the JAX side: c0·P1 ≡ 2³¹ (mod 2³²)
    # has the solution c0 = 2³¹ · P1⁻¹ mod 2³² (P1 odd) = 2³¹
    cells = np.concatenate([cells, [[-2**31, 0, 0]]]).astype(np.int32)
    h = np.asarray((jnp.asarray(cells[:, 0]) * JH._P1) ^ (jnp.asarray(cells[:, 1]) * JH._P2)
                   ^ (jnp.asarray(cells[:, 2]) * JH._P3))
    assert h[-1] == np.iinfo(np.int32).min
    for n_buckets in (16384, 1000, 7):
        np.testing.assert_array_equal(
            npy(TH._hash_cells(torch.as_tensor(cells), n_buckets)),
            np.asarray(JH._hash_cells(jnp.asarray(cells), n_buckets)))


def test_build_grid_matches_jax(grids):
    _, jg, tg, _, _ = grids
    for name, a, b in zip(jg._fields, jg, tg):
        np.testing.assert_array_equal(npy(b), np.asarray(a), err_msg=name)
    assert tg.bucket_idx.dtype == torch.int32 and tg.bucket_mask.dtype == torch.bool


def test_hashgrid_knn_matches_jax(grids):
    _, _, _, (jd, ji), (td, ti) = grids
    np.testing.assert_array_equal(npy(ti), np.asarray(ji))
    np.testing.assert_allclose(npy(td), np.asarray(jd), rtol=1e-12, atol=1e-12)


def test_float32_matches_jax():
    pts, mask, q = _cloud(seed=1, n=2000, nq=128)
    jg = JH.build_grid(jnp.asarray(pts, jnp.float32), jnp.asarray(mask), 1.5, n_buckets=4096)
    tg = TH.build_grid(torch.as_tensor(pts, dtype=torch.float32), torch.as_tensor(mask), 1.5,
                       n_buckets=4096)
    for name, a, b in zip(jg._fields, jg, tg):
        np.testing.assert_array_equal(npy(b), np.asarray(a), err_msg=name)
    jd, ji = JH.hashgrid_knn(jnp.asarray(q, jnp.float32), jg, k=3)
    td, ti = TH.hashgrid_knn(torch.as_tensor(q, dtype=torch.float32), tg, k=3)
    np.testing.assert_array_equal(npy(ti), np.asarray(ji))
    np.testing.assert_allclose(npy(td), np.asarray(jd), rtol=1e-6)


def test_interop_round_trip(grids):
    """A JAX grid carried into the port searches as the port's own grid;
    and back, as JAX's."""
    (_, _, q), jg, tg, _, (td, ti) = grids
    d = {f: np.asarray(a) for f, a in zip(jg._fields, jg)}
    carried = interop.hashgrid_from_numpy(d, dtype=torch.float64, device="cpu")
    cd, ci = TH.hashgrid_knn(torch.as_tensor(q), carried, k=5)
    assert torch.equal(ci, ti) and torch.equal(cd, td)
    back = interop.hashgrid_to_numpy(tg)
    for name, a in zip(jg._fields, jg):
        np.testing.assert_array_equal(back[name], np.asarray(a), err_msg=name)


def test_matches_brute_within_gate(grids):
    """tests/test_hashgrid.py: wherever the exact neighbours lie within the
    cell radius, the grid finds them (d² to 1e-12 in f64)."""
    (pts, mask, q), _, _, _, (td, _) = grids
    bd, _ = knn(torch.as_tensor(q), torch.as_tensor(pts), k=5, p_mask=torch.as_tensor(mask))
    within = npy(bd) < 1.0
    assert within.sum() > 50  # 72 of the 1280 (query, slot) pairs at this density
    np.testing.assert_allclose(npy(td)[within], npy(bd)[within], rtol=1e-12, atol=1e-12)


def test_masked_points_excluded():
    pts = torch.arange(100, dtype=torch.float64)[:, None].repeat(1, 3) * 0.01
    grid = TH.build_grid(pts, torch.arange(100) % 2 == 0, 1.0, n_buckets=1024, bucket_cap=64)
    _, i = TH.hashgrid_knn(torch.zeros((1, 3), dtype=torch.float64), grid, k=5)
    assert torch.all(i[0] % 2 == 0)


def test_empty_neighborhood():
    grid = TH.build_grid(torch.full((10, 3), 100.0), torch.ones(10, dtype=torch.bool), 1.0,
                         n_buckets=512, bucket_cap=8)
    d, i = TH.hashgrid_knn(torch.zeros((2, 3)), grid, k=5)
    assert torch.all(torch.isinf(d)) and torch.all(i == 0)


def test_bucket_overflow_bounded():
    """100 identical points overflow one bucket of 8: the first 8 by point
    index are kept."""
    grid = TH.build_grid(torch.zeros((100, 3)), torch.ones(100, dtype=torch.bool), 1.0,
                         n_buckets=128, bucket_cap=8)
    assert int(grid.bucket_mask.sum()) == 8
    assert sorted(grid.bucket_idx[grid.bucket_mask].tolist()) == list(range(8))


def test_exact_where_the_neighbour_buckets_are_distinct(grids):
    """Every exact neighbour inside the cell is returned for each query whose
    27 neighbour cells hash to distinct buckets (the grid's exactness
    condition); ``neighbour_buckets`` gives the search's bucket order."""
    (pts, mask, q), _, tg, _, (td, ti) = grids
    qt = torch.as_tensor(q)
    hb = TH.neighbour_buckets(qt, tg)
    assert hb.shape == (len(q), 27)
    cells = np.floor(q).astype(np.int32)
    np.testing.assert_array_equal(npy(hb[:, 13]),
                                  npy(TH._hash_cells(torch.as_tensor(cells), 16384)))
    distinct = npy((torch.sort(hb, dim=1).values.diff(dim=1) != 0).all(dim=1))
    bd, bi = knn(qt, torch.as_tensor(pts), k=5, p_mask=torch.as_tensor(mask))
    within = (npy(bd) < 1.0) & distinct[:, None]
    assert within.sum() > 50
    found = (npy(ti)[:, None, :] == npy(bi)[:, :, None]).any(-1)
    assert found[within].all()
