"""ops/knn: the port's plain kNN against the JAX package's ``knn`` and its two
Pallas kernels in interpret mode (``knn_pallas_counted``, ``knn_pallas``),
the contract cases, the device dispatch, the B1/B2 kernel's plain schedule
(``knn_lanes_schedule``: lane shares merged by (d², index)) and prepared map
(``knn_map_plain``) against the plain version, and — on a machine with a
GPU — the CUDA kernels against the plain versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.ops.knn import knn as jknn
from lili_om_tpu.ops.knn_pallas import knn_pallas, knn_pallas_counted
from lili_om_tpu_torch.ops import knn as K
from lili_om_tpu_torch.utils.math import quat_normalize, quat_rotate
from test_torch_common import npy


def _cloud(seed, nq=300, npts=3000, scale=5.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nq, 3)) * scale, rng.normal(size=(npts, 3)) * scale, rng)


def _gathered(q, p, idx):
    return np.sum((q[:, None, :] - p[idx]) ** 2, axis=-1)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_matches_jax_knn(dtype):
    """Same contract, same points: float64 agrees to 1e-9 relative (the JAX
    side expands ‖q‖²+‖p‖²−2q·p around the map centroid, the port takes
    (q−p)² directly); float32 to 1e-4 relative for the same reason. Indices
    agree wherever no two candidates tie within that tolerance."""
    q, p, rng = _cloud(0)
    mask = rng.uniform(size=p.shape[0]) > 0.2
    jd, ji = jknn(jnp.asarray(q, dtype), jnp.asarray(p, dtype), k=5, p_mask=jnp.asarray(mask))
    td, ti = K.knn(torch.as_tensor(q, dtype=getattr(torch, dtype)),
                   torch.as_tensor(p, dtype=getattr(torch, dtype)), k=5,
                   p_mask=torch.as_tensor(mask))
    tol = 1e-9 if dtype == "float64" else 1e-4
    np.testing.assert_allclose(npy(td), np.asarray(jd), rtol=tol, atol=tol)
    np.testing.assert_allclose(_gathered(q, p, npy(ti)), _gathered(q, p, np.asarray(ji)),
                               rtol=tol, atol=tol)
    if dtype == "float64":
        np.testing.assert_array_equal(npy(ti), np.asarray(ji))
    assert np.all(mask[npy(ti)])


@pytest.mark.parametrize("tile_p", [256, 512])
@pytest.mark.parametrize("pallas", ["counted", "dense"])
def test_plain_matches_pallas_interpret(pallas, tile_p):
    """Against the Pallas kernels run in interpret mode, with the small
    blocks of tests/test_knn_pallas.py. The Pallas side packs the lane index
    into the low 12 mantissa bits, so its distances are truncated to 2⁻¹²:
    rtol 1e-3, and neighbours are compared through their gathered distances."""
    q, p, rng = _cloud(1)
    q32, p32 = q.astype(np.float32), p.astype(np.float32)
    pm = np.zeros(p.shape[0], bool)
    pm[:1800] = True  # front-compacted, as the voxel tables emit
    qm = rng.uniform(size=q.shape[0]) > 0.3
    if pallas == "counted":
        jd, ji = knn_pallas_counted(jnp.asarray(q32), jnp.asarray(p32), k=5,
                                    p_mask=jnp.asarray(pm), q_mask=jnp.asarray(qm),
                                    q_block=128, tile_p=tile_p, interpret=True)
    else:
        jd, ji = knn_pallas(jnp.asarray(q32), jnp.asarray(p32), k=5, p_mask=jnp.asarray(pm),
                            q_block=128, tile_p=tile_p, interpret=True)
    td, ti = K.knn(torch.as_tensor(q32), torch.as_tensor(p32), k=5,
                   p_mask=torch.as_tensor(pm), q_mask=torch.as_tensor(qm))
    rows = qm
    np.testing.assert_allclose(npy(td)[rows], np.asarray(jd)[rows], rtol=1e-3, atol=1e-4)
    g_t = _gathered(q32.astype(np.float64), p32.astype(np.float64), npy(ti))
    g_j = _gathered(q32.astype(np.float64), p32.astype(np.float64), np.asarray(ji))
    np.testing.assert_allclose(g_t[rows], g_j[rows], rtol=1e-3, atol=1e-4)
    # invalid query rows: (+inf, 0) from the port
    assert np.all(np.isinf(npy(td)[~rows])) and np.all(npy(ti)[~rows] == 0)


def test_masked_points_never_match():
    q = torch.zeros((4, 3))
    p = torch.stack([torch.arange(512, dtype=torch.float32)] * 3, dim=1) / 100.0
    mask = torch.arange(512) % 2 == 0
    d, i = K.knn(q, p, k=5, p_mask=mask)
    assert torch.all(i % 2 == 0)
    assert torch.all(torch.isfinite(d))


def test_surplus_slots_are_inf_and_zero():
    """Fewer valid points than k: the surplus slots give (+inf, 0)."""
    pts = torch.tensor([[0.0, 0, 0], [1, 0, 0], [2, 0, 0], [9, 9, 9], [8, 8, 8]])
    mask = torch.tensor([True, True, True, False, False])
    q = torch.tensor([[0.1, 0, 0], [5.0, 5, 5]])
    d, i = K.knn(q, pts, k=5, p_mask=mask)
    assert torch.all(torch.isinf(d[:, 3:])) and torch.all(i[:, 3:] == 0)
    assert torch.all(i[:, :3] < 3)


def test_invalid_query_rows_are_inf_and_zero():
    q, p, rng = _cloud(2, nq=64, npts=256)
    qm = torch.as_tensor(rng.uniform(size=64) > 0.5)
    d, i = K.knn(torch.as_tensor(q), torch.as_tensor(p), k=5, q_mask=qm)
    assert torch.all(torch.isinf(d[~qm])) and torch.all(i[~qm] == 0)
    assert torch.all(torch.isfinite(d[qm]))


def test_empty_map():
    d, i = K.knn(torch.zeros((4, 3)), torch.ones((512, 3)), k=5,
                 p_mask=torch.zeros(512, dtype=torch.bool))
    assert torch.all(torch.isinf(d)) and torch.all(i == 0)


def test_ties_go_to_the_lower_index():
    """Equal distances: the lower map index comes first (the CUDA kernel's
    strict compares over ascending indices give the same order)."""
    p = torch.tensor([[1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0], [0, -1.0, 0], [0, 0, 1.0],
                      [0, 0, -1.0], [2.0, 0, 0]])
    d, i = K.knn(torch.zeros((1, 3)), p, k=5, tile_elems=1)  # one point per tile
    assert i[0].tolist() == [0, 1, 2, 3, 4]
    assert torch.all(d == 1.0)


def test_far_from_origin_accuracy():
    """A 500 m offset: f32 distances taken directly as (q−p)² stay within
    1e-4 m² of float64 brute force (the JAX expansion needs re-centering
    for this; the direct form does not)."""
    rng = np.random.default_rng(7)
    q = (rng.uniform(-10, 10, (64, 3)) + 500.0).astype(np.float32)
    p = (rng.uniform(-10, 10, (512, 3)) + 500.0).astype(np.float32)
    d_true = np.sort(np.sum((q[:, None].astype(np.float64) - p[None].astype(np.float64)) ** 2,
                            axis=-1), axis=1)[:, :5]
    d, _ = K.knn(torch.as_tensor(q), torch.as_tensor(p), k=5)
    np.testing.assert_allclose(npy(d), d_true, atol=1e-4)


def test_tiling_does_not_change_the_result():
    q, p, rng = _cloud(3, nq=100, npts=2000)
    pm = torch.as_tensor(rng.uniform(size=2000) > 0.4)
    a = K.knn(torch.as_tensor(q), torch.as_tensor(p), k=5, p_mask=pm)
    b = K.knn(torch.as_tensor(q), torch.as_tensor(p), k=5, p_mask=pm, tile_elems=100 * 300)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_auto_dispatch_on_cpu_runs_the_plain_version():
    q, p, rng = _cloud(4, nq=50, npts=400)
    qt, pt = torch.as_tensor(q), torch.as_tensor(p)
    pm = torch.as_tensor(rng.uniform(size=400) > 0.3)
    K.reset_launch_counts()
    d, i = K.knn_auto(qt, pt, k=5, p_mask=pm)
    ref = K.knn(qt, pt, k=5, p_mask=pm)
    assert torch.equal(d, ref[0]) and torch.equal(i, ref[1])
    # world transform + search, and the surf/edge pair
    t = torch.tensor([0.3, -1.0, 2.0], dtype=torch.float64)
    qq = quat_normalize(torch.tensor([0.9, 0.1, -0.2, 0.3], dtype=torch.float64))
    pw, d2, idx = K.world_knn_auto(t, qq, qt, pt, k=5, p_mask=pm)
    assert torch.allclose(pw, quat_rotate(qq[None], qt) + t)
    ref = K.knn(pw, pt, k=5, p_mask=pm)
    assert torch.equal(d2, ref[0]) and torch.equal(idx, ref[1])
    out = K.knn_pair_auto(qt, pt, pm, qt[:10], pt[:100], None, k=5)
    assert len(out) == 4 and torch.equal(out[0], d)
    assert K.launch_count() == 0


def _schedule_case(case, dtype, rng):
    """(queries, points, p_mask, q_mask, k) of one contract case of the
    lanes schedule."""
    if case == "ties":
        # integer grids: most distances tie, across lanes and within them
        q = rng.integers(-3, 4, (120, 3))
        p = rng.integers(-3, 4, (900, 3))
        pm, qm, k = None, None, 8
    else:
        q, p, _ = _cloud(11, nq=150, npts=1200)
        pm = rng.uniform(size=1200) > 0.4
        pm[1000:] = False  # valid rows front-compacted, with holes
        qm = rng.uniform(size=150) > 0.3
        k = 5
        if case == "all_masked":
            pm[:] = False
        elif case == "k_above_valid":
            pm[:] = False
            pm[[3, 40, 41, 777]] = True
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    return (t(q), t(p), None if pm is None else torch.as_tensor(pm),
            None if qm is None else torch.as_tensor(qm), k)


@pytest.mark.parametrize("lanes", [1, 8, 32])
@pytest.mark.parametrize("case", ["ties", "masked", "all_masked", "k_above_valid"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lanes_schedule_matches_plain(dtype, case, lanes):
    """The B1/B2 kernel's schedule (each lane's strided rows, its own top-k,
    the lists merged by (d², index)) equals the plain kNN bit for bit, in
    both float types: with ties across lanes, masked rows, an all-masked map,
    fewer valid points than k and invalid query rows."""
    q, p, pm, qm, k = _schedule_case(case, dtype, np.random.default_rng(lanes))
    d, i = K.knn_lanes_schedule(q, p, k, p_mask=pm, q_mask=qm, lanes=lanes)
    rd, ri = K.knn(q, p, k=k, p_mask=pm, q_mask=qm)
    assert torch.equal(d, rd) and torch.equal(i, ri)
    if case == "ties":
        assert int((d[:, 1:] == d[:, :-1]).sum()) > 100
    if case == "k_above_valid":
        rows = torch.isfinite(d).sum(dim=1)
        assert int(rows.max()) == 4 and torch.all(i[:, 4:] == 0)


def test_knn_map_plain_rows_and_bound():
    """The prepared map: float4 rows with the mask as lane 3 (0 / +inf), and
    the walk bound one past the last valid row, the row count without a
    mask, 0 for an all-masked or empty map; the schedule on the prepared map
    equals the one on raw points."""
    _, p, rng = _cloud(12, nq=8, npts=300)
    pt = torch.as_tensor(p, dtype=torch.float32)
    pm = torch.as_tensor(rng.uniform(size=300) > 0.5)
    pm[251:] = False
    pm[250] = True
    m = K.knn_map_plain(pt, pm)
    assert m.n_points == 300 and m.bound.dtype == torch.int32 and m.bound.tolist() == [251]
    assert torch.equal(m.pts4[:, :3], pt)
    assert torch.equal(m.pts4[:, 3], torch.where(pm, 0.0, float("inf")))
    assert K.knn_map_plain(pt).bound.tolist() == [300]
    assert torch.all(K.knn_map_plain(pt).pts4[:, 3] == 0.0)
    assert K.knn_map_plain(pt, torch.zeros(300, dtype=torch.bool)).bound.tolist() == [0]
    assert K.knn_map_plain(pt[:0], pm[:0]).bound.tolist() == [0]
    qt = torch.as_tensor(rng.normal(size=(40, 3)) * 5.0, dtype=torch.float32)
    a = K.knn_lanes_schedule(qt, m, 5, lanes=8)
    b = K.knn_lanes_schedule(qt, pt, 5, p_mask=pm, lanes=8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # the knn_map dispatcher takes the plain version on a CPU tensor
    K.reset_launch_counts()
    c = K.knn_map(pt, pm)
    assert all(torch.equal(x, y) for x, y in zip(c[:2], m[:2])) and K.launch_count() == 0


def test_prepared_map_carries_its_mask():
    m = K.knn_map_plain(torch.zeros((8, 3)))
    with pytest.raises(ValueError):
        K.knn_counted_cuda(torch.zeros((4, 3)), m, 5, p_mask=torch.ones(8, dtype=torch.bool))


@pytest.mark.parametrize("wrapper", ["knn_counted_cuda", "knn_dense_cuda"])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper):
    """The kernel wrappers never fall back: a CPU tensor raises."""
    with pytest.raises(ValueError):
        getattr(K, wrapper)(torch.zeros((4, 3)), torch.zeros((8, 3)), 5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode "
                    "(chip_smoke.py holds it against the plain version on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("counted", [True, False])
def test_cuda_kernel_matches_plain(cuda, counted):
    """On the card: the kernel against the plain version, same f32 inputs.
    Both sum ((dx²+dy²)+dz²) without FMA and break ties toward the lower
    index, so distances and indices agree exactly."""
    q, p, rng = _cloud(5, nq=1000, npts=5000)
    qt = torch.as_tensor(q, dtype=torch.float32, device=cuda)
    pt = torch.as_tensor(p, dtype=torch.float32, device=cuda)
    pm = torch.zeros(5000, dtype=torch.bool, device=cuda)
    pm[:3000] = True
    qm = torch.as_tensor(rng.uniform(size=1000) > 0.3, device=cuda)
    fn = K.knn_counted_cuda if counted else K.knn_dense_cuda
    d, i = fn(qt, pt, 5, pm, qm)
    rd, ri = K.knn(qt, pt, k=5, p_mask=pm, q_mask=qm)
    torch.cuda.synchronize()
    assert torch.equal(d, rd) and torch.equal(i, ri)


@pytest.mark.cuda
def test_cuda_prepared_route_matches_plain(cuda):
    """On the card: the preparation kernel against ``knn_map_plain``, and
    both launch names on the prepared map against the plain version (bit
    for bit)."""
    q, p, rng = _cloud(6, nq=1000, npts=5000)
    qt = torch.as_tensor(q, dtype=torch.float32, device=cuda)
    pt = torch.as_tensor(p, dtype=torch.float32, device=cuda)
    pm = torch.as_tensor(rng.uniform(size=5000) > 0.5, device=cuda)
    pm[4001:] = False
    qm = torch.as_tensor(rng.uniform(size=1000) > 0.3, device=cuda)
    m = K.knn_map(pt, pm)
    ref = K.knn_map_plain(pt, pm)
    torch.cuda.synchronize()
    assert torch.equal(m.pts4, ref.pts4) and torch.equal(m.bound, ref.bound)
    rd, ri = K.knn(qt, pt, k=5, p_mask=pm, q_mask=qm)
    for fn in (K.knn_counted_cuda, K.knn_dense_cuda):
        d, i = fn(qt, m, 5, q_mask=qm)
        torch.cuda.synchronize()
        assert torch.equal(d, rd) and torch.equal(i, ri), fn.__name__


def test_gather_neighbors_matches_jax():
    """(P,3) rows picked by a (Q,k) index: exactly JAX's, on the plain kNN's
    own output."""
    from lili_om_tpu.ops.knn import gather_neighbors as jax_gather

    rng = np.random.default_rng(12)
    pts = rng.normal(size=(300, 3))
    _, idx = K.knn(torch.as_tensor(rng.normal(size=(40, 3))), torch.as_tensor(pts), k=5)
    got = K.gather_neighbors(torch.as_tensor(pts), idx)
    assert got.shape == (40, 5, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_gather(jnp.asarray(pts),
                                                                     jnp.asarray(idx.numpy()))))
