"""ops/voxel: the functions on the per-scan path against the JAX package.
Output slots come out in ascending scrambled-key order on both sides, so
they are compared slot by slot: keys, cells, masks and counts exactly; the
centroid sums (summed in another order inside a voxel) to 1e-12 in float64
and 1e-5 m in float32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.ops import voxel as JV
from lili_om_tpu_torch.ops import voxel as TV
from test_torch_common import npy, port_sim_frames


TOL = {"float64": 1e-12, "float32": 1e-5}


@pytest.fixture(scope="module")
def scan():
    fr, _ = port_sim_frames(2)
    return fr[1]


def _same(a, b, dtype, exact=False):
    a, b = np.asarray(a), npy(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if exact or a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(b, a)
    else:
        np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64),
                                   rtol=TOL[dtype], atol=TOL[dtype] * 10)


def test_scramble_bit_exact():
    """The int64-masked port of the uint32 mix gives the JAX int32 values,
    sign bit included, over the whole key range."""
    rng = np.random.default_rng(0)
    keys = np.concatenate([rng.integers(-2**31, 2**31 - 1, 20000, dtype=np.int64),
                           [0, 1, -1, 2**31 - 1, -2**31, 2**30]]).astype(np.int32)
    _same(JV._scramble(jnp.asarray(keys)), TV._scramble(torch.as_tensor(keys)), "float64")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_voxel_keys(scan, dtype):
    pts = scan["img"].reshape(-1, 3)
    mask = scan["valid"].reshape(-1)
    _same(JV.voxel_keys(jnp.asarray(pts, getattr(jnp, dtype)), 0.4, jnp.asarray(mask)),
          TV.voxel_keys(torch.as_tensor(pts, dtype=getattr(torch, dtype)), 0.4,
                        torch.as_tensor(mask)), dtype)


def _cloud(scan, dtype):
    pts = scan["img"].reshape(-1, 3)
    mask = scan["valid"].reshape(-1)
    R = scan["img"].shape[0]
    groups = np.repeat(np.arange(R, dtype=np.int32), scan["img"].shape[1])
    feats = scan["rel"].reshape(-1, 1)
    j = (jnp.asarray(pts, getattr(jnp, dtype)), jnp.asarray(mask), jnp.asarray(feats, getattr(jnp, dtype)),
         jnp.asarray(groups))
    t = (torch.as_tensor(pts, dtype=getattr(torch, dtype)), torch.as_tensor(mask),
         torch.as_tensor(feats, dtype=getattr(torch, dtype)), torch.as_tensor(groups))
    return j, t


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("variant", ["plain", "feats_groups", "overflow"])
def test_voxel_downsample(scan, dtype, ordered, variant):
    """Slot-by-slot parity, with per-ring groups and a feature channel, and
    at a capacity the cloud overflows (voxels dropped in hash order)."""
    (jp, jm, jf, jg), (tp, tm, tf, tg) = _cloud(scan, dtype)
    cap = 512 if variant == "overflow" else 4096
    kw_j, kw_t = {}, {}
    if variant == "feats_groups":
        kw_j, kw_t = {"feats": jf, "groups": jg}, {"feats": tf, "groups": tg}
    jfn = JV.voxel_downsample_ordered if ordered else JV.voxel_downsample
    tfn = TV.voxel_downsample_ordered if ordered else TV.voxel_downsample
    jo = jfn(jp, jm, 0.4, cap, **kw_j)
    to = tfn(tp, tm, 0.4, cap, **kw_t)
    assert len(jo) == len(to)
    _same(jo[-1], to[-1], dtype)  # masks
    assert 0 < int(np.sum(np.asarray(jo[-1]))) <= cap
    for a, b in zip(jo[:-1], to[:-1]):
        _same(a, b, dtype)
    if variant == "overflow":
        assert bool(np.asarray(jo[-1]).all())


def test_valid_first_tables(scan):
    """Valid segments occupy the leading rows (the kNN kernel's walk bound)."""
    _, (tp, tm, _, tg) = _cloud(scan, "float32")
    for out in (TV.voxel_downsample(tp, tm, 0.4, 4096),
                TV.voxel_downsample_ordered(tp, tm, 0.4, 4096, groups=tg)):
        m = npy(out[-1])
        n = int(m.sum())
        assert m[:n].all() and not m[n:].any()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("second", [False, True])
def test_merge_voxel_entries(scan, dtype, second):
    """A table update as the odometry and fusion steps make it: a table,
    new entries (+1 counts) and evicted ones (−1 counts) that cancel some
    voxels; with ``second`` also the two-selection form of the fusion map."""
    pts = scan["img"].reshape(-1, 3)
    mask = scan["valid"].reshape(-1)
    (jp, jm, _, _), _ = _cloud(scan, dtype)
    table, tmask = (np.asarray(x) for x in JV.voxel_downsample(jp, jm, 0.4, 2048))
    rng = np.random.default_rng(1)
    new = pts[mask][rng.choice(int(mask.sum()), 1500, replace=False)] + 0.05
    ev = table[:600]
    ev_mask = tmask[:600] & (rng.uniform(size=600) > 0.3)
    leaf = 0.4
    cells = np.concatenate([np.floor(table / leaf), np.floor(new / leaf),
                            np.floor(ev / leaf)]).astype(np.int32)
    sums = np.concatenate([table, new, -ev])
    cnt = np.concatenate([tmask.astype(float), np.ones(1500), -ev_mask.astype(float)])
    valid = np.concatenate([tmask, np.ones(1500, bool), ev_mask])
    sel = rng.uniform(size=valid.shape[0]) > 0.4
    args_j = [jnp.asarray(cells), jnp.asarray(sums, getattr(jnp, dtype)),
              jnp.asarray(cnt, getattr(jnp, dtype)), jnp.asarray(valid)]
    args_t = [torch.as_tensor(cells), torch.as_tensor(sums, dtype=getattr(torch, dtype)),
              torch.as_tensor(cnt, dtype=getattr(torch, dtype)), torch.as_tensor(valid)]
    kw_j = {"second_sel": jnp.asarray(sel)} if second else {}
    kw_t = {"second_sel": torch.as_tensor(sel)} if second else {}
    jo = JV.merge_voxel_entries(*args_j, 3000, **kw_j)
    to = TV.merge_voxel_entries(*args_t, 3000, **kw_t)
    if second:
        jo, to = jo[0] + jo[1], to[0] + to[1]
    for a, b in zip(jo, to):
        _same(a, b, dtype)


@pytest.mark.parametrize("n", [100, 5000])
def test_pad_cloud(n):
    rng = np.random.default_rng(2)
    pts, mask = rng.normal(size=(n, 3)), rng.uniform(size=n) > 0.5
    for a, b in zip(JV.pad_cloud(jnp.asarray(pts), jnp.asarray(mask), 1024),
                    TV.pad_cloud(torch.as_tensor(pts), torch.as_tensor(mask), 1024)):
        _same(a, b, "float64", exact=True)


def test_voxel_downsample_np_matches_jax(scan):
    """The host-side exact downsample of the loop-closure submaps: numpy on
    both sides, the same voxels in the same (key) order, equal to the last
    bit; over a span wider than the device keys' 1024 cells per axis."""
    pts = scan["img"].reshape(-1, 3)[scan["valid"].reshape(-1)].astype(np.float64)
    pts = np.concatenate([pts, pts + np.array([900.0, -700.0, 30.0])])
    a, b = JV.voxel_downsample_np(pts, 0.4), TV.voxel_downsample_np(pts, 0.4)
    assert b.shape == a.shape and len(b) < len(pts)
    np.testing.assert_array_equal(b, a)
    assert TV.voxel_downsample_np(pts[:0], 0.4).shape == (0, 3)


def _grouped_key_at_i32_max():
    """A (30-bit voxel key, group) whose grouped mix is ``I32_MAX``, the
    int32 sort fill of invalid rows: the lowbias32 mix inverted."""
    M = 0xFFFFFFFF

    def unxorshift(h, s):
        x = h
        for _ in range(32 // s + 1):
            x = h ^ (x >> s)
        return x

    def unmix(h):
        h = unxorshift(h, 16)
        h = (h * pow(0x846CA68B, -1, 2**32)) & M
        h = unxorshift(h, 15)
        h = (h * pow(0x7FEB352D, -1, 2**32)) & M
        return unxorshift(h, 16)

    for g in range(1, 1000):
        gm = (g * -1640531527) & M
        key = unmix(unmix(M) ^ gm ^ 0x80000000)
        if key < 2**30:
            return key, g
    raise AssertionError("no key found")


@pytest.mark.parametrize("ordered", [False, True])
def test_grouped_key_at_int32_max_stays_one_voxel(ordered):
    """A valid voxel whose grouped scramble equals the invalid rows' fill,
    its points interleaved with invalid rows: the port sorts the invalid
    rows strictly last, so the voxel stays one segment (the segment ids the
    segment sum takes stay non-decreasing) and the table stays valid-first.
    The JAX package sorts it among the invalid rows and splits it (ROADMAP
    §C)."""
    key, g = _grouped_key_at_i32_max()
    cell = np.array([key >> 20, (key >> 10) & 1023, key & 1023], float)
    assert int(TV._group_mix(TV._scramble(torch.tensor([key], dtype=torch.int32)),
                             torch.tensor([g]))[0]) == 2**31 - 1
    pts = np.array([[0.5, 0.5, 0.5], [3.0, 3.0, 3.0], cell + 0.25, [4.0, 4.0, 4.0],
                    cell + 0.75, [5.0, 5.0, 5.0]])
    mask = np.array([True, False, True, False, True, False])
    groups = np.array([0, g, g, g, g, g], np.int32)
    fn = TV.voxel_downsample_ordered if ordered else TV.voxel_downsample
    out, m = fn(torch.as_tensor(pts), torch.as_tensor(mask), 1.0, 8,
                groups=torch.as_tensor(groups))
    out, m = npy(out), npy(m)
    assert m.tolist() == [True, True] + [False] * 6
    got = sorted(map(tuple, out[:2]))
    np.testing.assert_array_equal(got, sorted([(0.5, 0.5, 0.5), tuple(cell + 0.5)]))


def _tiered_inputs(occ, T=1024, D=256, seed=0):
    """tests/test_ops_core.py's table of ``occ`` valid rows out of T plus D
    delta rows, with optional primary/second selections."""
    rng = np.random.default_rng(seed)
    cells_t = np.zeros((T, 3), np.int32)
    cells_t[:occ] = rng.integers(0, 30, (occ, 3))
    valid_t = np.zeros(T, bool)
    valid_t[:occ] = True
    sums_t = rng.normal(size=(T, 4)) * valid_t[:, None]
    cnt_t = (rng.integers(1, 5, T) * valid_t).astype(np.float64)
    cells_d = rng.integers(0, 30, (D, 3)).astype(np.int32)
    valid_d = rng.uniform(size=D) < 0.8
    sums_d = rng.normal(size=(D, 4)) * valid_d[:, None]
    cnt_d = (rng.integers(1, 3, D) * valid_d).astype(np.float64)
    psel = rng.uniform(size=T + D) < 0.7
    ssel = rng.uniform(size=T + D) < 0.5
    return (np.concatenate([cells_t, cells_d]), np.concatenate([sums_t, sums_d]),
            np.concatenate([cnt_t, cnt_d]), np.concatenate([valid_t, valid_d]), psel, ssel)


# occupancies: the 256 tier taken (0, 50), the 512 tier (300), the full
# merge (900); "beyond": a valid table row past every tier forces the full
# merge at low occupancy
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("sel", [False, True])
@pytest.mark.parametrize("occ", [0, 50, 300, 900, "beyond"])
def test_merge_voxel_entries_tiered(dtype, sel, occ):
    """The tiered merge against the port's full merge and against JAX's
    tiered merge, output slot by slot (cells, counts, masks exactly; sums
    to the module's tolerance)."""
    cells, sums, cnt, valid, psel, ssel = _tiered_inputs(50 if occ == "beyond" else occ)
    if occ == "beyond":
        valid[700] = True
        cells[700] = (3, 4, 5)
        cnt[700] = 2.0
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    args_j = [jnp.asarray(cells), jnp.asarray(sums, jd), jnp.asarray(cnt, jd), jnp.asarray(valid)]
    args_t = [torch.as_tensor(cells), torch.as_tensor(sums, dtype=td),
              torch.as_tensor(cnt, dtype=td), torch.as_tensor(valid)]
    kw_j = dict(second_sel=jnp.asarray(ssel), primary_sel=jnp.asarray(psel)) if sel else {}
    kw_t = dict(second_sel=torch.as_tensor(ssel), primary_sel=torch.as_tensor(psel)) if sel else {}
    jo = JV.merge_voxel_entries_tiered(*args_j, 1024, 1024, tiers=(256, 512), **kw_j)
    to = TV.merge_voxel_entries_tiered(*args_t, 1024, 1024, tiers=(256, 512), **kw_t)
    full = TV.merge_voxel_entries(*args_t, 1024, **kw_t)
    if sel:
        jo, to, full = jo[0] + jo[1], to[0] + to[1], full[0] + full[1]
    for a, b, c in zip(jo, to, full):
        _same(a, b, dtype)
        _same(npy(c), b, dtype)


def test_remove_close_points():
    """tests/test_ops_core.py's case plus an infinite point and a masked
    one, against JAX's (a boolean mask, exactly)."""
    pts = np.array([[0.05, 0, 0], [5.0, 0, 0], [np.nan, 0, 0], [0, np.inf, 0], [3, 4, 0],
                    [0.06, 0.08, 0.0]])
    mask = np.array([True, True, True, True, False, True])
    for min_range in (0.1, 3.0):
        j = np.asarray(JV.remove_close_points(jnp.asarray(pts), jnp.asarray(mask), min_range))
        t = TV.remove_close_points(torch.as_tensor(pts), torch.as_tensor(mask), min_range)
        np.testing.assert_array_equal(t.numpy(), j)
    assert t.tolist() == [False, True, False, False, False, False]
