"""parallel/dist_fusion.py: the port's query-sharded backend fusion on 2
spawned gloo ranks on the CPU (one world for the module,
torch_dist_ranks.py), against the JAX package's ``make_distributed_fusion``
(GSPMD) on 2 of the conftest's virtual CPU devices and against the port's
single-device ``fusion_step``.

The inputs (torch_dist_ranks.py:dist_fusion_inputs, numpy from a seed) are
4 keyframes of a room seen from rest at tests/test_dist_fusion.py's ``CFG``
(window 3: 2 warm-up keyframes, 2 solved), with masked surf rows and
keyframes without edge points, so that at the solved keyframes the second
rank's block of edge rows holds no valid query.

* Against JAX, float64: ``t_latest`` / ``q_latest`` to 1e-8 (JAX's own
  bound between its sharded and single-device steps), the whole carried
  state and the other outputs to 1e-8, the marginal prior through JᵀJ and
  Jᵀr0 (its square root is unique only up to signs) relative to its
  largest entry; the correspondence counts equal.
* Against the port's single-device ``fusion_step`` on the same inputs in
  the same process, float64 and float32: bit for bit (each query's search
  and fit depend on that query alone, and the gather only moves values).
* The two ranks end with the same state; the blocks split the window's
  rows in rank order.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_ranks as R
from lili_om_tpu.models.fusion import FusionConfig as JF
from lili_om_tpu.ops.preintegration import ImuNoise as JNoise
from lili_om_tpu.parallel.dist_fusion import make_distributed_fusion, make_sharded_state
from lili_om_tpu.parallel.sharded import make_mesh
from lili_om_tpu_torch.parallel.dist_fusion import dist_fusion_blocks
from test_torch_common import assert_close_dicts, state_dict

TOL = 1e-8


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.Ranks(R.dist_fusion_ranks, 2, tmp_path_factory.mktemp("dist_fusion_ranks"),
                   axis="d")


@pytest.fixture(scope="module")
def jax_run(ranks):
    """JAX's sharded step over the keyframes on 2 devices (the ranks run
    meanwhile): the final (state, out) and the per-keyframe counts. One
    compile per warm-up flag."""
    cfg, noise = JF(**R.dist_fusion_config()._asdict()), JNoise()
    mesh = make_mesh(2, axis="d")
    warm, _ = make_distributed_fusion(mesh, cfg, noise, warmup=True)
    main, _ = make_distributed_fusion(mesh, cfg, noise, warmup=False)
    st = make_sharded_state(mesh, cfg, noise, dtype=jnp.float64)
    counts = []
    for k, args in enumerate(R.dist_fusion_inputs(cfg, noise.g_norm)):
        st, out = (warm if k + 1 < cfg.window else main)(st, *[jnp.asarray(a) for a in args])
        counts.append([int(out.n_surf_corr), int(out.n_edge_corr)])
    return st, out, np.array(counts)


def _port(ranks, prefix, rank=0):
    res = ranks.results()[rank]
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def test_dist_fusion_matches_jax(ranks, jax_run):
    j_st, j_out, j_counts = jax_run
    out = _port(ranks, "float64_out.")
    np.testing.assert_allclose(out["t_latest"], np.asarray(j_out.t_latest), rtol=0.0, atol=TOL)
    np.testing.assert_allclose(out["q_latest"], np.asarray(j_out.q_latest), rtol=0.0, atol=TOL)
    counts = ranks.results()[0]["float64_counts"]
    np.testing.assert_array_equal(counts, j_counts)
    assert counts[-1, 0] > 100 and counts[-1, 1] > 0  # the solved keyframes have factors
    assert_close_dicts(state_dict(j_out), out, rtol=0.0, atol=TOL, what="out")
    js, ts = state_dict(j_st), state_dict(_Tree(_port(ranks, "float64_state.")))
    for k in ("prior.JtJ", "prior.Jtr0"):
        a, b = js.pop(k), ts.pop(k)
        np.testing.assert_allclose(b, a, rtol=0.0, atol=TOL * max(np.abs(a).max(), 1.0),
                                   err_msg=k)
    assert_close_dicts(js, ts, rtol=0.0, atol=TOL, what="state")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dist_fusion_equals_port_single_device(ranks, dtype):
    for what in ("state", "out"):
        dist, single = _port(ranks, f"{dtype}_{what}."), _port(ranks, f"{dtype}_single_{what}.")
        assert set(dist) == set(single)
        for k in dist:
            np.testing.assert_array_equal(dist[k], single[k], err_msg=f"{dtype} {what} {k}")


def test_dist_fusion_ranks_agree(ranks):
    r0, r1 = ranks.results()
    assert set(r0) == set(r1)
    for k in r0:
        np.testing.assert_array_equal(r1[k], r0[k], err_msg=k)
    # W·Sc = 1536 surf rows and W·Ec = 384 edge rows in rank order
    np.testing.assert_array_equal(r0["blocks"], [[0, 768, 0, 192], [768, 1536, 192, 384]])


class _StandInMesh:
    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


def test_dist_fusion_blocks_need_divisible_rows():
    cfg = R.dist_fusion_config()
    assert dist_fusion_blocks(_StandInMesh(3), cfg)[2] == (slice(1024, 1536), slice(256, 384))
    with pytest.raises(ValueError, match="must divide"):
        dist_fusion_blocks(_StandInMesh(5), cfg)


class _Tree:
    """A flat {dotted field: array} dict seen as a nested NamedTuple, for
    ``state_dict``."""

    def __init__(self, flat):
        self.flat = flat

    def _asdict(self):
        return self.flat
