"""io/livox: the port's numpy copy of the Livox stream adapters against the
JAX package's (both numpy): the same arrays, equal to the last bit."""
import numpy as np
import pytest

from lili_om_tpu.io import livox as JL
from lili_om_tpu_torch.io import livox as TL


def _records(n=500, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)) * 10, rng.integers(0, 6, n),
            rng.uniform(0.0, 0.1, n), rng.uniform(0.0, 255.0, n))


@pytest.mark.parametrize("fn", ["pack_unpack", "internal_imu"])
def test_matches_jax(fn):
    xyz, line, offset, refl = _records()
    if fn == "pack_unpack":
        j = JL.pack_custom_points(xyz, line, offset, refl, 0.1)
        t = TL.pack_custom_points(xyz, line, offset, refl, 0.1)
        j, t = j + JL.unpack_points(j[1], j[2]), t + TL.unpack_points(t[1], t[2])
    else:
        accs_g = np.array([0.05, -0.1, 1.0]) + 0.01 * np.random.default_rng(1).normal(size=(40, 3))
        j = JL.convert_internal_imu(accs_g, xyz[:40])
        t = TL.convert_internal_imu(accs_g, xyz[:40])
    for a, b in zip(j, t):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
