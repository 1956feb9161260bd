"""utils/math: each port function against its JAX counterpart on the same
seeded inputs (the cases of tests/test_math.py). float64 agrees to 1e-12
(the same formulas; only the rounding of individual ops differs); one
float32 case per function agrees to 1e-5."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.utils import math as JM
from lili_om_tpu_torch.utils import math as TM
from test_torch_common import npy

N = 64


def _unit_quats(rng, n=N):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _inputs(rng):
    q1, q2 = _unit_quats(rng), _unit_quats(rng)
    v = rng.normal(size=(N, 3)) * 3.0
    th = rng.normal(size=(N, 3)) * 0.7
    t1, t2 = rng.normal(size=(N, 3)), rng.normal(size=(N, 3))
    return dict(q1=q1, q2=q2, v=v, th=th, t1=t1, t2=t2,
                small=rng.normal(size=(N, 3)) * 1e-7, frac=rng.uniform(size=N),
                delta=np.concatenate([t2, th], axis=-1))


CASES = {
    "hat": lambda M, a: M.hat(a["v"]),
    "quat_mul": lambda M, a: M.quat_mul(a["q1"], a["q2"]),
    "quat_conj": lambda M, a: M.quat_conj(a["q1"]),
    "quat_normalize": lambda M, a: M.quat_normalize(a["q1"] * 3.0),
    "quat_rotate": lambda M, a: M.quat_rotate(a["q1"], a["v"]),
    "quat_to_rotmat": lambda M, a: M.quat_to_rotmat(a["q1"]),
    "rotmat_to_quat": lambda M, a: M.rotmat_to_quat(M.quat_to_rotmat(a["q1"])),
    "unify_quaternion": lambda M, a: M.unify_quaternion(a["q1"]),
    "quat_left_matrix": lambda M, a: M.quat_left_matrix(a["q1"]),
    "quat_right_matrix": lambda M, a: M.quat_right_matrix(a["q1"]),
    "exp_so3": lambda M, a: M.exp_so3(a["th"]),
    "exp_so3_small": lambda M, a: M.exp_so3(a["small"]),
    "log_so3": lambda M, a: M.log_so3(a["q1"]),
    "so3_right_jacobian": lambda M, a: M.so3_right_jacobian(a["th"]),
    "so3_right_jacobian_small": lambda M, a: M.so3_right_jacobian(a["small"]),
    "so3_right_jacobian_inv": lambda M, a: M.so3_right_jacobian_inv(a["th"]),
    "quat_slerp": lambda M, a: M.quat_slerp(a["q1"], a["q2"], a["frac"]),
    "quat_slerp_near": lambda M, a: M.quat_slerp(a["q1"], a["q1"], a["frac"]),
    "pose_retract": lambda M, a: M.pose_retract(a["t1"], a["q1"], a["delta"]),
    "pose_compose": lambda M, a: M.pose_compose(a["t1"], a["q1"], a["t2"], a["q2"]),
    "pose_inverse": lambda M, a: M.pose_inverse(a["t1"], a["q1"]),
    "pose_relative": lambda M, a: M.pose_relative(a["t1"], a["q1"], a["t2"], a["q2"]),
    "transform_points": lambda M, a: M.transform_points(a["t1"][0], a["q1"][0], a["v"]),
    "masked_mean": lambda M, a: M.masked_mean(a["v"], a["frac"][:, None] > 0.5),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_matches_jax(name, dtype):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    a = _inputs(rng)
    fn = CASES[name]
    jconv = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in a.items()}
    tconv = {k: torch.as_tensor(v, dtype=getattr(torch, dtype)) for k, v in a.items()}
    jo, to = fn(JM, jconv), fn(TM, tconv)
    jo = jo if isinstance(jo, tuple) else (jo,)
    to = to if isinstance(to, tuple) else (to,)
    tol = 1e-12 if dtype == "float64" else 1e-5
    for x, y in zip(jo, to):
        assert npy(y).dtype == np.asarray(x).dtype
        np.testing.assert_allclose(np.asarray(x, np.float64), npy(y).astype(np.float64),
                                   rtol=tol, atol=tol)


def test_solve_psd_matches_jax():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(6, 6))
    A = A @ A.T + 0.1 * np.eye(6)
    b = rng.normal(size=6)
    x_j = JM.solve_psd(jnp.asarray(A), jnp.asarray(b), damping=1e-3)
    x_t = TM.solve_psd(torch.as_tensor(A), torch.as_tensor(b), damping=1e-3)
    np.testing.assert_allclose(np.asarray(x_j), npy(x_t), rtol=1e-10)


def test_quat_identity():
    q = TM.quat_identity((2, 3), dtype=torch.float64)
    np.testing.assert_array_equal(npy(q), np.asarray(JM.quat_identity((2, 3))))


@pytest.mark.parametrize("name", ["quat_mul_np", "quat_conj_np", "quat_normalize_np",
                                  "quat_rotate_np"])
def test_numpy_twins_match_jax(name):
    """The numpy helpers of the system's host paths: the same numpy code on
    both sides, equal to the last bit."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q1, q2, v = rng.normal(size=(N, 4)), _unit_quats(rng), rng.normal(size=(N, 3))
    args = {"quat_mul_np": (q1, q2), "quat_conj_np": (q1,), "quat_normalize_np": (q1,),
            "quat_rotate_np": (q2, v)}[name]
    np.testing.assert_array_equal(getattr(TM, name)(*args), getattr(JM, name)(*args))
