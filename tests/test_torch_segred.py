"""ops/segred: the sorted segment sum against ``jax.ops.segment_sum`` and the
Pallas kernel run in interpret mode, on the three cases of
tests/test_segred.py; and the row-order contract the CUDA kernel keeps.

The plain version adds each segment's rows in row order, as the CUDA kernel
does, so it is held bit for bit against a sequential float32 sum. XLA and
the Pallas kernel (a one-hot matmul) add in other orders: against them the
float32 sums agree to 1e-5, the tolerance of tests/test_segred.py.

The kernel's block schedule (64 segments a block, the rows found by a
32-way warp search, segment starts and ends from neighbour comparisons in
chunks of 256 rows) is mirrored in torch and held bit for bit against the
plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lili_om_tpu.ops.segred_pallas import segment_sum_sorted_pallas
from lili_om_tpu_torch.ops import segred as TS
from test_torch_common import npy


def _case(name):
    """(payload f32, ids, num_out) of tests/test_segred.py's three cases."""
    if name == "random":
        rng = np.random.default_rng(0)
        N, C, M = 5000, 7, 1200
        sid = np.minimum(np.cumsum(rng.random(N) < 0.3), M)
        pay = rng.normal(size=(N, C)).astype(np.float32)
    elif name == "overflow_dropped":
        N, C, M = 2000, 3, 700
        sid = np.full(N, M)
        sid[:100] = 0
        pay = np.ones((N, C), np.float32)
    else:  # every row its own segment
        N, C, M = 1500, 4, 1600
        sid = np.arange(N)
        pay = np.arange(N * C, dtype=np.float32).reshape(N, C)
    return pay, sid.astype(np.int64), M


def _sequential(pay, sid, M):
    """Each segment's rows added in row order, starting from 0, in f32."""
    out = np.zeros((M, pay.shape[1]), pay.dtype)
    for r in range(len(sid)):
        if sid[r] < M:
            out[sid[r]] = out[sid[r]] + pay[r]
    return out


@pytest.mark.parametrize("case", ["random", "overflow_dropped", "every_row_own_segment"])
def test_plain_matches_jax_and_pallas(case):
    pay, sid, M = _case(case)
    out = npy(TS.segment_sum_auto(torch.as_tensor(pay), torch.as_tensor(sid), M))
    assert out.shape == (M, pay.shape[1]) and out.dtype == np.float32
    np.testing.assert_array_equal(out, _sequential(pay, sid, M))
    ref = jax.ops.segment_sum(jnp.asarray(pay), jnp.asarray(sid, jnp.int32), num_segments=M,
                              indices_are_sorted=True)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)
    pal = segment_sum_sorted_pallas(jnp.asarray(pay), jnp.asarray(sid, jnp.int32), M,
                                    block=512, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pal), atol=1e-5)


def test_float64_and_empty_segments():
    """float64 payloads keep their type; segments past the last row read 0."""
    rng = np.random.default_rng(1)
    sid = np.sort(rng.integers(0, 50, 400))
    pay = rng.normal(size=(400, 5))
    out = npy(TS.segment_sum_auto(torch.as_tensor(pay), torch.as_tensor(sid), 80))
    ref = jax.ops.segment_sum(jnp.asarray(pay), jnp.asarray(sid), num_segments=80,
                              indices_are_sorted=True)
    assert out.dtype == np.float64
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-12, atol=1e-12)
    assert not out[50:].any()


def _schedule_case(name):
    """(payload f32, ids, num_out) that stress the kernel's block schedule."""
    rng = np.random.default_rng(4)
    if name == "long_segments":  # 700 and 1000 rows: longer than a chunk
        sid = np.concatenate([np.zeros(3), np.full(700, 1), np.arange(2, 40),
                              np.full(1000, 40), np.arange(41, 100)])
        M = 100
    elif name == "across_blocks":  # one long run starting at each block's last segment
        sid = np.concatenate([np.arange(63), np.full(300, 63), np.full(5, 64),
                              np.arange(65, 127), np.full(260, 127), np.full(9, 128)])
        M = 200
    elif name == "empty_ranges":  # whole blocks without a row, and a gap at the start
        sid = np.concatenate([np.full(10, 70), np.arange(300, 340), np.full(3, 511)])
        M = 600
    elif name == "overflow":  # rows past num_out, some of them in the last block
        sid = np.concatenate([np.sort(rng.integers(0, 130, 900)), np.full(400, 130),
                              np.full(50, 999)])
        M = 130
    else:  # random runs
        sid = np.cumsum(rng.random(6000) < 0.2)
        M = int(sid[-1]) + 1
    sid = sid.astype(np.int64)
    return rng.normal(size=(len(sid), 5)).astype(np.float32), sid, M


@pytest.mark.parametrize("case", ["random", "long_segments", "across_blocks",
                                  "empty_ranges", "overflow"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_schedule_equals_plain(case, dtype):
    """The kernel's schedule mirrored in torch: equal to the plain version
    bit for bit (one thread per (segment, channel) adds its rows in row
    order from 0, as index_add_ on the CPU does)."""
    pay, sid, M = _schedule_case(case)
    p, s = torch.as_tensor(pay, dtype=dtype), torch.as_tensor(sid)
    out = TS.segment_sum_sorted_schedule(p, s, M)
    assert out.dtype == dtype
    assert torch.equal(out, TS.segment_sum_sorted_plain(p, s, M))


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1025, 40000])
def test_warp_lower_bound(n):
    """The 32-way search finds the first row ≥ s for every s, ids with long
    runs and gaps included."""
    rng = np.random.default_rng(n)
    ids = np.sort(rng.integers(0, max(n // 3, 1) * 2, n)).tolist()
    for s in sorted(set(rng.integers(-1, max(n // 3, 1) * 2 + 2, 60).tolist()) | {0}):
        assert TS._warp_lower_bound(ids, s) == int(np.searchsorted(ids, s, side="left"))


def test_schedule_edge_sizes():
    """No rows, no segments."""
    e = torch.zeros((0, 3))
    ids = torch.zeros((0,), dtype=torch.int64)
    assert torch.equal(TS.segment_sum_sorted_schedule(e, ids, 5), torch.zeros((5, 3)))
    p = torch.ones((4, 3))
    assert TS.segment_sum_sorted_schedule(p, torch.arange(4), 0).shape == (0, 3)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor raises."""
    with pytest.raises(ValueError):
        TS.segment_sum_sorted_cuda(torch.zeros((4, 2)), torch.zeros(4, dtype=torch.int64), 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode "
                    "(chip_smoke.py holds it against the plain version on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernel_matches_plain(cuda, dtype):
    """On the card: the kernel equals the plain version on a CPU copy bit
    for bit, and two launches give the same bits."""
    pay, sid, M = _case("random")
    p = torch.as_tensor(pay, dtype=dtype)
    s = torch.as_tensor(sid)
    a = TS.segment_sum_sorted_cuda(p.to(cuda), s.to(cuda), M)
    b = TS.segment_sum_sorted_cuda(p.to(cuda), s.to(cuda), M)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), TS.segment_sum_sorted_plain(p, s, M))
    for case in ("long_segments", "across_blocks", "empty_ranges", "overflow"):
        pay, sid, M = _schedule_case(case)
        p, s = torch.as_tensor(pay, dtype=dtype), torch.as_tensor(sid)
        a = TS.segment_sum_sorted_cuda(p.to(cuda), s.to(cuda), M)
        torch.cuda.synchronize()
        assert torch.equal(a.cpu(), TS.segment_sum_sorted_plain(p, s, M)), case
