"""Segment sum over sorted segment ids (port of
``lili_om_tpu/ops/segred_pallas.py``): the reduction behind every voxel
downsample and voxel-table merge (``ops/voxel.py``).

* :func:`segment_sum_sorted_plain` is the plain PyTorch version:
  ``index_add_`` into one extra row that takes the dropped rows. On the CPU
  it adds each segment's rows in row order.
* :func:`segment_sum_sorted_cuda` launches the hand-written CUDA kernel
  ``csrc/segred.cu``, the counterpart of ``segment_sum_sorted_pallas``: each
  block owns 256 / C consecutive segments, two warps find its rows with a
  32-way search, a pass over the rows writes each segment's start and end,
  and one thread per (segment, channel) adds its rows, staged in shared
  memory, in row order, so the result is
  deterministic and equals the plain version on the CPU bit for bit
  (``index_add_`` on the card uses atomics and rounds in a run-dependent
  order). :func:`segment_sum_sorted_schedule` mirrors that schedule in
  torch for the CPU tests.
* :func:`segment_sum_auto` is what ``ops/voxel.py`` calls: the kernel for a
  CUDA tensor, float32 and float64 alike, the plain version for a CPU one.
  The JAX dispatcher of the same name keeps XLA's scatter by default
  (``LILI_OM_PALLAS_SEGRED=0``) on a TPU v5e break-even measurement
  (segred_pallas.py:97-104); that measurement says nothing about this card,
  and here the kernel is the one path on CUDA, with no switch.

Contract (as the JAX kernel's): ``seg_id`` (N,) int64 non-decreasing and
non-negative, ``payload`` (N, C); rows with ``seg_id >= num_out`` are
dropped; the result is (num_out, C), a segment without rows reads 0. It
holds at every caller in ``ops/voxel.py``: ``voxel_downsample``,
``voxel_downsample_ordered`` (the run sums and the merge of the runs) and
``merge_voxel_entries`` each take the ids as a ``cumsum`` of segment starts
over rows sorted by key (the runs: over the scan order itself), with the
invalid rows sorted strictly last, and clamp the rows past the capacity to
the overflow id ``num_out``, which the sum drops.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import threading

import torch

from .. import cuda_build
from ..device import use_kernel

# kernel launches since the last reset_launch_counts(), keyed by
# ("segred", rows N, channels C, num_out): one key per call-site shape
LAUNCHES: collections.Counter = collections.Counter()
_LAUNCHES_LOCK = threading.Lock()


def count_launch(*key):
    """One launch at ``key``; the runtime launches from several threads."""
    with _LAUNCHES_LOCK:
        LAUNCHES[key] += 1


def reset_launch_counts():
    with _LAUNCHES_LOCK:
        LAUNCHES.clear()


def launch_count() -> int:
    return sum(LAUNCHES.values())


def segment_sum_sorted_plain(payload: torch.Tensor, seg_id: torch.Tensor,
                             num_out: int) -> torch.Tensor:
    """The plain version: rows with an id ≥ ``num_out`` land in one extra
    row, which is cut off."""
    out = torch.zeros((num_out + 1,) + payload.shape[1:], dtype=payload.dtype,
                      device=payload.device)
    return out.index_add_(0, torch.clamp(seg_id, max=num_out), payload)[:num_out]


# threads per block of csrc/segred.cu (kThreads): a block owns
# BLOCK_THREADS // C segments and passes over its rows in chunks of
# BLOCK_THREADS; the schedule's plain mirror walks the same blocks and chunks
BLOCK_THREADS = 256


@functools.cache
def _library(dtype):
    """The kernel's ctypes function for ``dtype``, bound once."""
    lib = cuda_build.load("segred")
    if lib.lili_segred_block_threads() != BLOCK_THREADS:
        raise RuntimeError("csrc/segred.cu threads per block differ from ops/segred.py")
    fn = getattr(lib, "lili_segred_f32" if dtype == torch.float32 else "lili_segred_f64")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _warp_lower_bound(ids: list, s: int, width: int = 32) -> int:
    """First row whose id is ≥ ``s``, found as the kernel's warp finds it:
    each round probes the last row of ``width`` equal runs of the range and
    keeps the first run whose probe is ≥ s."""
    lo, hi = 0, len(ids)
    while lo < hi:
        step = -(-(hi - lo) // width)
        hits = [ids[min(lo + (i + 1) * step - 1, hi - 1)] >= s for i in range(width)]
        if not any(hits):
            return hi
        f = hits.index(True)
        if step == 1:
            return lo + f
        lo, hi = lo + f * step, min(lo + (f + 1) * step - 1, hi - 1)
    return lo


def segment_sum_sorted_schedule(payload: torch.Tensor, seg_id: torch.Tensor, num_out: int,
                                threads: int = BLOCK_THREADS) -> torch.Tensor:
    """The kernel's schedule in torch (CPU tests): per block of
    ``threads // C`` segments, its rows by the warp search, each segment's
    start and end from neighbour comparisons in chunks of ``threads``
    rows, then each segment's rows added in row order from 0 (the kernel
    stages them in shared memory first, which leaves the order as it is)."""
    segs_per_block, chunk = threads // payload.shape[1], threads
    ids = seg_id.tolist()
    out = torch.zeros((num_out,) + payload.shape[1:], dtype=payload.dtype)
    for s0 in range(0, num_out, segs_per_block):
        s1 = min(s0 + segs_per_block, num_out)
        lo, hi = _warp_lower_bound(ids, s0), _warp_lower_bound(ids, s1)
        start = torch.zeros(s1 - s0, dtype=torch.int64)
        end = torch.zeros(s1 - s0, dtype=torch.int64)
        for c0 in range(lo, hi, chunk):
            r = torch.arange(c0, min(c0 + chunk, hi))
            sid = seg_id[r]
            first = (r == lo) | (sid != seg_id[torch.clamp(r - 1, min=0)])
            last = (r == hi - 1) | (sid != seg_id[torch.clamp(r + 1, max=hi - 1)])
            start[sid[first] - s0] = r[first]
            end[sid[last] - s0] = r[last] + 1
        n_rows = end - start
        acc = out[s0:s1]
        for off in range(int(n_rows.max())):
            take = off < n_rows
            acc = torch.where(take[:, None], acc + payload[torch.where(take, start + off, 0)],
                              acc)
        out[s0:s1] = acc
    return out


def _check(payload, seg_id, num_out):
    if payload.device.type != "cuda" or seg_id.device != payload.device:
        raise ValueError("the CUDA segment sum needs payload and ids on one CUDA device")
    if payload.dtype not in (torch.float32, torch.float64):
        raise TypeError("the CUDA segment sum takes float32 or float64 payloads")
    if seg_id.dtype != torch.int64:
        raise TypeError("the CUDA segment sum takes int64 segment ids")
    if payload.dim() != 2 or seg_id.shape != (payload.shape[0],):
        raise ValueError("payload must be (N, C) and seg_id (N,)")
    if not payload.is_contiguous() or not seg_id.is_contiguous():
        raise ValueError("payload and seg_id must be contiguous")
    if num_out < 0:
        raise ValueError("num_out must be ≥ 0")
    if not 1 <= payload.shape[1] <= BLOCK_THREADS:
        raise ValueError(f"the CUDA segment sum takes 1 to {BLOCK_THREADS} channels")


def launch_kernel(payload, seg_id, num_out: int, out: torch.Tensor):
    """One launch on the current stream into ``out`` (num_out, C)."""
    err = _library(payload.dtype)(payload.data_ptr(), seg_id.data_ptr(), payload.shape[0],
                                  payload.shape[1], num_out, out.data_ptr(),
                                  cuda_build.stream_ptr(payload.device))
    if err != 0:
        raise RuntimeError(f"segred kernel launch failed: CUDA error {err}")
    return out


def segment_sum_sorted_cuda(payload, seg_id, num_out: int) -> torch.Tensor:
    """The CUDA kernel (replaces ``segment_sum_sorted_pallas``); same
    contract and, on the same inputs, the same bits as the plain version on
    the CPU."""
    _check(payload, seg_id, num_out)
    out = torch.empty((num_out, payload.shape[1]), dtype=payload.dtype,
                      device=payload.device)
    launch_kernel(payload, seg_id, num_out, out)
    count_launch("segred", payload.shape[0], payload.shape[1], num_out)
    return out


def segment_sum_auto(payload, seg_id, num_out: int) -> torch.Tensor:
    """Device-dispatching sorted segment sum (see the module docstring)."""
    if use_kernel(payload):
        return segment_sum_sorted_cuda(payload.contiguous(), seg_id.contiguous(), num_out)
    if payload.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no segment sum for device {payload.device}")
    return segment_sum_sorted_plain(payload, seg_id, num_out)
