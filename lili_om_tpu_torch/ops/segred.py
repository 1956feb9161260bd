"""Segment sum over sorted segment ids (port of
``lili_om_tpu/ops/segred_pallas.py``): the reduction behind every voxel
downsample and voxel-table merge (``ops/voxel.py``).

* :func:`segment_sum_sorted_plain` is the plain PyTorch version:
  ``index_add_`` into one extra row that takes the dropped rows. On the CPU
  it adds each segment's rows in row order.
* :func:`segment_sum_sorted_cuda` launches the hand-written CUDA kernel
  ``csrc/segred.cu``, the counterpart of ``segment_sum_sorted_pallas``: one
  thread per (segment, channel) finds its rows by binary search and adds
  them in row order, so the result is deterministic and equals the plain
  version on the CPU bit for bit (``index_add_`` on the card uses atomics
  and rounds in a run-dependent order).
* :func:`segment_sum_auto` is what ``ops/voxel.py`` calls: the kernel for a
  CUDA tensor, float32 and float64 alike, the plain version for a CPU one.
  The JAX dispatcher of the same name keeps XLA's scatter by default
  (``LILI_OM_PALLAS_SEGRED=0``) on a TPU v5e break-even measurement
  (segred_pallas.py:97-104); that measurement says nothing about this card,
  and here the kernel is the one path on CUDA, with no switch.

Contract (as the JAX kernel's): ``seg_id`` (N,) int64 non-decreasing,
``payload`` (N, C); rows with ``seg_id >= num_out`` are dropped; the result
is (num_out, C), a segment without rows reads 0. It holds at every caller
in ``ops/voxel.py``: ``voxel_downsample``, ``voxel_downsample_ordered``
(the run sums and the merge of the runs) and ``merge_voxel_entries`` each
take the ids as a ``cumsum`` of segment starts over rows sorted by key (the
runs: over the scan order itself), with the invalid rows sorted strictly
last, and clamp the rows past the capacity to the overflow id ``num_out``,
which the sum drops.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from ..device import use_kernel

# kernel launches since the last reset_launch_counts(), keyed by
# ("segred", rows N, channels C, num_out): one key per call-site shape
LAUNCHES: collections.Counter = collections.Counter()


def reset_launch_counts():
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


def _library(dtype):
    from ..cuda_build import load

    fn = getattr(load("segred"), "lili_segred_f32" if dtype == torch.float32
                 else "lili_segred_f64")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    return fn


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


def launch_kernel(payload, seg_id, num_out: int, out: torch.Tensor):
    """One launch on the current stream into ``out`` (num_out, C)."""
    err = _library(payload.dtype)(payload.data_ptr(), seg_id.data_ptr(), payload.shape[0],
                                  payload.shape[1], num_out, out.data_ptr(),
                                  torch.cuda.current_stream(payload.device).cuda_stream)
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
    LAUNCHES["segred", payload.shape[0], payload.shape[1], num_out] += 1
    return out


def segment_sum_auto(payload, seg_id, num_out: int) -> torch.Tensor:
    """Device-dispatching sorted segment sum (see the module docstring)."""
    if use_kernel(payload):
        return segment_sum_sorted_cuda(payload.contiguous(), seg_id.contiguous(), num_out)
    if payload.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no segment sum for device {payload.device}")
    return segment_sum_sorted_plain(payload, seg_id, num_out)
