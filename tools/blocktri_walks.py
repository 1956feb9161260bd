#!/usr/bin/env python3
"""Time the pose graph's block-Thomas kernels (``csrc/blocktri.cu``) per
chain step on inputs of three kinds, to show what sets a walk's step.

    python3 tools/blocktri_walks.py [--root TREE] [--lengths 2048 4096] [--cols 1 192 384]

* ``dense``: every node's blocks dense and well conditioned (D = 4·I plus
  symmetric noise, B and the right-hand sides normal), no zero anywhere;
* ``padded``: the same over the first half of the chain; the second half
  like a graph's padding past its last keyframe, the nodes of a
  power-of-two capacity that no keyframe fills: D a multiple of I (1e6·I
  here; ``_anchor_freeze`` puts 1e12 on a frozen node), B = 0 and zero
  right-hand rows, so that every off-diagonal entry and every dividend of
  those steps is zero;
* ``sparse``: ``dense``'s factor; right-hand columns zero but for two
  nodes each in the second half, as U's columns of the loop factors.

Each kernel is timed by CUDA events (median of 7 calls after one), and
its outputs are held against the plain versions (``ops/blocktri.py``) at
a 256-node chain of each kind: the factor bit for bit, the resolve within
1e-4 of its largest entry (float32). One JSON line per (kind, kernel, N,
R) with the milliseconds and the microseconds a chain step, then the
card's name and power limit. The package, and so the kernels' sources,
come from the checkout ``TREE`` (default: this one), so that two commits'
kernels can be timed in one session. Needs a GPU; imports nothing of the
JAX package.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

BT = None  # ops/blocktri.py of the checkout given by --root


def inputs(kind: str, N: int, R: int, seed: int = 0):
    """(D, B, rhs) on the card, float32, of one ``kind`` (see the module
    docstring)."""
    rng = np.random.default_rng(seed)
    D = 4.0 * np.eye(6)[None] + 0.05 * rng.normal(size=(N, 6, 6))
    D = 0.5 * (D + D.transpose(0, 2, 1))
    B = 0.1 * rng.normal(size=(N, 6, 6))
    rhs = rng.normal(size=(N, 6, R))
    if kind == "padded":
        D[N // 2:] = 1e6 * np.eye(6)
        B[N // 2 - 1:] = 0.0
        rhs[N // 2:] = 0.0
    elif kind == "sparse":
        rhs[:] = 0.0
        cols = np.arange(R)
        rhs[N // 2 + cols % (N // 4), :, cols] = 1.0
        rhs[N - 1 - cols % (N // 4), :, cols] = -1.0
    return tuple(torch.as_tensor(a, dtype=torch.float32).cuda().contiguous()
                 for a in (D, B, rhs))


def cuda_ms(fn, reps: int = 7) -> float:
    """Median milliseconds of ``fn`` by CUDA events, after one call."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def check(kind: str) -> dict:
    """The kernels against the plain versions on a 256-node chain."""
    D, B, rhs = inputs(kind, 256, 8, seed=1)
    fk = BT.block_tridiag_factor_cuda(D, B)
    fp = BT.block_tridiag_factor_plain(D, B)
    xk = BT.block_tridiag_resolve_cuda(fk, rhs)
    xp = BT.block_tridiag_resolve_plain(fk, rhs)
    factor_equal = all(bool(torch.equal(a, b)) for a, b in zip(fk, fp))
    gap = float((xk - xp).abs().max() / xp.abs().max())
    return {"kind": kind, "factor_bit_equal": factor_equal, "resolve_rel_gap": gap,
            "ok": factor_equal and gap <= 1e-4}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lengths", type=int, nargs="+", default=[2048, 4096])
    ap.add_argument("--cols", type=int, nargs="+", default=[1, 192, 384])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(__file__), os.pardir),
                    help="the checkout whose package and kernel sources run")
    args = ap.parse_args(argv)
    global BT
    sys.path.insert(0, os.path.abspath(args.root))
    BT = importlib.import_module("lili_om_tpu_torch.ops.blocktri")
    print(f"blocktri_walks: {os.path.abspath(BT.__file__)}")
    if not torch.cuda.is_available():
        print("blocktri_walks: needs a CUDA device", file=sys.stderr)
        return 2
    ok = True
    for kind in ("dense", "padded", "sparse"):
        c = check(kind)
        ok &= c["ok"]
        print(json.dumps(c), flush=True)
    for N in args.lengths:
        for kind in ("dense", "padded", "sparse"):
            for R in args.cols:
                D, B, rhs = inputs(kind, N, R)
                f = BT.block_tridiag_factor_cuda(D, B)
                if R == args.cols[0]:
                    ms = cuda_ms(lambda: BT.block_tridiag_factor_cuda(D, B))
                    print(json.dumps({"kind": kind, "kernel": "factor", "N": N, "R": 6,
                                      "ms": ms, "us_per_step": 1e3 * ms / N}), flush=True)
                ms = cuda_ms(lambda: BT.block_tridiag_resolve_cuda(f, rhs))
                print(json.dumps({"kind": kind, "kernel": "resolve", "N": N, "R": R, "ms": ms,
                                  "us_per_step": 1e3 * ms / N}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0] if smi.strip() else "nvidia-smi: no output")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
