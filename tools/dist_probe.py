#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives take CUDA tensors on this machine.

    python3 -m tools.dist_probe [--bytes 860160]

Two groups on ``cuda:0``: NCCL at world size 1 (NCCL refuses two ranks on
one device), and two gloo ranks started with ``torch.multiprocessing.spawn``.
Each rank builds a 1-D ``init_device_mesh("cuda", (n,))`` on the default
group and runs, on CUDA tensors, ``all_gather`` (float32, float64, int64),
``all_reduce`` (SUM), ``broadcast`` and ``broadcast_object_list``, checks
each result, and times an ``all_gather`` of ``--bytes`` float32 bytes per
rank (the map-sharded fusion's per-keyframe gather at ``fr_iosb_rot``) with
CUDA events. One JSON line per (backend, rank, collective): ``ok``, the
error text where it raised, and the time. Needs a GPU; imports nothing of
the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _cases(n: int, rank: int, dev, group):
    def gather(dtype):
        t = torch.arange(6, device=dev).to(dtype) + 10 * rank
        out = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(out, t, group=group)
        return all(torch.equal(o.cpu(), (torch.arange(6) + 10 * r).to(dtype))
                   for r, o in enumerate(out))

    def reduce():
        t = torch.full((4,), float(rank + 1), dtype=torch.float64, device=dev)
        dist.all_reduce(t, group=group)
        return bool(torch.all(t.cpu() == n * (n + 1) / 2))

    def bcast():
        t = torch.full((5,), float(rank), device=dev)
        dist.broadcast(t, src=0, group=group)
        return bool(torch.all(t.cpu() == 0.0))

    def bcast_obj():
        obj = [{"rank": rank, "a": torch.arange(3).numpy()}]
        dist.broadcast_object_list(obj, src=0, group=group, device=dev)
        return obj[0]["rank"] == 0

    return {"all_gather_f32": lambda: gather(torch.float32),
            "all_gather_f64": lambda: gather(torch.float64),
            "all_gather_i64": lambda: gather(torch.int64),
            "all_reduce_f64": reduce, "broadcast": bcast,
            "broadcast_object_list": bcast_obj}


def _rank(rank: int, n: int, backend: str, init: str, nbytes: int):
    from torch.distributed.device_mesh import init_device_mesh

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group(backend, init_method=init, world_size=n, rank=rank)
    try:
        mesh = init_device_mesh("cuda", (n,), mesh_dim_names=("q",))
        group = mesh.get_group()
        head = {"backend": backend, "world": n, "rank": rank,
                "mesh_backend": dist.get_backend(group)}
        for name, fn in _cases(n, rank, dev, group).items():
            try:
                row = {"ok": bool(fn())}
                torch.cuda.synchronize()
            except (RuntimeError, ValueError) as e:  # the probe reports what raised
                row = {"ok": False, "error": str(e).splitlines()[0][:300]}
            print(json.dumps({**head, "collective": name, **row}), flush=True)
        t = torch.zeros(nbytes // 4, device=dev)
        out = [torch.empty_like(t) for _ in range(n)]
        for _ in range(3):
            dist.all_gather(out, t, group=group)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        iters = 20
        a.record()
        for _ in range(iters):
            dist.all_gather(out, t, group=group)
        b.record()
        b.synchronize()
        print(json.dumps({**head, "collective": f"all_gather_{nbytes}B",
                          "ms": a.elapsed_time(b) / iters}), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bytes", type=int, default=860160)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dist_probe: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
                      "cuda": torch.version.cuda, "nccl": dist.is_nccl_available(),
                      "gloo": dist.is_gloo_available()}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        _rank(0, 1, "nccl", f"file://{tmp}/nccl", args.bytes)
        mp.spawn(_rank, args=(2, "gloo", f"file://{tmp}/gloo", args.bytes), nprocs=2,
                 join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
