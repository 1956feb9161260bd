#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lili_om_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile] [--out DIR]

Phases, each printing its own line; any failed check exits non-zero:

1. device: the card's name and power limit;
2. build: every CUDA kernel of the port, from ``lili_om_tpu_torch/csrc/``
   (one ``nvcc`` per source, all started together);
3. main path: ``Frame`` steps (spin features → scan-to-map odometry →
   sliding-window fusion) at the full ``fr_iosb_rot`` width on simulated
   64×1800 scans, with the kNN launch counts set to 0 just before and read
   just after; poses are held against the simulator's trajectory, then the
   same scans run again with the plain kNN forced and the two trajectories
   are held together;
4. large-map path: odometry with a 98304-point map (above the
   count-bounded kernel's 65536-row limit), which takes the dense launch;
5. kernels against their plain versions, on the inputs the two paths gave
   each call site, plus an unmasked 4096×98304 dense case: error, kernel
   time, the plain version's time, ``torch.cdist``+``topk`` as a yardstick,
   and the least time the card could take (the larger of bytes over
   3.35 TB/s and 8 f32 operations per needed (query, point) pair over
   67 TFLOP/s, H100 SXM data-sheet peaks);
6. with ``--profile``, a ``torch.profiler`` window over a few main-path
   frames (device busy share, kernels by device time).

Then one line with the ``kernels`` JSON, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``. It imports nothing of the
JAX package and needs no network.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from lili_om_tpu_torch import cuda_build
from lili_om_tpu_torch.frame import Frame, bench_configs, sim_scans
from lili_om_tpu_torch.ops import knn as K
from lili_om_tpu_torch.sim.trajectory import pose_at
from lili_om_tpu_torch.utils.math import pose_relative, quat_conj, quat_mul

PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
FLOP_PER_PAIR = 8  # 3 sub, 3 mul, 2 add for (q-p)^2
N_WARM = 3
N_TIMED = 12  # main-path scans timed after the N_WARM warm-up scans
LARGE_MAP = 98304
# the same scans through the kernel and through the plain kNN. The searches
# agree bit for bit, but the voxel sums (index_add_) use atomics on the card
# and so round in a run-dependent order; the solvers' stopping tests
# (odometry step norm 1e-5, fusion 1e-4) can turn that into one iteration
# more or less, a pose change of the order of those tolerances per scan
TRAJ_TOL_M, TRAJ_TOL_RAD = 5e-3, 5e-3
# odometry against the simulator's ground truth over a short run from rest
GT_TOL_M, GT_TOL_RAD = 0.25, 0.05
REPLACES = {"knn_counted": "lili_om_tpu/ops/knn_pallas.py:234",
            "knn_dense": "lili_om_tpu/ops/knn_pallas.py:64"}
SOURCE = "lili_om_tpu_torch/csrc/knn.cu"
DEV = "cuda"


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise CheckFailed(what)


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    sync()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def run_path(cfgs, scans, label: str):
    """Drive ``Frame`` over ``scans`` with the launch counts set to 0 just
    before and read just after. Returns (frame, poses, per-scan ms, counts)."""
    frame = Frame(cfgs, device=DEV)
    sync()
    K.reset_launch_counts()
    poses, host_ms, dev_ms = [], [], []
    for s in scans:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        oout, fout = frame.step(s)
        b.record()
        b.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
        dev_ms.append(a.elapsed_time(b))
        poses.append((oout.t.clone(), oout.q.clone(), fout.t_latest.clone(),
                      int(oout.n_corr), int(fout.n_surf_corr), int(fout.n_edge_corr)))
    counts = dict(K.LAUNCHES)
    timed = sorted(host_ms[N_WARM:])
    print(f"[{label}] {len(scans)} scans: per-scan host ms median "
          f"{timed[len(timed) // 2]:.3f} min {timed[0]:.3f} max {timed[-1]:.3f}; "
          f"event ms median {sorted(dev_ms[N_WARM:])[len(timed) // 2]:.3f}; "
          f"launches {sum(counts.values())} "
          f"{ {f'{w}:{q}x{p}': n for (w, q, p), n in sorted(counts.items())} }")
    return frame, poses, host_ms, counts


def gt_errors(poses, traj):
    """Max odometry error against the simulated trajectory, relative to scan 0."""
    t0, q0 = pose_at(traj, 0.0, device=DEV)
    et = er = 0.0
    for k, (t, q, *_rest) in enumerate(poses):
        tk, qk = pose_at(traj, k * 0.1, device=DEV)
        rt, rq = pose_relative(t0, q0, tk, qk)
        et = max(et, float(torch.linalg.norm(t.double() - rt)))
        dq = quat_mul(quat_conj(rq), q.double())
        er = max(er, float(2.0 * torch.linalg.norm(dq[1:])))
    return et, er


def traj_gap(pa, pb):
    gt = gr = 0.0
    for (ta, qa, fa, *_), (tb, qb, fb, *_) in zip(pa, pb):
        gt = max(gt, float(torch.linalg.norm(ta - tb)), float(torch.linalg.norm(fa - fb)))
        dq = quat_mul(quat_conj(qa), qb)
        gr = max(gr, float(2.0 * torch.linalg.norm(dq[1:])))
    return gt, gr


def capture_inputs(frame: Frame, scan):
    """One extra step with the count-bounded and dense wrappers recording
    their inputs: the tensors each call site of the path hands the kernel."""
    seen = {}

    def recorder(name, fn):
        def wrapped(queries, points, k=5, p_mask=None, q_mask=None):
            seen[(name, queries.shape[0], points.shape[0])] = tuple(
                None if x is None else x.clone() for x in (queries, points, p_mask, q_mask))
            return fn(queries, points, k, p_mask, q_mask)
        return wrapped

    orig = K.knn_counted_cuda, K.knn_dense_cuda
    K.knn_counted_cuda = recorder("knn_counted", orig[0])
    K.knn_dense_cuda = recorder("knn_dense", orig[1])
    try:
        frame.step(scan)
    finally:
        K.knn_counted_cuda, K.knn_dense_cuda = orig
    sync()
    return seen


def library_knn(queries, points, k, p_mask, q_mask):
    """``torch.cdist`` + ``topk``: the yardstick, used nowhere in the port."""
    d = torch.cdist(queries, points)
    if p_mask is not None:
        d = d.masked_fill(~p_mask[None, :], float("inf"))
    v, i = torch.topk(d, k, dim=1, largest=False)
    return v * v, i


def compare_kernel(name, site, inputs, launches, k=5):
    """Kernel against the plain version on the same inputs; timings; bound."""
    q, p, pm, qm = inputs
    counted = name == "knn_counted"
    wrapper = K.knn_counted_cuda if counted else K.knn_dense_cuda
    d_k, i_k = wrapper(q, p, k, pm, qm)
    d_p, i_p = K.knn(q, p, k=k, q_mask=qm, p_mask=pm)
    sync()
    # the kernel sums (q-p)^2 in the plain version's order without FMA and
    # breaks ties toward the lower index as the plain version does: its
    # distances and indices must equal the plain version's exactly
    fin = torch.isfinite(d_p)
    err = float((d_k[fin] - d_p[fin]).abs().max()) if bool(fin.any()) else 0.0
    check(bool(torch.equal(d_k, d_p)), f"{site}: distances differ from the plain "
          f"version (max {err:.3e})")
    check(bool(torch.equal(i_k, i_p)), f"{site}: indices differ from the plain version "
          f"at {int((i_k != i_p).sum())} slots")
    check(bool(torch.all(i_k[~fin] == 0)), f"{site}: empty slots must hold index 0")
    check(bool(torch.all(d_k[:, 1:] >= d_k[:, :-1])), f"{site}: distances not ascending")
    if pm is not None:
        check(bool(torch.all(pm[i_k[fin]])), f"{site}: a masked point matched")
    # each returned index reproduces its distance, summed in the same order
    diff = q[:, None, :] - p[i_k]
    g = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    g = g + diff[..., 2] * diff[..., 2]
    check(bool(torch.equal(g[fin], d_k[fin])), f"{site}: gathered distances differ")

    prep = K.kernel_inputs(q, p, k, pm, qm, counted=counted)
    ms = cuda_ms(lambda: wrapper(q, p, k, pm, qm), 50)
    kernel_ms = cuda_ms(lambda: K.launch_kernel(*prep, k), 50)
    plain_ms = cuda_ms(lambda: K.knn(q, p, k=k, q_mask=qm, p_mask=pm), 10)
    lib_ms = cuda_ms(lambda: library_knn(q, p, k, pm, qm), 10)

    Q, P = q.shape[0], p.shape[0]
    nq = Q if qm is None else int(qm.sum())
    np_ = P if pm is None else int(pm.sum())
    flops = FLOP_PER_PAIR * nq * np_
    nbytes = 12 * Q + 12 * P + (0 if qm is None else Q) + (0 if pm is None else P) \
        + Q * k * (4 + 8)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    bound_ms = 1e3 * max(t_ops, t_bytes)
    print(f"[kernel] {site}: valid q {nq}/{Q} p {np_}/{P}; max|Δd²| {err:.3e}; "
          f"wrapper {ms:.4f} ms kernel "
          f"{kernel_ms:.4f} ms plain {plain_ms:.4f} ms cdist+topk {lib_ms:.4f} ms "
          f"bound {bound_ms:.5f} ms")
    return {"name": f"{name}[{site}]", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches, "max_abs_err": err,
            "ms": ms, "kernel_only_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms, "shape": [Q, P], "valid": [nq, np_]}


def profile_frames(frame: Frame, scans, wall_ms: float):
    """Stage times (host clock, a sync after each stage), then a profiler
    window: device time and device operations per frame; the device busy
    share is taken against the unprofiled per-scan time ``wall_ms``."""
    from torch.profiler import ProfilerActivity, profile

    stages = {}
    for s in scans:
        sync()
        last = [time.perf_counter()]

        def mark(name):
            sync()
            now = time.perf_counter()
            stages.setdefault(name, []).append(1e3 * (now - last[0]))
            last[0] = now

        frame.step(s, on_stage=mark)
    print("[stages] median ms: " + ", ".join(
        f"{n} {sorted(v)[len(v) // 2]:.3f}" for n, v in stages.items()))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for s in scans:
            frame.step(s)
        sync()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / len(scans)
    n_ops = sum(e.count for e in kernels) / len(scans)
    print(f"[profile] per frame: device time {dev_ms:.3f} ms, {n_ops:.0f} device "
          f"operations; device busy {100.0 * dev_ms / wall_ms:.2f} % of the "
          f"unprofiled {wall_ms:.3f} ms per scan")
    print(events.table(sort_by="self_device_time_total", row_limit=25))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=None, help="directory for a JSON of the results")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; devices {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    logs = cuda_build.build(verbose=True)
    secs = time.perf_counter() - t0
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {src}: {line.strip()}")
    print(f"[build] {len(logs)} of {len(cuda_build.SOURCES)} sources compiled in {secs:.2f} s")

    # 3. main path
    cfgs = bench_configs()
    n = N_WARM + N_TIMED
    t0 = time.perf_counter()
    scans, traj = sim_scans(n + 1, device=DEV)
    sync()
    print(f"[sim] {n + 1} scans of {scans[0].img.shape[0]}x{scans[0].img.shape[1]} "
          f"in {time.perf_counter() - t0:.2f} s")
    frame, poses, host_ms, counts = run_path(cfgs, scans[:n], "main path")
    main_counts = counts
    check(K.launch_count("knn_counted") >= 3 * n,
          f"main path: {K.launch_count('knn_counted')} kNN launches for {n} scans")
    for (w, q, p), c in counts.items():
        check(c >= n, f"main path: call site {w}:{q}x{p} launched {c} times for {n} scans")
    for t, q, ft, *_ in poses:
        check(bool(torch.isfinite(t).all() and torch.isfinite(q).all()
                   and torch.isfinite(ft).all()), "main path: a pose is not finite")
    et, er = gt_errors(poses, traj)
    print(f"[main path] odometry vs simulated trajectory: max {et:.4f} m, {er:.5f} rad; "
          f"last scan corr odo/surf/edge {poses[-1][3:]}")
    check(et < GT_TOL_M and er < GT_TOL_RAD,
          f"odometry error {et:.4f} m / {er:.5f} rad against the simulated trajectory")
    with K.plain_knn():
        _, poses_plain, host_plain, counts_plain = run_path(cfgs, scans[:n], "plain kNN")
    check(not counts_plain, "the plain run launched the kernel")
    gt_, gr_ = traj_gap(poses, poses_plain)
    print(f"[main path] kernel vs plain kNN trajectories: max {gt_:.3e} m, {gr_:.3e} rad")
    check(gt_ < TRAJ_TOL_M and gr_ < TRAJ_TOL_RAD,
          f"kernel and plain trajectories differ by {gt_:.3e} m / {gr_:.3e} rad")
    main_inputs = capture_inputs(frame, scans[n])

    # 4. large-map path: the dense launch
    big = cfgs._replace(odometry=cfgs.odometry._replace(map_cap=LARGE_MAP))
    big_frame, _, _, big_counts = run_path(big, scans[:N_WARM + 2], "large-map path")
    check(K.launch_count("knn_dense") >= N_WARM + 2,
          f"large-map path: {K.launch_count('knn_dense')} dense launches")
    big_inputs = {key: v for key, v in capture_inputs(big_frame, scans[N_WARM + 2]).items()
                  if key[0] == "knn_dense"}

    # 5. kernels against their plain versions
    sites = {"knn_counted": {4096: "odometry", 6144: "fusion_surf", 3072: "fusion_edge"},
             "knn_dense": {4096: "odometry_large_map"}}
    kernels = []
    for key, inputs in list(main_inputs.items()) + list(big_inputs.items()):
        w, q, p = key
        site = f"{sites[w].get(q, 'site')}_{q}x{p}"
        launches = (main_counts if w == "knn_counted" else big_counts).get(key, 0)
        kernels.append(compare_kernel(w, site, inputs, launches))
    check({k["name"].split("[")[0] for k in kernels} == {"knn_counted", "knn_dense"},
          "a kernel had no call site to compare")
    # unmasked dense case: no masks, P above the count-bounded limit
    gen = torch.Generator(device=DEV).manual_seed(0)
    box = torch.tensor([60.0, 60.0, 8.0], device=DEV)
    pts = torch.rand((LARGE_MAP, 3), generator=gen, device=DEV) * box - box / 2
    qs = pts[torch.randint(0, LARGE_MAP, (4096,), generator=gen, device=DEV)] \
        + 0.2 * torch.randn((4096, 3), generator=gen, device=DEV)
    unmasked = compare_kernel("knn_dense", f"unmasked_4096x{LARGE_MAP}",
                              (qs.contiguous(), pts, None, None), 0)

    # 6. profile
    if args.profile:
        timed = sorted(host_ms[N_WARM:])
        profile_frames(frame, scans[N_WARM:N_WARM + 5], timed[len(timed) // 2])

    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump({"device": name, "nvidia_smi": smi, "per_scan_host_ms": host_ms,
                       "per_scan_host_ms_plain_knn": host_plain,
                       "kernels": kernels + [unmasked]}, f, indent=1)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
