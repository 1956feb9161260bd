#!/usr/bin/env python3
"""Replay loop-closure ICP attempts through the JAX reference on the CPU.

    python3 -m tools.replay_icp ATTEMPTS.npz [--scans 100 110 140]

``ATTEMPTS.npz`` is what ``chip_smoke.py --out DIR`` writes as
``DIR/icp_attempts.npz``: the source and target submaps of every closure
attempt of its system phase, built by the port, with the port's ICP result.
Each chosen attempt (all by default) runs through the JAX package's
``icp_point_to_plane`` from the same initial guess, with the same iteration
count and fitness form, in float32. Printed per attempt, one JSON line: the
port's and the reference's fitness, the reference's fitness trimmed to the
best ``--trim`` share at its final pose, and the gap between the two final
transforms. This imports JAX and nothing of the port.
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")

from lili_om_tpu.ops.icp import icp_point_to_plane  # noqa: E402
from lili_om_tpu.ops.knn import knn  # noqa: E402
from lili_om_tpu.utils.math import quat_rotate  # noqa: E402

MAX_CORR_M = 30.0  # icp_point_to_plane's default max_corr_dist


def trimmed_fitness(t, q, src, sm, tgt, tm, trim: float) -> float:
    """Mean squared 1-NN distance of the best ``trim`` share of the matched
    source points at the pose (t, q)."""
    pw = quat_rotate(q[None, :], src) + t[None, :]
    d2 = np.asarray(knn(pw, tgt, k=1, p_mask=tm)[0][:, 0])
    d2 = np.sort(d2[np.asarray(sm) & (d2 < MAX_CORR_M ** 2)])
    return float(d2[:max(int(len(d2) * trim), 1)].mean())


def quat_angle(qa, qb) -> float:
    """Angle (rad) of the rotation between unit quaternions (w, x, y, z),
    from conj(qa)·qb in float64 (atan2 keeps small angles exact)."""
    qa, qb = np.asarray(qa, np.float64), np.asarray(qb, np.float64)
    w = qa[0] * qb[0] + qa[1:] @ qb[1:]
    v = qa[0] * qb[1:] - qb[0] * qa[1:] - np.cross(qa[1:], qb[1:])
    return float(2.0 * np.arctan2(np.linalg.norm(v), abs(w)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("attempts")
    ap.add_argument("--scans", type=int, nargs="*", default=None)
    ap.add_argument("--trim", type=float, default=0.7)
    args = ap.parse_args(argv)
    a = np.load(args.attempts)
    n_iters, trim = int(a["n_iters"]), float(a["trim"])
    for i, scan in enumerate(a["scan"].tolist()):
        if args.scans is not None and scan not in args.scans:
            continue
        src, sm = jnp.asarray(a["src"][i]), jnp.asarray(a["src_mask"][i])
        tgt, tm = jnp.asarray(a["tgt"][i]), jnp.asarray(a["tgt_mask"][i])
        t0 = time.perf_counter()
        res = icp_point_to_plane(src, sm, tgt, tm, jnp.zeros(3, jnp.float32),
                                 jnp.array([1.0, 0.0, 0.0, 0.0], jnp.float32),
                                 n_iters=n_iters, trim=trim)
        t, q = np.asarray(res.t), np.asarray(res.q)
        print(json.dumps({
            "scan": scan, "n_src": int(a["src_mask"][i].sum()),
            "n_tgt": int(a["tgt_mask"][i].sum()),
            "port_fitness": float(a["fitness"][i]), "jax_fitness": float(res.fitness),
            f"jax_trimmed_{args.trim}": trimmed_fitness(res.t, res.q, src, sm, tgt, tm,
                                                        args.trim),
            "dt_m": float(np.linalg.norm(t - a["t"][i])),
            "dq_rad": quat_angle(q, a["q"][i]),
            "jax_t": t.tolist(), "port_t": a["t"][i].tolist(),
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
