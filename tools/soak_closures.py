#!/usr/bin/env python3
"""Log every loop closure of the soak (``apps/soak_long_run.py``), to set
two trees' closures side by side.

    python3 tools/soak_closures.py [n_keyframes] --root TREE --tag NAME --out DIR [--speed-up S]
    python3 tools/soak_closures.py --compare DIR/closures_A.jsonl DIR/closures_B.jsonl

The first form imports ``lili_om_tpu_torch`` from ``TREE`` (a checkout of
any commit that has the soak app) and runs ``soak_long_run.run(n,
spill=True)`` on the card with three functions of that tree wrapped:

* ``LiliOmSystem._record_loop``: the closure's pair (mature, candidate)
  and whether it made a new loop factor or replaced slot k (merge width);
* ``models/pose_graph.py:block_tridiag_factor``: the smallest pivot of
  each factor (the diagonal of its Cholesky factors over the nodes) and
  whether a pivot is not positive (≤ 1e-12) or an entry not finite;
* ``models/pose_graph.py:_clamp_step``: each GN step, whether it had a
  non-finite entry (zeroed), its largest node translation after the clamp
  and the nodes held at the trust region (1 m or 0.3 rad).

One JSON line a closure to ``DIR/closures_NAME.jsonl`` (rewritten every
two laps), then a summary with the soak's verdict and quartiles.
The second form compares two such logs: the first closure whose pair
differs, and the counts of each. The wrappers sync once a factor and once
a step, so the solve times of such a run are not the soak's. Needs a GPU
for the first form; imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def summary(rows: list[dict]) -> dict:
    new = [r for r in rows if r["slot"] == "new"]
    return {"closures": len(rows), "loop_factors": len(new),
            "new_factor_at_keyframes": [r["kf"] for r in new],
            "gn_steps": sum(r["iters"] for r in rows),
            "solves_with_bad_pivot": sum(1 for r in rows if r["bad_factors"]),
            "bad_factors": sum(r["bad_factors"] for r in rows),
            "nonfinite_steps": sum(r["nonfinite_steps"] for r in rows),
            "steps_at_trust_region": sum(1 for r in rows for c in r["clamped_nodes"] if c),
            "smallest_pivot": min((r["min_pivot"] for r in rows), default=None)}


def record(args) -> int:
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from lili_om_tpu_torch.apps import soak_long_run
    from lili_om_tpu_torch.models import pose_graph as PG
    from lili_om_tpu_torch.models import system as SYS

    if not torch.cuda.is_available():
        print("soak_closures: needs a CUDA device", file=sys.stderr)
        return 2
    rows = []
    record_loop = SYS.LiliOmSystem._record_loop

    def _record_loop(self, i, j, *rest):
        slot = self._find_mergeable_loop(i, j)
        rows.append({"kf": len(self.kf_stamps), "pair": [int(i), int(j)],
                     "slot": "new" if slot is None else slot, "iters": 0, "bad_factors": 0,
                     "min_pivot": float("inf"), "nonfinite_steps": 0, "max_step_m": [],
                     "clamped_nodes": []})
        return record_loop(self, i, j, *rest)

    factor = PG.block_tridiag_factor

    def block_tridiag_factor(D, B):
        out = factor(D, B)
        piv = torch.diagonal(out[0], dim1=-2, dim2=-1)
        bad = bool((piv <= 1e-12).any()) or not bool(torch.isfinite(out[0]).all())
        fin = piv[torch.isfinite(piv)]
        row = rows[-1]
        row["bad_factors"] += int(bad)
        if fin.numel():
            row["min_pivot"] = min(row["min_pivot"], float(fin.min()))
        return out

    clamp = PG._clamp_step

    def _clamp_step(d, *a, **k):
        out = clamp(d, *a, **k)
        row = rows[-1]
        row["iters"] += 1
        row["nonfinite_steps"] += int(not bool(torch.isfinite(d).all()))
        tn = torch.linalg.norm(out[:, :3], dim=-1)
        rn = torch.linalg.norm(out[:, 3:], dim=-1)
        row["max_step_m"].append(float(tn.max()))
        row["clamped_nodes"].append(int(((tn > 1.0 - 1e-6) | (rn > 0.3 - 1e-6)).sum()))
        return out

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"closures_{args.tag}.jsonl")

    def dump(line):
        print(line, flush=True)
        with open(path, "w") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")

    SYS.LiliOmSystem._record_loop = _record_loop
    PG.block_tridiag_factor = block_tridiag_factor
    PG._clamp_step = _clamp_step
    r = soak_long_run.run(args.n_keyframes, spill=True, speed_up=args.speed_up, log=dump)
    for row, secs in zip(rows, r["solve_t"]):
        row["solve_ms"] = 1e3 * secs
    dump("done")
    sys_ = r["system"]
    print(json.dumps({"tag": args.tag, "keyframes": len(sys_.kf_stamps),
                      "graph_n_loops": int(sys_.graph.n_loops),
                      "verdict": "PASS" if soak_long_run.verdict(r, True) else "FAIL",
                      "kf_p50_quartiles_ms": [1e3 * x for x in
                                              soak_long_run.quartiles(r["kf_lat"])],
                      "solve_p50_quartiles_ms": [1e3 * x for x in
                                                 soak_long_run.quartiles(r["solve_t"])],
                      **summary(rows)}))
    return 0


def compare(a_path: str, b_path: str) -> int:
    logs = []
    for p in (a_path, b_path):
        with open(p) as fh:
            logs.append([json.loads(x) for x in fh if x.strip()])
    a, b = logs
    first = next((k for k, (x, y) in enumerate(zip(a, b))
                  if (x["pair"], x["slot"]) != (y["pair"], y["slot"])), None)
    out = {"first_difference": first, a_path: summary(a), b_path: summary(b)}
    if first is not None:
        out["at_first_difference"] = {a_path: a[first], b_path: b[first]}
        out["before_it"] = {a_path: a[max(first - 1, 0)], b_path: b[max(first - 1, 0)]}
    print(json.dumps(out, indent=1))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_keyframes", nargs="?", type=int, default=2000)
    ap.add_argument("--root", default=".", help="the checkout whose package runs")
    ap.add_argument("--tag", default="run")
    ap.add_argument("--out", default="chiprun_out/soak_closures")
    ap.add_argument("--speed-up", type=float, default=8.0,
                    help="the circle's speed-up time constant (the example's 8 s)")
    ap.add_argument("--compare", nargs=2, metavar="JSONL")
    args = ap.parse_args(argv)
    return compare(*args.compare) if args.compare else record(args)


if __name__ == "__main__":
    sys.exit(main())
