"""The readings that the limits of ``correct`` are set from, for one cell on
several seeds in one process: for each seed the first session of a short
window with its planned calls captured, then the program's gaps from the
reference (the lower readings) and, with ``--control``, the control's: the
reference computed with TF32 matrix products put in the program's place
(the upper readings). One JSON line a seed. On the card:

    python3 benchmark/tests/calibrate.py --workload rot64.lap --seeds 11 12 13 --control

``--look`` keeps every keyframe of the session's first quarter instead of
the plan's draw and reads each one's fused poses three ways: the program
against the float32 reference, the program against the reference in
float64 (its inputs and the program's state before the call cast up), and
the float32 reference against the float64 one. A keyframe where the first
reads far above the others' and the third reads as much is one where
float32 rounding itself turns the LM loop, not the program.

``--look-odometry`` does the same for the odometry: every scan of the
session's first half, its poses (``odo_gap_m``'s leaves) read as the
program against the float32 reference (twice, since the reference's
segment sums add by atomics), the program against the float64 reference
and the float32 reference against the float64 one.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parent.parent)]

import torch  # noqa: E402

from lom_bench import capture as capture_mod  # noqa: E402
from lom_bench import check, cli, logs, program, window  # noqa: E402
from lom_bench.registry import Registry  # noqa: E402


def cast_tree(x, dtype):
    """Floating tensors of a nested NamedTuple cast to ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if hasattr(x, "_fields"):
        return type(x)(*[cast_tree(v, dtype) for v in x])
    return x


def _cells(workload: str, cell_override):
    reg = Registry()
    cell = reg.workload(workload)
    if cell_override is None:
        return reg.config(cell["config"]), reg.traffic(cell["traffic"])
    return cell_override


def _session(cfg, traffic, log, seed, device, window_s, look, look_odometry=False):
    plan = capture_mod.make_plan(seed, traffic, cfg["fusion"]["window"])
    if look:
        plan = plan._replace(keyframes=frozenset(range(traffic["scans_per_session"] // 4)))
    if look_odometry:
        plan = plan._replace(odometry_scans=frozenset(range(traffic["scans_per_session"] // 2)))
    cap = capture_mod.Capture(plan)
    with cap.install(program.system_module()):
        window.run_window(cfg, traffic, log, window_s, device, capture=cap)
    return cap


def calibrate(workload: str, seeds, control: bool, device="cuda", window_s: float = 2.0,
              cell_override=None):
    """Yields (seed, program gaps, control gaps or None): {number: [gap of
    each captured call]}."""
    cfg, traffic = _cells(workload, cell_override)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    if torch.device(device).type == "cuda":
        program.prepare_kernels()
    for i, seed in enumerate(seeds):
        log = logs.make_log(cfg, traffic, seed, device)
        if i == 0:
            cli.warm(cfg, traffic, log, device)
        cap = _session(cfg, traffic, log, seed, device, window_s, look=False)
        ref = check.Reference(cfg, traffic, log, device)
        prog = check.readings(cap, ref)
        ctl = check.readings(cap, ref, control=True) if control else None
        yield seed, prog, ctl


def look(workload: str, seeds, device="cuda", window_s: float = 2.0, cell_override=None):
    """Yields (seed, [per keyframe: ordinal, kind, program−ref32,
    program−ref64, ref32−ref64 position gaps of the fused window and ring
    (m)])."""
    cfg, traffic = _cells(workload, cell_override)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    if torch.device(device).type == "cuda":
        program.prepare_kernels()
    for i, seed in enumerate(seeds):
        log = logs.make_log(cfg, traffic, seed, device)
        if i == 0:
            cli.warm(cfg, traffic, log, device)
        cap = _session(cfg, traffic, log, seed, device, window_s, look=True)
        ref32 = check.Reference(cfg, traffic, log, device)
        ref64 = check.Reference(cfg, traffic, log, device, dtype=torch.float64)
        rows = []
        for j, rec in sorted(cap.keyframes.items()):
            new32, _ = ref32.fusion(j, rec)
            rec64 = dict(rec, state=cast_tree(rec["state"], torch.float64),
                         t_scan_src=cast_tree(rec["t_scan_src"], torch.float64))
            new64, _ = ref64.fusion(j, rec64)
            prog = rec["new_state"]

            def gap(a, b):
                ring = b.hist_valid.to(a.hist_t.device)
                return max(check.pos_gap(a.t, b.t),
                           check.pos_gap(a.hist_t[ring], b.hist_t[b.hist_valid]),
                           0.0 if torch.equal(a.hist_valid, ring) else math.inf)
            rows.append([j, rec["kind"], gap(prog, new32), gap(prog, new64), gap(new32, new64)])
        yield seed, rows


def look_odometry(workload: str, seeds, device="cuda", window_s: float = 2.0,
                  cell_override=None):
    """Yields (seed, [per scan of the first half: scan, program−ref32,
    program−ref32 again, program−ref64, ref32−ref64 pose gaps (m), and the
    first of them in rad])."""
    cfg, traffic = _cells(workload, cell_override)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = cfg["tf32"]
    if torch.device(device).type == "cuda":
        program.prepare_kernels()

    def gap_m(t, q, new, t2, q2, new2):
        return max(check.pos_gap(t, t2), *(check.pos_gap(getattr(new, f), getattr(new2, f))
                                           for f in ("t", "t_prev", "kf_t")))

    def gap_rad(t, q, new, t2, q2, new2):
        return max(check.rot_gap(q, q2), *(check.rot_gap(getattr(new, f), getattr(new2, f))
                                           for f in ("q", "q_prev", "kf_q")))
    for i, seed in enumerate(seeds):
        log = logs.make_log(cfg, traffic, seed, device)
        if i == 0:
            cli.warm(cfg, traffic, log, device)
        cap = _session(cfg, traffic, log, seed, device, window_s, look=False,
                       look_odometry=True)
        ref32 = check.Reference(cfg, traffic, log, device)
        ref64 = check.Reference(cfg, traffic, log, device, dtype=torch.float64)
        rows = []
        for k, rec in sorted(cap.odometry.items()):
            prog = (rec["t"], rec["q"], rec["new_state"])
            a = ref32.odometry(k, rec)
            b = ref32.odometry(k, rec)
            rec64 = dict(rec, state=cast_tree(rec["state"], torch.float64),
                         t_scan_src=cast_tree(rec["t_scan_src"], torch.float64))
            c = ref64.odometry(k, rec64)
            rows.append([k, gap_m(*prog, *a), gap_m(*prog, *b), gap_m(*prog, *c),
                         gap_m(*a, *c), gap_rad(*prog, *a)])
        yield seed, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--look", action="store_true")
    ap.add_argument("--look-odometry", action="store_true")
    args = ap.parse_args(argv)
    if args.look_odometry:
        for seed, rows in look_odometry(args.workload, args.seeds):
            print(json.dumps({"workload": args.workload, "seed": seed, "look_odometry": rows}),
                  flush=True)
        return 0
    if args.look:
        for seed, rows in look(args.workload, args.seeds):
            print(json.dumps({"workload": args.workload, "seed": seed, "look": rows}),
                  flush=True)
        return 0
    for seed, prog, ctl in calibrate(args.workload, args.seeds, args.control):
        print(json.dumps({"workload": args.workload, "seed": seed, "program": prog,
                          "control": ctl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
