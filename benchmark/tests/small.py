"""A cell cut to a size the CPU runs in seconds, for the harness's tests:
the configuration's structure with small sensors, capacities and
sessions (the benchmark itself never runs these sizes)."""
from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def small_cell(config: str, traffic: str):
    """(cfg, traffic) of ``config`` × ``traffic`` at the tests' size."""
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    tr = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    cfg, tr = copy.deepcopy(cfg), copy.deepcopy(tr)
    if cfg["sensor"]["kind"] == "livox":
        cfg["sensor"]["pts_per_line"] = 680
        cfg["livox_features"]["n_cols"] = 680
    else:
        cfg["sensor"].update(rings=16, cols=360)
    cfg["odometry"].update(scan_cap=2048, query_cap=512, map_cap=8192, frame_cap=1024,
                           n_recent_frames=6)
    cfg["fusion"].update(local_map_width=8, kf_surf_cap=1024, kf_edge_cap=256,
                         map_surf_cap=8192, map_edge_cap=2048, max_num_iter=4, imu_cap=64)
    cfg["spin_features"].update(surf_cap=2048)
    cfg["loop_closure"].update(submap_cap=1024, icp_iters=4, map_width=4)
    tr.update(scans_per_session=24, closure_every=4, warm_scans=6, trace_scans=[8, 12])
    if tr["time_thres_s"] is not None:
        tr["time_thres_s"] = 0.8
    tr["check"] = {"odometry_scans": 3, "keyframes": 2, "closures": tr["check"]["closures"] and 1,
                   "rebuilds": tr["check"]["rebuilds"] and 1}
    return cfg, tr
