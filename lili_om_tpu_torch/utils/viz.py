"""Run-overview visualization (port of ``lili_om_tpu/utils/viz.py``): the
headless stand-in for the reference's rviz session (every launch file starts
rviz with trajectory + map displays, LiLi-OM/launch/run_fr_iosb.launch:1-21).

* :func:`save_overview_png` — a top-down (x, y) figure of the global map
  with the estimated / graph-corrected / ground-truth trajectories;
* :func:`write_ply` — the assembled map (+ colors) as a binary PLY any 3-D
  viewer opens, byte for byte as the JAX package writes it;
* :func:`export_run` — TUM trajectory, PCD + PLY map and the overview PNG
  of a finished run in one call.

matplotlib is imported only to draw the PNG; without it the PNG raises an
``ImportError`` that names the file (the other exports are written first).
Colors follow a validated categorical palette (estimate blue, corrected
orange, truth as a dashed neutral reference layer); the map is a recessive
context layer in light gray.
"""
from __future__ import annotations

import os

import numpy as np

from .evaluation import export_tum, host

# categorical slots (validated palette; see docs tooling): series 1/2
_BLUE = "#2a78d6"
_ORANGE = "#eb6834"
_INK = "#0b0b0b"
_INK2 = "#52514e"
_SURFACE = "#fcfcfb"
_MAP_GRAY = "#c9c8c4"


def save_overview_png(path: str, map_pts=None, est_t=None, graph_t=None,
                      gt_t=None, title: str = "run overview"):
    """Write a top-down overview figure.

    Args:
      path: output PNG.
      map_pts: (N,3) global map points (context layer).
      est_t: (F,3) per-frame estimated positions.
      graph_t: (K,3) loop-corrected keyframe positions.
      gt_t: (F,3) ground-truth positions (sim/golden runs).
    """
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"matplotlib is not installed: cannot draw {path}") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 7), dpi=130)
    fig.patch.set_facecolor(_SURFACE)
    ax.set_facecolor(_SURFACE)

    if map_pts is not None and len(map_pts):
        m = host(map_pts)
        ax.scatter(m[:, 0], m[:, 1], s=0.5, c=_MAP_GRAY, linewidths=0,
                   rasterized=True, zorder=1, label=None)
    if gt_t is not None and len(gt_t):
        g = host(gt_t)
        ax.plot(g[:, 0], g[:, 1], "--", color=_INK2, lw=1.4, zorder=2,
                label="ground truth")
    if est_t is not None and len(est_t):
        e = host(est_t)
        ax.plot(e[:, 0], e[:, 1], color=_BLUE, lw=2.0, zorder=3,
                label="estimate")
        ax.plot(e[0, 0], e[0, 1], "o", color=_BLUE, ms=6, zorder=4)
    if graph_t is not None and len(graph_t):
        c = host(graph_t)
        ax.plot(c[:, 0], c[:, 1], color=_ORANGE, lw=2.0, zorder=3,
                label="graph (loop-corrected)")

    ax.set_aspect("equal")
    ax.set_xlabel("x [m]", color=_INK2)
    ax.set_ylabel("y [m]", color=_INK2)
    ax.set_title(title, color=_INK, fontsize=11)
    ax.grid(True, color="#e8e7e3", lw=0.6)
    for s in ax.spines.values():
        s.set_color("#e8e7e3")
    ax.tick_params(colors=_INK2, labelsize=8)
    n_series = sum(x is not None and len(x) for x in (gt_t, est_t, graph_t))
    if n_series >= 2:
        leg = ax.legend(loc="best", fontsize=8, framealpha=0.9,
                        facecolor=_SURFACE, edgecolor="#e8e7e3")
        for txt in leg.get_texts():
            txt.set_color(_INK)
    fig.tight_layout()
    fig.savefig(path, facecolor=fig.get_facecolor())
    plt.close(fig)


def write_ply(path: str, pts, colors=None) -> int:
    """Write (N,3) points (optionally (N,3) uint8 colors) as binary PLY.
    Returns the point count."""
    pts = host(pts).astype(np.float32)
    n = len(pts)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {n}",
               "property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr.append("end_header")
        f.write(("\n".join(hdr) + "\n").encode())
        if colors is None:
            f.write(pts.astype("<f4").tobytes())
        else:
            cols = host(colors).astype(np.uint8)
            rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = pts
            rec["rgb"] = cols
            f.write(rec.tobytes())
    return n


def export_run(out_dir: str, system, est_t=None, gt_t=None,
               map_leaf: float = 0.3) -> dict:
    """One-call run export: TUM trajectory, PCD + PLY map, overview PNG.

    ``system`` is a :class:`LiliOmSystem` after a run (its graph may be on
    the card). Returns the written paths. The PNG is drawn last: without
    matplotlib the other three files are written and its ``ImportError``
    names the PNG. The reference's equivalents are scattered over rviz,
    save_pcd's hardcoded path, and external TUM scripts.
    """
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    nk = len(system.kf_stamps)
    g_t = host(system.graph.t[:nk])
    g_q = host(system.graph.q[:nk])

    paths["trajectory_tum"] = os.path.join(out_dir, "trajectory_kf.tum")
    export_tum(paths["trajectory_tum"], system.kf_stamps, g_t, g_q)

    map_pts = system.build_global_map(leaf=map_leaf)
    paths["map_pcd"] = os.path.join(out_dir, "global_map.pcd")
    system.export_map(paths["map_pcd"], leaf=map_leaf)
    paths["map_ply"] = os.path.join(out_dir, "global_map.ply")
    write_ply(paths["map_ply"], map_pts)

    paths["overview_png"] = os.path.join(out_dir, "overview.png")
    save_overview_png(paths["overview_png"], map_pts=map_pts,
                      est_t=est_t, graph_t=g_t, gt_t=gt_t)
    return paths
