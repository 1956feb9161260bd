"""Checkpoint / resume of the whole SLAM state, in the JAX package's file
format: the port's counterpart of ``lili_om_tpu/io/checkpoint.py:21-140``.

A checkpoint is one ``.npz`` (``np.savez_compressed``) plus a ``.json``
sidecar. The carried states are flattened in NamedTuple field order,
recursively, as ``jax.tree.flatten`` orders them (the two packages'
``OdometryState``, ``FusionState`` and ``PoseGraph`` have the same fields):
leaves ``odo__i``, ``fusion__i`` and ``graph__i``. The keyframe archives
are stored as ``kf_cloud__i``, ``kf_edge__i`` and ``kf_full__i`` (spilled
archives are read back first), and the JSON holds the host-side
bookkeeping under the JAX package's keys. So a checkpoint saved by either
package loads into the other. JAX also writes its treedef as text under
``<prefix>__treedef``, which nothing reads back; the port writes a marker
in its place.

Restoring gives the exact state, so a resumed run continues bit-identically
on the same inputs.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _leaves(tree) -> list:
    """The tensors of a (nested) NamedTuple in field order."""
    out = []
    for val in tree:
        if hasattr(val, "_fields"):
            out += _leaves(val)
        elif val is None:
            # jax.tree.flatten drops None leaves, so the indices would shift
            raise ValueError(f"{type(tree).__name__} has a None field: the JAX leaf order "
                             "cannot be kept")
        else:
            out.append(val)
    return out


def _rebuild(template, leaves: list):
    """``template`` with its leaves replaced, in field order."""
    vals = []
    for val in template:
        if hasattr(val, "_fields"):
            vals.append(_rebuild(val, leaves))
        else:
            vals.append(leaves.pop(0))
    return type(template)(*vals)


def _flatten(prefix: str, tree: Any, out: dict):
    out[f"{prefix}__treedef"] = np.frombuffer(
        f"lili_om_tpu_torch:{type(tree).__name__}".encode(), dtype=np.uint8)
    for i, leaf in enumerate(_leaves(tree)):
        out[f"{prefix}__{i}"] = leaf.detach().cpu().numpy()


def _cast(arr: np.ndarray, dtype, device) -> torch.Tensor:
    """A stored leaf on ``device``, as ``interop.py`` converts: integers
    int32, booleans as they are, floats in the system's ``dtype``. The shape
    is the stored one (a graph's capacity may have grown)."""
    arr = np.asarray(arr)
    if arr.dtype == np.bool_:
        t = torch.as_tensor(arr)
    elif np.issubdtype(arr.dtype, np.integer):
        t = torch.as_tensor(arr.astype(np.int32))
    else:
        t = torch.as_tensor(arr).to(dtype)
    return t.to(device)


def _unflatten(prefix: str, template: Any, data, dtype, device) -> Any:
    n = len(_leaves(template))
    return _rebuild(template, [_cast(data[f"{prefix}__{i}"], dtype, device) for i in range(n)])


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_system(path: str, system) -> None:
    """Write a LiliOmSystem checkpoint (single .npz + .json sidecar)."""
    out: dict = {}
    _flatten("odo", system.odo_state, out)
    _flatten("fusion", system.fusion_state, out)
    _flatten("graph", system.graph, out)
    for i in range(len(system.kf_clouds)):
        out[f"kf_cloud__{i}"] = system._kf_cloud_np(i)
    for i in range(len(system.kf_edge_clouds)):
        out[f"kf_edge__{i}"] = system._kf_cloud_np(i, system.kf_edge_clouds)
    for i in range(len(system.kf_full_clouds)):
        out[f"kf_full__{i}"] = system._kf_cloud_np(i, system.kf_full_clouds)
    out["kf_stamps"] = np.asarray(system.kf_stamps)
    out["kf_positions"] = (np.stack([_host(p) for p in system.kf_positions])
                           if system.kf_positions else np.zeros((0, 3)))
    out["imu_stamps"], out["imu_accs"], out["imu_gyrs"] = system.imu_buffer()
    np.savez_compressed(path, **out)
    meta = {
        "n_frames": system.n_frames,
        "n_keyframes": len(system.kf_stamps),
        "last_loop_stamp": system.last_loop_stamp,
        "trajectory": [list(map(float, t)) for t in system.trajectory],
        "frame_stamps": list(map(float, system._frame_stamps)),
        "last_kf_stamp": system._last_kf_stamp,
        "dense_trajectory": [
            [float(s), list(map(float, t)), list(map(float, q))]
            for s, t, q in system.dense_trajectory
        ],
        "prev_kf": (None if system._prev_kf is None else
                    [float(system._prev_kf[0])] +
                    [list(map(float, _host(x))) for x in system._prev_kf[1:]]),
        # host mirrors of device counters: without them a resume re-enters
        # the fusion warm-up (no correspondences or marginalization for the
        # first window-1 keyframes)
        "kf_count_host": int(system._kf_count_host),
        "starved_frames": int(system._starved_frames),
        "last_rel_t": list(map(float, system._last_rel_t)),
        "maps_dirty": bool(system._maps_dirty),
        "loop_pairs": [[int(i), int(j)] for i, j in system._loop_pairs],
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def _archive(data, prefix: str) -> list:
    out, i = [], 0
    while f"{prefix}__{i}" in data:
        out.append(data[f"{prefix}__{i}"])
        i += 1
    return out


def load_system(path: str, system) -> None:
    """Restore a checkpoint into an already-constructed LiliOmSystem of the
    same configuration, in place, on its device and in its dtype."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    dt, dev = system.dtype, system.device
    system.odo_state = _unflatten("odo", system.odo_state, data, dt, dev)
    system.fusion_state = _unflatten("fusion", system.fusion_state, data, dt, dev)
    system.graph = _unflatten("graph", system.graph, data, dt, dev)
    system.kf_stamps = [float(s) for s in data["kf_stamps"]]
    system.kf_positions = [p for p in data["kf_positions"]]
    system.kf_clouds = _archive(data, "kf_cloud")
    system.kf_edge_clouds = _archive(data, "kf_edge")
    system.kf_full_clouds = _archive(data, "kf_full")
    # older checkpoints predate the edge/full archives: fall back to surf
    if not system.kf_edge_clouds:
        system.kf_edge_clouds = [np.zeros((0, 3)) for _ in system.kf_clouds]
    if not system.kf_full_clouds:
        system.kf_full_clouds = list(system.kf_clouds)
    system._spill_marks = {}
    meta_path = (path[:-4] if path.endswith(".npz") else path) + ".json"
    if not os.path.exists(meta_path):
        meta_path = path + ".json"
    with open(meta_path) as f:
        meta = json.load(f)
    system.n_frames = meta["n_frames"]
    system.last_loop_stamp = meta["last_loop_stamp"]
    system.trajectory = [np.asarray(t) for t in meta["trajectory"]]
    system._frame_stamps = list(meta.get("frame_stamps", []))
    system._last_kf_stamp = meta.get("last_kf_stamp")
    system.dense_trajectory = [
        (s, np.asarray(t), np.asarray(q))
        for s, t, q in meta.get("dense_trajectory", [])
    ]
    pk = meta.get("prev_kf")
    system._prev_kf = (None if pk is None else
                       (pk[0], np.asarray(pk[1]), np.asarray(pk[2]), np.asarray(pk[3])))
    system._kf_count_host = int(meta.get("kf_count_host", int(system.fusion_state.kf_count)))
    system._starved_frames = int(meta.get("starved_frames", 0))
    system._last_rel_t = np.asarray(meta.get("last_rel_t", [0.0, 0.0, 0.0]))
    # older checkpoints predate the incremental map tables: rebuild once
    system._maps_dirty = bool(meta.get("maps_dirty", True))
    system._loop_pairs = [(int(i), int(j)) for i, j in meta.get("loop_pairs", [])]
    if "imu_stamps" in data:
        with system._imu_lock:
            system._imu_stamps = data["imu_stamps"]
            system._imu_accs = data["imu_accs"]
            system._imu_gyrs = data["imu_gyrs"]
