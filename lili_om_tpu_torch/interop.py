"""Carried state ↔ dicts of numpy arrays.

The system has no learned weights: its parameters are the carried states.
The dicts are keyed by the field names of the JAX package's NamedTuples
(``OdometryState``, ``FusionState``, ``PoseGraph``, ``VoxelHashGrid``), so a
JAX state, graph or hash grid can be carried into the port and back; nested tuples (``preints``, ``prior``)
flatten to dotted keys such as ``"prior.J"``. Float arrays take the
requested dtype, integer arrays become int32 and boolean arrays stay
boolean, as in the states of both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .factors.prior import MarginalPrior
from .models.fusion import FusionState
from .models.odometry import OdometryState
from .models.pose_graph import PoseGraph
from .ops.hashgrid import VoxelHashGrid
from .ops.preintegration import Preint

_NESTED = {"preints": Preint, "prior": MarginalPrior}


def _to_numpy(state) -> dict:
    out = {}
    for name, val in state._asdict().items():
        if hasattr(val, "_fields"):
            for sub, arr in _to_numpy(val).items():
                out[f"{name}.{sub}"] = arr
        else:
            out[name] = val.detach().cpu().numpy()
    return out


def _tensor(a, dtype, dev):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.as_tensor(a).to(dev)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int32)).to(dev)
    return torch.as_tensor(a).to(device=dev, dtype=dtype)


def _from_numpy(cls, d: dict, dtype, dev, prefix=""):
    vals = {}
    for name in cls._fields:
        sub = _NESTED.get(name)
        if sub is not None and cls is FusionState:
            vals[name] = _from_numpy(sub, d, dtype, dev, prefix=f"{name}.")
        else:
            vals[name] = _tensor(d[prefix + name], dtype, dev)
    return cls(**vals)


def odometry_state_to_numpy(state: OdometryState) -> dict:
    return _to_numpy(state)


def odometry_state_from_numpy(d: dict, dtype=torch.float32, device=None) -> OdometryState:
    return _from_numpy(OdometryState, d, dtype, resolve_device(device))


def fusion_state_to_numpy(state: FusionState) -> dict:
    return _to_numpy(state)


def fusion_state_from_numpy(d: dict, dtype=torch.float32, device=None) -> FusionState:
    return _from_numpy(FusionState, d, dtype, resolve_device(device))


def pose_graph_to_numpy(graph: PoseGraph) -> dict:
    return _to_numpy(graph)


def pose_graph_from_numpy(d: dict, dtype=torch.float32, device=None) -> PoseGraph:
    return _from_numpy(PoseGraph, d, dtype, resolve_device(device))


def hashgrid_to_numpy(grid: VoxelHashGrid) -> dict:
    return _to_numpy(grid)


def hashgrid_from_numpy(d: dict, dtype=torch.float32, device=None) -> VoxelHashGrid:
    return _from_numpy(VoxelHashGrid, d, dtype, resolve_device(device))
