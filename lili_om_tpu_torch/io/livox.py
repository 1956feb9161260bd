"""Livox stream adapters (the port's own copy of ``lili_om_tpu/io/livox.py``,
numpy only).

* :func:`pack_custom_points`: the reference's FormatConvert node,
  CustomMsg-style per-point records → the packed layout the pipeline reads,
  ``intensity = line + 0.1·(offset_time/time_end)``, ``curvature =
  0.1·reflectivity``.
* :func:`unpack_points`: the packing inverted into (line, ratio, curv).
* :func:`convert_internal_imu`: the reference's InternalImuUnitConverter
  helper: the Livox internal IMU's accel from g to m/s² (×9.8) and an
  initial orientation from gravity (roll and pitch by atan2 over the first
  samples), for the ``fr_iosb_internal_imu`` preset.
"""
from __future__ import annotations

import numpy as np


def pack_custom_points(xyz: np.ndarray, line: np.ndarray, offset_time: np.ndarray,
                       reflectivity: np.ndarray, time_end: float):
    """(N,3), (N,), (N,), (N,) → (xyz, intensity, curvature) arrays."""
    ratio = np.clip(offset_time / max(time_end, 1e-9), 0.0, 0.999999)
    intensity = line.astype(np.float32) + 0.1 * ratio.astype(np.float32)
    curvature = 0.1 * reflectivity.astype(np.float32)
    return xyz.astype(np.float32), intensity, curvature


def unpack_points(intensity: np.ndarray, curvature: np.ndarray):
    """intensity/curvature channels → (line int32, time ratio, curv)."""
    line = np.floor(intensity).astype(np.int32)
    ratio = (intensity - line) * 10.0
    return line, ratio.astype(np.float32), curvature.astype(np.float32)


def convert_internal_imu(accs_g: np.ndarray, gyrs: np.ndarray, n_init: int = 3,
                         g: float = 9.8):
    """Livox internal IMU: accel in g → m/s², plus a gravity-aligned initial
    orientation quaternion (w,x,y,z) from the first ``n_init`` samples:
    roll = atan2(ay, az), pitch = atan2(−ax, √(ay²+az²)), yaw = 0."""
    accs = np.asarray(accs_g, np.float64) * g
    a0 = accs[:n_init].mean(axis=0)
    roll = np.arctan2(a0[1], a0[2])
    pitch = np.arctan2(-a0[0], np.sqrt(a0[1] ** 2 + a0[2] ** 2))
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    # q = Rz(0)·Ry(pitch)·Rx(roll)
    q = np.array([cp * cr, cp * sr, sp * cr, -sp * sr])
    q /= np.linalg.norm(q)
    return accs.astype(np.float32), np.asarray(gyrs, np.float32), q.astype(np.float32)
