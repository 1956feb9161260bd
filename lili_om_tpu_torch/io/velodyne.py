"""Velodyne raw-packet (``velodyne_msgs/VelodyneScan``) decoder: a copy of
``lili_om_tpu/io/velodyne.py:1-140`` (numpy only).

The reference's UTBM pipeline does not consume PointCloud2 directly — the
launch file spawns a ``velodyne_pointcloud/cloud_node`` to decode the raw
UDP packets first (LiLi-OM-ROT/launch/run_utbm.launch:6-14). This module is
the pure-numpy equivalent, so UTBM bags feed the ROT path with no ROS.

Packet format (HDL-32E / VLP-16, 1206 bytes):
12 blocks × 100 B — ``u16 flag, u16 azimuth(0.01°), 32×(u16 dist(2 mm),
u8 intensity)`` — then ``u32 gps_stamp(µs), u8 return_mode, u8 product_id``.
Geometry matches the ROS driver's convention (x forward, y left):
``x = d·cosV·cos(az), y = −d·cosV·sin(az), z = d·sinV``.

Downstream needs only (xyz, ring, intensity): the ROT preprocessing derives
each point's relative sweep time from its horizontal angle itself
(LiLi-OM-ROT/src/Preprocessing.cpp:349-368), so no per-firing timing model
is required.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

# laser vertical angles in FIRING order (degrees)
_HDL32E_STEP = 4.0 / 3.0
_VERT_HDL32E = np.array(
    [(-30.67 + (i // 2) * _HDL32E_STEP) if i % 2 == 0
     else (-9.33 + (i // 2) * _HDL32E_STEP) for i in range(32)])
# VLP-16 firing order interleaves low/high: [-15,1,-13,3,…,-1,15]
_VERT_VLP16 = np.array([[-15 + 2 * k, 1 + 2 * k] for k in range(8)],
                       dtype=float).reshape(-1)

# ring id = rank of the laser by ascending vertical angle (the ROS driver's
# ring convention)
_RING_HDL32E = np.argsort(np.argsort(_VERT_HDL32E))
_RING_VLP16 = np.argsort(np.argsort(_VERT_VLP16))

MODELS = {
    "HDL32E": (_VERT_HDL32E, _RING_HDL32E, 32),
    "VLP16": (_VERT_VLP16, _RING_VLP16, 16),
}


class VelodyneScanMsg(NamedTuple):
    """One ``velodyne_msgs/VelodyneScan``: a sweep's worth of raw packets."""

    stamp: float
    packet_stamps: np.ndarray  # (P,) seconds
    packets: np.ndarray  # (P, 1206) uint8


class DecodedScan(NamedTuple):
    pts: np.ndarray  # (N,3) float32, ROS frame (x fwd, y left, z up)
    ring: np.ndarray  # (N,) int32
    intensity: np.ndarray  # (N,) float32
    valid: np.ndarray  # (N,) bool (distance > 0)


def decode_packets(packets: np.ndarray, model: str = "HDL32E") -> DecodedScan:
    """Decode (P,1206) raw packet bytes into a flat point cloud.

    Fully vectorized; invalid returns (distance 0) keep their slot with
    ``valid=False`` so the output shape is a static function of P.
    """
    vert, ring_of_laser, n_lasers = MODELS[model]
    raw = np.ascontiguousarray(packets, dtype=np.uint8)
    P = raw.shape[0]
    blocks = raw[:, :1200].reshape(P * 12, 100)
    azimuth = blocks[:, 2:4].copy().view("<u2").ravel().astype(np.float64) * 0.01  # deg
    ch = blocks[:, 4:100].reshape(P * 12, 32, 3)
    dist = ch[:, :, 0:2].copy().view("<u2").reshape(P * 12, 32).astype(np.float32) * 0.002
    intens = ch[:, :, 2].astype(np.float32)

    if n_lasers == 16:
        # each block holds two 16-laser firing sequences; the second fires
        # half a block-step later in azimuth
        az_next = np.roll(azimuth, -1)
        az_next[-1] = azimuth[-1] + (azimuth[-1] - azimuth[-2]) % 360.0
        step = (az_next - azimuth) % 360.0
        az = np.stack([azimuth, (azimuth + 0.5 * step) % 360.0], axis=1)  # (B,2)
        az = np.repeat(az[:, :, None], 16, axis=2).reshape(P * 12, 32)
        laser = np.tile(np.arange(16), 2)
    else:
        az = np.repeat(azimuth[:, None], 32, axis=1)
        laser = np.arange(32)

    v = np.deg2rad(vert[laser % n_lasers])[None, :]
    a = np.deg2rad(az)
    cv, sv = np.cos(v), np.sin(v)
    x = dist * cv * np.cos(a)
    y = -dist * cv * np.sin(a)
    z = dist * sv
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    ring = np.broadcast_to(ring_of_laser[laser % n_lasers][None, :],
                           dist.shape).reshape(-1).astype(np.int32)
    return DecodedScan(pts, ring, intens.reshape(-1), dist.reshape(-1) > 0.001)


def encode_packets(pts: np.ndarray, ring: np.ndarray,
                   intensity: np.ndarray | None = None,
                   model: str = "HDL32E") -> np.ndarray:
    """Inverse of :func:`decode_packets` for test fixtures: bin points by
    azimuth into blocks and write raw packets. Points quantize to the 0.01°
    azimuth and 2 mm range grid; ties within (block, laser) keep the last
    write. Returns (P,1206) uint8."""
    vert, ring_of_laser, n_lasers = MODELS[model]
    laser_of_ring = np.argsort(ring_of_laser)
    r = np.linalg.norm(pts, axis=1)
    az = (np.rad2deg(np.arctan2(-pts[:, 1], pts[:, 0]))) % 360.0
    v = np.rad2deg(np.arcsin(np.clip(pts[:, 2] / np.maximum(r, 1e-9), -1, 1)))
    dist = r  # slant range
    # one block per unique azimuth bin (keep it simple: 12 blocks/packet)
    az_q = np.round(az * 100).astype(np.int64)
    uniq = np.unique(az_q)
    n_blocks = ((len(uniq) + 11) // 12) * 12
    P = n_blocks // 12
    raw = np.zeros((P * 12, 100), np.uint8)
    block_of = {a: i for i, a in enumerate(uniq)}
    raw_u16 = np.zeros((P * 12, 2), "<u2")
    raw_u16[:len(uniq), 0] = 0xEEFF
    raw_u16[:len(uniq), 1] = uniq % 36000
    raw[:, 0:4] = raw_u16.view(np.uint8).reshape(P * 12, 4)
    ch = np.zeros((P * 12, 32, 3), np.uint8)
    d_q = np.round(dist / 0.002).astype(np.int64).clip(0, 65535)
    inten = (np.zeros(len(pts)) if intensity is None else intensity)
    for k in range(len(pts)):
        b = block_of[az_q[k]]
        slot = int(laser_of_ring[int(ring[k]) % n_lasers])
        if n_lasers == 16:
            pass  # first firing sequence only
        dd = np.array([d_q[k]], "<u2").view(np.uint8)
        ch[b, slot, 0:2] = dd
        ch[b, slot, 2] = np.uint8(min(int(inten[k]), 255))
    raw[:, 4:100] = ch.reshape(P * 12, 96)
    pkt = np.zeros((P, 1206), np.uint8)
    pkt[:, :1200] = raw.reshape(P, 1200)
    pkt[:, 1204] = 0x37  # return mode: strongest
    pkt[:, 1205] = 0x21 if n_lasers == 32 else 0x22
    return pkt
