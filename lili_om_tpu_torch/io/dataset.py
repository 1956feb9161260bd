"""Dataset record log (``.lom``): the port's counterpart of
``lili_om_tpu/io/dataset.py:21-128`` (the rosbag replacement: the
reference validates by ``rosbag play``; here datasets are record logs
streamed by a readahead reader).

Record layout (little-endian), equal to the JAX package's, so a log
written by either package reads in the other:

* SCAN: f64 stamp, u32 n, then n × (f32 x, y, z, f32 rel_time, f32 refl,
  i32 line);
* IMU: f64 stamp, 3 × f32 acc, 3 × f32 gyr.

The transport (file records, a readahead thread, a bounded queue) is the
native library's ``LogWriter`` / ``LogReader`` (:mod:`..runtime.native`),
as in the JAX package; :mod:`..runtime.log` is its plain version, with the
same bytes, for the tests. Everything here is numpy on the host.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np

from ..runtime import native

_SCAN_DTYPE = np.dtype([
    ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
    ("rel_time", "<f4"), ("refl", "<f4"), ("line", "<i4"),
])


class ScanRecord(NamedTuple):
    stamp: float
    pts: np.ndarray  # (N,3) f32
    rel_time: np.ndarray  # (N,)
    refl: np.ndarray  # (N,)
    line: np.ndarray  # (N,) int32


class ImuRecord(NamedTuple):
    stamp: float
    acc: np.ndarray  # (3,)
    gyr: np.ndarray  # (3,)


class DatasetWriter:
    def __init__(self, path: str):
        self._w = native.LogWriter(path)

    def write_scan(self, rec: ScanRecord):
        n = rec.pts.shape[0]
        body = np.empty(n, _SCAN_DTYPE)
        body["x"], body["y"], body["z"] = rec.pts[:, 0], rec.pts[:, 1], rec.pts[:, 2]
        body["rel_time"] = rec.rel_time
        body["refl"] = rec.refl
        body["line"] = rec.line
        header = np.empty(12, np.uint8)
        header[:8] = np.frombuffer(np.float64(rec.stamp).tobytes(), np.uint8)
        header[8:12] = np.frombuffer(np.uint32(n).tobytes(), np.uint8)
        payload = np.concatenate([header, body.view(np.uint8).reshape(-1)])
        self._w.append(native.KIND_SCAN, payload)

    def write_imu(self, rec: ImuRecord):
        buf = np.empty(8 + 24, np.uint8)
        buf[:8] = np.frombuffer(np.float64(rec.stamp).tobytes(), np.uint8)
        buf[8:] = np.frombuffer(np.concatenate([rec.acc, rec.gyr]).astype("<f4").tobytes(),
                                np.uint8)
        self._w.append(native.KIND_IMU, buf)

    def close(self):
        self._w.close()


def read_dataset(path: str, readahead: int = 64) -> Iterator[ScanRecord | ImuRecord]:
    """Stream records in file order through the native readahead reader."""
    r = native.LogReader(path, readahead=readahead)
    try:
        for kind, raw in r:
            if kind == native.KIND_SCAN:
                stamp = float(np.frombuffer(raw[:8], "<f8")[0])
                n = int(np.frombuffer(raw[8:12], "<u4")[0])
                body = raw[12:12 + n * _SCAN_DTYPE.itemsize].view(_SCAN_DTYPE)
                pts = np.stack([body["x"], body["y"], body["z"]], axis=1)
                yield ScanRecord(stamp, pts, np.asarray(body["rel_time"]),
                                 np.asarray(body["refl"]), np.asarray(body["line"]))
            elif kind == native.KIND_IMU:
                stamp = float(np.frombuffer(raw[:8], "<f8")[0])
                v = np.frombuffer(raw[8:32], "<f4")
                yield ImuRecord(stamp, v[:3].copy(), v[3:6].copy())
    finally:
        r.close()


def record_synthetic(path: str, n_frames: int = 50, variant: str = "rot",
                     imu_rate: float = 200.0, seed: int = 0, device=None):
    """Record a synthetic dataset into a .lom log with the port's simulator
    (the data-side counterpart of the reference's hosted rosbags): a 16×720
    spinning sweep (``variant="rot"``) or a Horizon pattern of 6 × 2000
    points, along an 8 m circle in the room world. The simulator runs on
    the card unless ``device="cpu"``; each record is moved to the host to
    be written."""
    from ..device import resolve_device
    from ..sim.lidar import livox_pattern, simulate_scan, spinning_pattern
    from ..sim.trajectory import circle_trajectory, simulate_imu
    from ..sim.world import make_room_world

    dev = resolve_device(device)
    world = make_room_world(seed=seed, device=dev)
    traj = circle_trajectory(radius=8.0, period=40.0)
    period = 0.1
    pattern = (spinning_pattern(n_rings=16, n_cols=720, device=dev) if variant == "rot"
               else livox_pattern(pts_per_line=2000, device=dev))
    imu = simulate_imu(traj, 0.0, n_frames * period + period, rate=imu_rate, device=dev)
    host = lambda x: x.cpu().numpy()
    w = DatasetWriter(path)
    for s, a, g in zip(host(imu.stamps), host(imu.accs), host(imu.gyrs)):
        w.write_imu(ImuRecord(float(s), a.astype(np.float32), g.astype(np.float32)))
    for k in range(n_frames):
        ts = k * period
        scan = simulate_scan(world, traj, ts, pattern, period=period)
        v = host(scan.valid)  # only returns are recorded (like hardware)
        w.write_scan(ScanRecord(
            ts, host(scan.pts).astype(np.float32)[v],
            host(scan.rel_time).astype(np.float32)[v],
            host(scan.reflectivity).astype(np.float32)[v],
            host(scan.line).astype(np.int32)[v]))
    w.close()


def organize_scan(rec: ScanRecord, n_rings: int, n_cols: int):
    """Rebuild the (R,C) organized image from an unordered scan record using
    ring id + relative time (the packing of ROT Preprocessing.cpp:349-368)."""
    img = np.zeros((n_rings, n_cols, 3), np.float32)
    valid = np.zeros((n_rings, n_cols), bool)
    rel = np.zeros((n_rings, n_cols), np.float32)
    col = np.clip((rec.rel_time * n_cols).astype(np.int64), 0, n_cols - 1)
    ring = np.clip(rec.line, 0, n_rings - 1)
    img[ring, col] = rec.pts
    valid[ring, col] = True
    rel[ring, col] = rec.rel_time
    return img, valid, rel


def decode_spin(rec: ScanRecord, n_rings: int, n_cols: int):
    """A scan record → ``("spin", (img, valid, rel_time))`` for
    :class:`..runtime.ingest.ShardedIngest`: numpy on the host, a
    module-level function, so a spawned decode worker can run it (bind the
    sizes with ``functools.partial``)."""
    return "spin", organize_scan(rec, n_rings, n_cols)


def decode_livox(rec: ScanRecord):
    """A Livox scan record → ``("livox", (pts, line, ratio, refl, valid))``,
    the flat stream ``process_scan_livox`` takes (as
    ``examples/run_dataset.py`` plays a Livox log)."""
    return "livox", (rec.pts, rec.line.astype(np.int32), np.clip(rec.rel_time, 0, 0.999),
                     rec.refl, np.isfinite(rec.pts).all(axis=1))
