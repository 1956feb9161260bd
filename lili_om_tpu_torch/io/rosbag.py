"""Minimal ROS1 bag reader: a copy of ``lili_om_tpu/io/rosbag.py:1-255``
(numpy only). It lets users run the reference's actual datasets (FR_IOSB /
KA_Urban / UTBM rosbags, README.md:31-34) without any ROS installation.
Pure-python binary parsing of the rosbag v2.0 format.

Supported: uncompressed and bz2 chunks, and lz4 chunks where the ``lz4``
module is importable; message types used by the reference pipelines:

* ``sensor_msgs/Imu``
* ``sensor_msgs/PointCloud2`` (spinning LiDARs; arbitrary field layouts)
* ``livox_ros_driver/CustomMsg`` (Livox Horizon)
* ``velodyne_msgs/VelodyneScan`` (raw packets, decoded by ``io/velodyne.py``)

Usage::

    for topic, msg in read_bag("seq.bag"):
        if isinstance(msg, ImuMsg): ...
"""
from __future__ import annotations

import bz2
import struct
from typing import Iterator, NamedTuple, Optional

import numpy as np


class ImuMsg(NamedTuple):
    stamp: float
    orientation: np.ndarray  # (4,) w,x,y,z
    gyr: np.ndarray  # (3,)
    acc: np.ndarray  # (3,)


class PointCloud2Msg(NamedTuple):
    stamp: float
    fields: dict  # name -> (offset, datatype, count)
    point_step: int
    n_points: int
    data: np.ndarray  # raw uint8

    def field(self, name: str) -> np.ndarray:
        """Extract one field as a flat array (little-endian only)."""
        off, dt, cnt = self.fields[name]
        np_dt = _PF_DTYPES[dt]
        view = np.frombuffer(self.data.tobytes(), np.uint8).reshape(self.n_points, self.point_step)
        raw = view[:, off:off + np_dt.itemsize * cnt].copy()
        return raw.view(np_dt).reshape(self.n_points, cnt).squeeze(-1) if cnt == 1 else \
            raw.view(np_dt).reshape(self.n_points, cnt)

    def xyz(self) -> np.ndarray:
        return np.stack([self.field("x"), self.field("y"), self.field("z")], axis=1)


class LivoxCustomMsg(NamedTuple):
    stamp: float
    timebase: int
    pts: np.ndarray  # (N,3) f32
    offset_time: np.ndarray  # (N,) uint32 ns
    reflectivity: np.ndarray  # (N,) uint8
    line: np.ndarray  # (N,) uint8


# PointField datatypes (sensor_msgs/PointField)
_PF_DTYPES = {1: np.dtype("<i1"), 2: np.dtype("<u1"), 3: np.dtype("<i2"),
              4: np.dtype("<u2"), 5: np.dtype("<i4"), 6: np.dtype("<u4"),
              7: np.dtype("<f4"), 8: np.dtype("<f8")}


def _parse_header(buf: bytes) -> dict:
    fields = {}
    i = 0
    while i < len(buf):
        (flen,) = struct.unpack_from("<I", buf, i)
        i += 4
        entry = buf[i:i + flen]
        i += flen
        k, _, v = entry.partition(b"=")
        fields[k.decode()] = v
    return fields


def _records(buf: bytes) -> Iterator[tuple[dict, bytes]]:
    i = 0
    n = len(buf)
    while i + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        header = _parse_header(buf[i:i + hlen])
        i += hlen
        (dlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        data = buf[i:i + dlen]
        i += dlen
        yield header, data


def _read_string(buf, i):
    (n,) = struct.unpack_from("<I", buf, i)
    return buf[i + 4:i + 4 + n], i + 4 + n


def _read_ros_header(buf, i):
    """std_msgs/Header: seq u32, stamp (sec,nsec) u32, frame_id string."""
    seq, sec, nsec = struct.unpack_from("<III", buf, i)
    _, i2 = _read_string(buf, i + 12)
    return sec + nsec * 1e-9, i2


def parse_imu(data: bytes) -> ImuMsg:
    stamp, i = _read_ros_header(data, 0)
    vals = struct.unpack_from("<" + "d" * (4 + 9 + 3 + 9 + 3 + 9), data, i)
    ox, oy, oz, ow = vals[0:4]  # ROS quaternion order x,y,z,w
    gyr = np.array(vals[13:16])
    acc = np.array(vals[25:28])
    return ImuMsg(stamp, np.array([ow, ox, oy, oz]), gyr, acc)


def parse_pointcloud2(data: bytes) -> PointCloud2Msg:
    stamp, i = _read_ros_header(data, 0)
    height, width = struct.unpack_from("<II", data, i)
    i += 8
    (nfields,) = struct.unpack_from("<I", data, i)
    i += 4
    fields = {}
    for _ in range(nfields):
        name, i = _read_string(data, i)
        off, dt, cnt = struct.unpack_from("<IBI", data, i)
        i += 9
        fields[name.decode()] = (off, dt, cnt)
    _, point_step, _row_step = struct.unpack_from("<BII", data, i)
    i += 9
    (dlen,) = struct.unpack_from("<I", data, i)
    i += 4
    raw = np.frombuffer(data, np.uint8, count=dlen, offset=i)
    return PointCloud2Msg(stamp, fields, point_step, height * width, raw)


def parse_livox_custom(data: bytes) -> LivoxCustomMsg:
    stamp, i = _read_ros_header(data, 0)
    (timebase,) = struct.unpack_from("<Q", data, i)
    i += 8
    (point_num,) = struct.unpack_from("<I", data, i)
    i += 4
    i += 4  # lidar_id u8 + rsvd 3×u8
    (n,) = struct.unpack_from("<I", data, i)  # points array length
    i += 4
    rec = np.dtype([("offset_time", "<u4"), ("x", "<f4"), ("y", "<f4"),
                    ("z", "<f4"), ("reflectivity", "u1"), ("tag", "u1"),
                    ("line", "u1")])
    body = np.frombuffer(data, rec, count=n, offset=i)
    pts = np.stack([body["x"], body["y"], body["z"]], axis=1)
    return LivoxCustomMsg(stamp, timebase, pts,
                          np.asarray(body["offset_time"]),
                          np.asarray(body["reflectivity"]),
                          np.asarray(body["line"]))


def parse_velodyne_scan(data: bytes):
    """velodyne_msgs/VelodyneScan: Header + VelodynePacket[] where each
    packet is (stamp sec u32, nsec u32, data u8[1206]). Raw UDP payloads —
    the reference decodes them with velodyne_pointcloud's cloud_node
    (run_utbm.launch:6-14); we decode with io.velodyne.decode_packets."""
    from .velodyne import VelodyneScanMsg

    stamp, i = _read_ros_header(data, 0)
    (n,) = struct.unpack_from("<I", data, i)
    i += 4
    rec = np.dtype([("sec", "<u4"), ("nsec", "<u4"), ("data", "u1", 1206)])
    body = np.frombuffer(data, rec, count=n, offset=i)
    return VelodyneScanMsg(stamp,
                           body["sec"] + body["nsec"] * 1e-9,
                           np.ascontiguousarray(body["data"]))


_PARSERS = {
    "sensor_msgs/Imu": parse_imu,
    "sensor_msgs/PointCloud2": parse_pointcloud2,
    "livox_ros_driver/CustomMsg": parse_livox_custom,
    "livox_ros_driver2/CustomMsg": parse_livox_custom,
    "velodyne_msgs/VelodyneScan": parse_velodyne_scan,
}


def _records_stream(f) -> Iterator[tuple[dict, bytes]]:
    """Record iterator over an open file handle — O(record) memory. Index
    data (op 0x04) and chunk-info (op 0x06) payloads are seeked past without
    reading (they can be a large fraction of a long bag and the sequential
    reader never needs them)."""
    while True:
        b = f.read(4)
        if len(b) < 4:
            return
        (hlen,) = struct.unpack("<I", b)
        header = _parse_header(f.read(hlen))
        b = f.read(4)
        if len(b) < 4:
            return
        (dlen,) = struct.unpack("<I", b)
        op = header.get("op", b"\x00")[0]
        if op in (0x04, 0x06):  # index data / chunk info — skip payload
            f.seek(dlen, 1)
            yield header, b""
            continue
        data = f.read(dlen)
        if len(data) < dlen:
            return
        yield header, data


def read_bag(path: str, topics: Optional[set] = None) -> Iterator[tuple[str, object]]:
    """Yield (topic, parsed_message) in file order — STREAMING: the file is
    parsed record-by-record from the handle, holding at most one chunk's
    decompressed payload (~1 MB at rosbag's default chunk size) in memory at
    a time. The reference's workflow replays multi-GB bags with ``rosbag
    play`` (README.md:57-76); slurping them (`f.read()`) would thrash long
    before the first scan. Unknown message types are skipped; ``topics``
    filters by topic name."""
    connections: dict[int, tuple[str, str]] = {}

    def handle(records):
        for header, data in records:
            op = header.get("op", b"\x00")[0]
            if op == 0x07:  # connection
                conn = struct.unpack("<I", header["conn"])[0]
                topic = header["topic"].decode()
                chdr = _parse_header(data)
                mtype = chdr.get("type", b"").decode()
                connections[conn] = (topic, mtype)
            elif op == 0x02:  # message data
                conn = struct.unpack("<I", header["conn"])[0]
                topic, mtype = connections.get(conn, ("?", "?"))
                if topics is not None and topic not in topics:
                    continue
                parser = _PARSERS.get(mtype)
                if parser is None:
                    continue
                yield topic, parser(data)
            elif op == 0x05:  # chunk (one decompressed payload at a time)
                compression = header.get("compression", b"none").decode()
                payload = data
                if compression == "bz2":
                    payload = bz2.decompress(data)
                elif compression == "lz4":
                    try:
                        import lz4.frame

                        payload = lz4.frame.decompress(data)
                    except ImportError as e:
                        raise IOError("lz4-compressed bag; lz4 module unavailable") from e
                yield from handle(_records(payload))

    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise IOError(f"not a rosbag v2.0: {path}")
        yield from handle(_records_stream(f))
