"""PCD point-cloud export/import: a copy of ``lili_om_tpu/io/pcd.py:12-54``
(numpy only), the counterpart of the reference's PCL global-map dump
(BackendFusion.cpp:2697-2722), with the path an argument.

Binary-format PCD v0.7, xyz (+ optional intensity). The port's
``export_map`` writes its maps through the native writer
(``runtime/native.py:pcd_write_native``), as the JAX package does;
:func:`write_pcd` is its plain version and writes the same bytes.
"""
from __future__ import annotations

import numpy as np


def write_pcd(path: str, pts: np.ndarray, intensity: np.ndarray | None = None) -> None:
    pts = np.asarray(pts, np.float32)
    n = pts.shape[0]
    fields = "x y z" + (" intensity" if intensity is not None else "")
    count = "1 1 1" + (" 1" if intensity is not None else "")
    size = "4 4 4" + (" 4" if intensity is not None else "")
    typ = "F F F" + (" F" if intensity is not None else "")
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE {size}\n"
        f"TYPE {typ}\n"
        f"COUNT {count}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA binary\n"
    )
    if intensity is not None:
        data = np.concatenate([pts, np.asarray(intensity, np.float32)[:, None]], axis=1)
    else:
        data = pts
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(np.ascontiguousarray(data, np.float32).tobytes())


def read_pcd(path: str) -> np.ndarray:
    """Read a binary or ascii xyz[+extras] PCD written by this module or PCL."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode(errors="replace").strip()
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        n = int(header["POINTS"])
        n_fields = len(header["FIELDS"].split())
        if val.strip() == "binary":
            raw = np.frombuffer(f.read(n * n_fields * 4), np.float32)
            return raw.reshape(n, n_fields)
        rows = [list(map(float, f.readline().split())) for _ in range(n)]
        return np.asarray(rows, np.float32)
