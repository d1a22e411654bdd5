"""PCD file reading/writing (host-side numpy, ASCII + binary; a copy of
`pointcloud_slam_tpu/io/pcd.py`).

Plays the role of PCL's io used throughout the reference: map tile loading
(`dynamic_map.h create_pcd`), keyframe PCD persistence
(`mapOptmization.cpp:1868-1880`), accumulated world cloud saves
(`laser_mapping.cc:776-791`)."""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np

_SIZE = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2", ("I", 4): "i4",
         ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}


def read_pcd(path: str) -> Dict[str, np.ndarray]:
    """Read a PCD v0.7 file. Returns a dict of field name -> (N,) array."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get("COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header["POINTS"])
        dtype = np.dtype([
            (name if cnt == 1 else f"{name}", _SIZE[(t, s)] if cnt == 1 else (_SIZE[(t, s)], (cnt,)))
            for name, s, t, cnt in zip(fields, sizes, types, counts)
        ])
        mode = header["DATA"]
        if mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n)
            raw = np.atleast_2d(raw)
            out = {}
            col = 0
            for name, cnt in zip(fields, counts):
                out[name] = raw[:, col] if cnt == 1 else raw[:, col:col + cnt]
                col += cnt
            return out
        elif mode == "binary":
            buf = f.read(dtype.itemsize * n)
            arr = np.frombuffer(buf, dtype=dtype, count=n)
            return {name: np.ascontiguousarray(arr[name]) for name in arr.dtype.names}
        else:
            raise ValueError(f"unsupported PCD DATA mode: {mode}")


def read_pcd_xyz(path: str) -> np.ndarray:
    """(N, 3) float32 xyz from a PCD file."""
    d = read_pcd(path)
    return np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float32)


def write_pcd(path: str, points: np.ndarray, intensity: Optional[np.ndarray] = None, binary: bool = True,
              extra_fields: Optional[Dict[str, np.ndarray]] = None):
    """Write (N, 3) xyz [+ intensity] [+ extra float32 fields, e.g. per-point
    `time` offsets for deskew replay] as PCD v0.7."""
    n = len(points)
    names = ["x", "y", "z"] + (["intensity"] if intensity is not None else [])
    cols = [points.astype(np.float32)]
    if intensity is not None:
        cols.append(intensity.astype(np.float32)[:, None])
    for name, arr in (extra_fields or {}).items():
        names.append(name)
        cols.append(np.asarray(arr, np.float32)[:, None])
    nf = len(names)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        f"FIELDS {' '.join(names)}\nSIZE {' '.join(['4'] * nf)}\nTYPE {' '.join(['F'] * nf)}\n"
        f"COUNT {' '.join(['1'] * nf)}\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA {'binary' if binary else 'ascii'}\n"
    )
    data = np.concatenate(cols, axis=1)
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(np.ascontiguousarray(data).tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def read_arealist(path: str):
    """Tile-map area list CSV: path, x_min, y_min, z_min, x_max, y_max, z_max
    (reference dynamic_map.h read_arealist)."""
    areas = []
    with open(path) as f:
        for line in f:
            parts = [p.strip() for p in line.strip().split(",") if p.strip()]
            if len(parts) >= 7:
                areas.append({
                    "path": parts[0],
                    "min": np.array([float(parts[1]), float(parts[2]), float(parts[3])]),
                    "max": np.array([float(parts[4]), float(parts[5]), float(parts[6])]),
                })
    return areas


def tiles_for_position(areas, x: float, y: float, margin: float = 100.0):
    """Tiles whose AABB (expanded by margin) contains (x, y)
    (dynamic_map.h is_in_area/create_pcd)."""
    out = []
    for a in areas:
        if (a["min"][0] - margin <= x <= a["max"][0] + margin) and (a["min"][1] - margin <= y <= a["max"][1] + margin):
            out.append(a)
    return out
