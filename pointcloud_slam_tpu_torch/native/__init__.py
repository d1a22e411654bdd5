"""Native (C++) layer loader: parity oracle, sensor-ingest shim, live driver
and bag reader (the port's own copy of `pointcloud_slam_tpu/native/__init__.py`).

Compiles `native/src/{oracle,ingest,live_driver,bagreader}.cpp` with g++ at
first use and binds them through ctypes. The library is built under
`build/torch_native/` at the root of the checkout (git-ignored), named by a
hash of the sources and the flags, and written to a temporary file that is
renamed into place: processes that build at once (parallel test workers)
never load half a file, and an edited source gets a new library. It never
writes `native/build/`, which the JAX package's loader rebuilds in place.
This is host code: nothing here touches the GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SRC_DIR = _ROOT / "native" / "src"
BUILD_DIR = _ROOT / "build" / "torch_native"
SOURCES = ("oracle.cpp", "ingest.cpp", "live_driver.cpp", "bagreader.cpp")
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    srcs = [SRC_DIR / f for f in SOURCES]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in srcs) + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libpcs_native_{digest.hexdigest()[:12]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, *(str(SRC_DIR / f) for f in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    L = ctypes.CDLL(str(_build()))
    dp = ctypes.POINTER(ctypes.c_double)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    up = ctypes.POINTER(ctypes.c_uint8)
    L.oracle_esti_plane.restype = ctypes.c_int
    L.oracle_esti_plane.argtypes = [dp, ctypes.c_int, ctypes.c_double, dp]
    L.oracle_knn.restype = None
    L.oracle_knn.argtypes = [dp, ctypes.c_int, dp, ctypes.c_int, ctypes.c_int, ctypes.c_double, ip, dp]
    L.oracle_icp_point_to_plane.restype = ctypes.c_int
    L.oracle_icp_point_to_plane.argtypes = [dp, ctypes.c_int, dp, ctypes.c_int, ctypes.c_int, ctypes.c_double, dp, dp]
    L.oracle_eigh3.restype = None
    L.oracle_eigh3.argtypes = [dp, dp]
    L.oracle_scan_to_map_replay.restype = ctypes.c_int
    L.oracle_scan_to_map_replay.argtypes = [dp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_double, ctypes.c_double, ctypes.c_int, dp]
    L.ingest_create.restype = ctypes.c_void_p
    L.ingest_create.argtypes = [ctypes.c_int, ctypes.c_int]
    L.ingest_destroy.argtypes = [ctypes.c_void_p]
    L.ingest_push_imu.argtypes = [ctypes.c_void_p, dp, fp, fp, ctypes.c_int]
    L.ingest_make_frame.restype = ctypes.c_int
    L.ingest_make_frame.argtypes = [ctypes.c_void_p, fp, dp, ctypes.c_int, ctypes.c_double, ctypes.c_double,
                                    ctypes.c_double, ctypes.c_int, fp, up, fp, fp, fp, fp, fp, up]
    L.ingest_pending_imu.restype = ctypes.c_int
    L.ingest_pending_imu.argtypes = [ctypes.c_void_p]
    L.live_create.restype = ctypes.c_void_p
    L.live_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int]
    L.live_destroy.argtypes = [ctypes.c_void_p]
    L.live_load_scan.argtypes = [ctypes.c_void_p, fp, dp, ctypes.c_int, ctypes.c_double, ctypes.c_double]
    L.live_load_imu.argtypes = [ctypes.c_void_p, dp, fp, fp, ctypes.c_int]
    L.live_run.argtypes = [ctypes.c_void_p]
    L.live_pop_frame.restype = ctypes.c_int
    L.live_pop_frame.argtypes = [ctypes.c_void_p, fp, up, fp, fp, fp, fp, fp, up, ctypes.c_int]
    L.live_queue_depth.restype = ctypes.c_int
    L.live_queue_depth.argtypes = [ctypes.c_void_p]
    L.bag_last_error.restype = ctypes.c_char_p
    L.bag_open.restype = ctypes.c_void_p
    L.bag_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
    L.bag_close.argtypes = [ctypes.c_void_p]
    L.bag_num_messages.restype = ctypes.c_int
    L.bag_num_messages.argtypes = [ctypes.c_void_p]
    L.bag_next.restype = ctypes.c_int
    L.bag_next.argtypes = [ctypes.c_void_p]
    L.bag_imu.argtypes = [ctypes.c_void_p, dp, dp, dp]
    L.bag_cloud_size.restype = ctypes.c_int
    L.bag_cloud_size.argtypes = [ctypes.c_void_p]
    L.bag_cloud_stamp.restype = ctypes.c_double
    L.bag_cloud_stamp.argtypes = [ctypes.c_void_p]
    L.bag_cloud_time_source.restype = ctypes.c_int
    L.bag_cloud_time_source.argtypes = [ctypes.c_void_p]
    L.bag_cloud_read.restype = ctypes.c_int
    L.bag_cloud_read.argtypes = [ctypes.c_void_p, fp, dp, fp, ip, ctypes.c_int]
    return L


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _uptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def esti_plane(pts: np.ndarray, threshold: float = 0.1):
    """Oracle plane fit. pts (N, 3) -> (coef (4,), valid)."""
    pts = np.ascontiguousarray(pts, np.float64)
    coef = np.zeros(4, np.float64)
    ok = lib().oracle_esti_plane(_dptr(pts), len(pts), threshold, _dptr(coef))
    return coef, bool(ok)


def knn(db: np.ndarray, q: np.ndarray, k: int, max_range: float = 1e9):
    """Oracle brute-force k-NN: db (M, 3), q (N, 3) -> (idx (N, k), d2 (N, k))."""
    db = np.ascontiguousarray(db, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    idx = np.zeros((len(q), k), np.int32)
    d2 = np.zeros((len(q), k), np.float64)
    lib().oracle_knn(_dptr(db), len(db), _dptr(q), len(q), k, max_range, _iptr(idx), _dptr(d2))
    return idx, d2


def icp_point_to_plane(target: np.ndarray, source: np.ndarray, iters: int = 30,
                       max_corr: float = 5.0, R0=None, t0=None):
    target = np.ascontiguousarray(target, np.float64)
    source = np.ascontiguousarray(source, np.float64)
    R = np.ascontiguousarray(R0 if R0 is not None else np.eye(3), np.float64)
    t = np.ascontiguousarray(t0 if t0 is not None else np.zeros(3), np.float64)
    ok = lib().oracle_icp_point_to_plane(
        _dptr(target), len(target), _dptr(source), len(source), iters, max_corr, _dptr(R), _dptr(t))
    return R, t, bool(ok)


def scan_to_map_replay(frames: np.ndarray, iters: int = 15, max_corr: float = 2.0,
                       map_leaf: float = 0.2, max_map: int = 50_000):
    """C++ reference odometry replay without the IMU: frames (F, N, 3)
    sensor-frame scans -> (R (F, 3, 3), t (F, 3))."""
    frames = np.ascontiguousarray(frames, np.float64)
    F, N, _ = frames.shape
    poses = np.zeros((F, 12), np.float64)
    done = lib().oracle_scan_to_map_replay(_dptr(frames), F, N, iters, max_corr, map_leaf, max_map, _dptr(poses))
    if done != F:
        raise RuntimeError(f"oracle replay stopped at frame {done}")
    return poses[:, :9].reshape(F, 3, 3), poses[:, 9:12]


def eigh3(a6: np.ndarray) -> np.ndarray:
    """Oracle eigenvalues (ascending) of the symmetric 3x3 matrix
    [a00 a01 a02 a11 a12 a22]."""
    a6 = np.ascontiguousarray(a6, np.float64)
    out = np.zeros(3, np.float64)
    lib().oracle_eigh3(_dptr(a6), _dptr(out))
    return out


def _frame_buffers(NP: int, NI: int):
    return {
        "pts": np.zeros((3, NP), np.float32),
        "pt_mask": np.zeros(NP, np.uint8),
        "t_offs": np.zeros(NP, np.float32),
        "imu_acc": np.zeros((NI, 3), np.float32),
        "imu_gyro": np.zeros((NI, 3), np.float32),
        "imu_dt": np.zeros(NI, np.float32),
        "imu_offs": np.zeros(NI, np.float32),
        "imu_mask": np.zeros(NI, np.uint8),
    }


def _frame_pointers(out):
    return (_fptr(out["pts"]), _uptr(out["pt_mask"]), _fptr(out["t_offs"]), _fptr(out["imu_acc"]),
            _fptr(out["imu_gyro"]), _fptr(out["imu_dt"]), _fptr(out["imu_offs"]), _uptr(out["imu_mask"]))


def _finish_frame(out, n):
    out["pt_mask"] = out["pt_mask"].astype(bool)
    out["imu_mask"] = out["imu_mask"].astype(bool)
    out["n_valid"] = n
    return out


class IngestShim:
    """Native frame assembler (the SyncPackages role, C++ side)."""

    def __init__(self, n_points: int, n_imu: int):
        self.n_points = n_points
        self.n_imu = n_imu
        self._L = lib()
        self._h = self._L.ingest_create(n_points, n_imu)

    def __del__(self):
        if getattr(self, "_h", None):
            self._L.ingest_destroy(self._h)
            self._h = None

    def push_imu(self, t: np.ndarray, acc: np.ndarray, gyro: np.ndarray):
        t = np.ascontiguousarray(t, np.float64)
        acc = np.ascontiguousarray(acc, np.float32)
        gyro = np.ascontiguousarray(gyro, np.float32)
        lib().ingest_push_imu(self._h, _dptr(t), _fptr(acc), _fptr(gyro), len(t))

    @property
    def pending_imu(self) -> int:
        return lib().ingest_pending_imu(self._h)

    def make_frame(self, xyz: np.ndarray, t_pts: np.ndarray, t0: float, t1: float,
                   blind: float = 0.1, filter_num: int = 1):
        """A dict of LIOFrame-shaped numpy arrays, or None if the IMU does not
        yet cover the scan (retry after more IMU pushes)."""
        xyz = np.ascontiguousarray(xyz, np.float32)
        t_pts = np.ascontiguousarray(t_pts, np.float64)
        out = _frame_buffers(self.n_points, self.n_imu)
        n = lib().ingest_make_frame(self._h, _fptr(xyz), _dptr(t_pts), len(xyz), t0, t1, blind, filter_num,
                                    *_frame_pointers(out))
        return None if n < 0 else _finish_frame(out, n)


class LiveDriverShim:
    """Native live-driver replay (the livox_ros_driver role): producer
    threads inside the C++ layer replay a preloaded dataset at (scaled)
    sensor cadence into the ingest assembler; `pop_frame` is the consumer
    end of the frame queue."""

    def __init__(self, n_points: int, n_imu: int, time_scale: float = 1.0,
                 blind: float = 0.1, filter_num: int = 1):
        self.n_points = n_points
        self.n_imu = n_imu
        self._L = lib()
        self._h = self._L.live_create(n_points, n_imu, time_scale, blind, filter_num)

    def __del__(self):
        if getattr(self, "_h", None):
            self._L.live_destroy(self._h)
            self._h = None

    def load_scan(self, xyz: np.ndarray, t_pts: np.ndarray, t0: float, t1: float):
        xyz = np.ascontiguousarray(xyz, np.float32)
        t_pts = np.ascontiguousarray(t_pts, np.float64)
        lib().live_load_scan(self._h, _fptr(xyz), _dptr(t_pts), len(xyz), t0, t1)

    def load_imu(self, t: np.ndarray, acc: np.ndarray, gyro: np.ndarray):
        t = np.ascontiguousarray(t, np.float64)
        acc = np.ascontiguousarray(acc, np.float32)
        gyro = np.ascontiguousarray(gyro, np.float32)
        lib().live_load_imu(self._h, _dptr(t), _fptr(acc), _fptr(gyro), len(t))

    def run(self):
        lib().live_run(self._h)

    @property
    def queue_depth(self) -> int:
        return lib().live_queue_depth(self._h)

    def pop_frame(self, timeout_ms: int = 1000):
        """Next assembled frame as LIOFrame-shaped numpy arrays; None on
        timeout; False when the replay is finished and drained."""
        out = _frame_buffers(self.n_points, self.n_imu)
        n = lib().live_pop_frame(self._h, *_frame_pointers(out), timeout_ms)
        if n == -1:
            return None
        if n == -2:
            return False
        return _finish_frame(out, n)


class NativeBagReader:
    """C++ bag reader (native/src/bagreader.cpp), the native replay input.

    Iterates the bag's Imu / PointCloud2 / CustomMsg messages in time order:

        with NativeBagReader(path) as bag:
            for kind, payload in bag:
                if kind == "imu":   t, acc, gyro = payload
                else:               stamp, xyz, t_abs, intensity, ring = payload

    Covers uncompressed and LZ4-compressed chunks; a bz2 bag raises
    ValueError (the pure-Python `io.rosbag` reader takes it)."""

    def __init__(self, path: str, lidar_topic: str = "", imu_topic: str = ""):
        self._L = lib()
        self._h = self._L.bag_open(path.encode(), lidar_topic.encode(), imu_topic.encode())
        if not self._h:
            raise ValueError(self._L.bag_last_error().decode())

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def close(self):
        if self._h:
            self._L.bag_close(self._h)
            self._h = None

    def __len__(self):
        return self._L.bag_num_messages(self._h)

    def __iter__(self):
        while True:
            kind = self._L.bag_next(self._h)
            if kind == 0:
                return
            if kind == -1:  # undecodable message: skipped, as rosbag::View skips foreign payloads
                continue
            if kind == 1:
                t, acc, gyro = np.zeros(1), np.zeros(3), np.zeros(3)
                self._L.bag_imu(self._h, _dptr(t), _dptr(acc), _dptr(gyro))
                yield "imu", (float(t[0]), acc, gyro)
            else:
                n = self._L.bag_cloud_size(self._h)
                stamp = self._L.bag_cloud_stamp(self._h)
                xyz = np.zeros((n, 3), np.float32)
                t_abs = np.zeros(n, np.float64)
                intensity = np.zeros(n, np.float32)
                ring = np.zeros(n, np.int32)
                got = self._L.bag_cloud_read(self._h, _fptr(xyz), _dptr(t_abs), _fptr(intensity), _iptr(ring), n)
                if got != n:
                    raise RuntimeError(f"bag reader returned {got} of {n} points")
                yield "cloud", (stamp, xyz, t_abs, intensity, ring)

    @property
    def cloud_time_source(self) -> int:
        """Per-point time provenance of the last cloud (0 ramp, 1 time[s],
        2 t[ns], 3 timestamp[abs s], 4 curvature[ms], 5 livox offset)."""
        return self._L.bag_cloud_time_source(self._h)
