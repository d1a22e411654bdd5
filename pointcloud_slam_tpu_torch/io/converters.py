"""Point-cloud format converters (the L1 normalization layer, host-side numpy;
a copy of `pointcloud_slam_tpu/io/converters.py` whose ring/yaw time
synthesis comes from the port's `models/lio/preprocess.py`).

Behavioral parity targets:
  - `src/tool/livox_repub/src/livox_repub.cpp:13-58`: Livox CustomMsg ->
    XYZINormal with line+reflectivity packed into intensity and relative time
    in curvature,
  - `src/tool/rs_to_velodyne/src/rs_to_velodyne.cpp:12-212`: Robosense ->
    Velodyne XYZIRT with the RING_ID_MAP_RUBY / RING_ID_MAP_16 remaps and NaN
    filtering,
  - `src/tool/hesai_to_velodyne/src/hesai_to_velodyne.cpp`: Hesai XYZIRT ->
    Velodyne XYZIRT (ring remap + time rebase).

All converters take/return plain numpy dicts with keys x, y, z, intensity,
ring, time — the unified XYZIRT contract consumed by the pipelines."""

from __future__ import annotations

from typing import Dict

import numpy as np

# Robosense Ruby (128) -> Velodyne ring remap (rs_to_velodyne.cpp:12)
RING_ID_MAP_RUBY = np.array(
    [3, 66, 33, 96, 11, 74, 41, 104, 19, 82, 49, 112, 27, 90, 57, 120, 35, 98, 1, 64, 43, 106, 9, 72,
     51, 114, 17, 80, 59, 122, 25, 88, 67, 34, 97, 0, 75, 42, 105, 8, 83, 50, 113, 16, 91, 58, 121, 24,
     99, 2, 65, 32, 107, 10, 73, 40, 115, 18, 81, 48, 123, 26, 89, 56, 7, 70, 37, 100, 15, 78, 45, 108,
     23, 86, 53, 116, 31, 94, 61, 124, 39, 102, 5, 68, 47, 110, 13, 76, 55, 118, 21, 84, 63, 126, 29, 92,
     71, 38, 101, 4, 79, 46, 109, 12, 87, 54, 117, 20, 95, 62, 125, 28, 103, 6, 69, 36, 111, 14, 77, 44,
     119, 22, 85, 52, 127, 30, 93, 60], np.int32)

# Robosense 16 -> Velodyne ring remap (rs_to_velodyne.cpp:14)
RING_ID_MAP_16 = np.array([0, 1, 2, 3, 4, 5, 6, 7, 15, 14, 13, 12, 11, 10, 9, 8], np.int32)


def livox_custom_to_xyzirt(x, y, z, reflectivity, line, offset_time_ns) -> Dict[str, np.ndarray]:
    """Livox CustomMsg fields -> unified XYZIRT.

    intensity = line + reflectivity/10000 (livox_repub.cpp:31-33); time in
    seconds relative to the scan start."""
    intensity = line.astype(np.float32) + reflectivity.astype(np.float32) / 10000.0
    return {
        "x": np.asarray(x, np.float32),
        "y": np.asarray(y, np.float32),
        "z": np.asarray(z, np.float32),
        "intensity": intensity,
        "ring": line.astype(np.int32),
        "time": (np.asarray(offset_time_ns, np.float64) * 1e-9).astype(np.float32),
    }


def rs_to_velodyne(cloud: Dict[str, np.ndarray], n_rings: int = 16) -> Dict[str, np.ndarray]:
    """Robosense XYZIRT -> Velodyne XYZIRT: NaN drop, ring remap, time rebase
    (rs_to_velodyne.cpp handler paths)."""
    ok = np.isfinite(cloud["x"]) & np.isfinite(cloud["y"]) & np.isfinite(cloud["z"])
    remap = RING_ID_MAP_RUBY if n_rings == 128 else RING_ID_MAP_16
    ring = remap[np.clip(cloud["ring"][ok].astype(np.int32), 0, len(remap) - 1)]
    t = cloud["time"][ok]
    t = t - (t[0] if len(t) else 0.0)
    return {
        "x": cloud["x"][ok], "y": cloud["y"][ok], "z": cloud["z"][ok],
        "intensity": cloud["intensity"][ok].astype(np.float32),
        "ring": ring, "time": t.astype(np.float32),
    }


def hesai_to_velodyne(cloud: Dict[str, np.ndarray], flip_rings: bool = True) -> Dict[str, np.ndarray]:
    """Hesai XYZIRT -> Velodyne convention: ring order flipped top/bottom,
    absolute stamps rebased to scan start (hesai_to_velodyne.cpp)."""
    ok = np.isfinite(cloud["x"]) & np.isfinite(cloud["y"]) & np.isfinite(cloud["z"])
    ring = cloud["ring"][ok].astype(np.int32)
    if flip_rings and len(ring):
        ring = ring.max() - ring
    t = cloud["time"][ok].astype(np.float64)
    t = (t - (t.min() if len(t) else 0.0)).astype(np.float32)
    return {
        "x": cloud["x"][ok], "y": cloud["y"][ok], "z": cloud["z"][ok],
        "intensity": cloud["intensity"][ok].astype(np.float32),
        "ring": ring, "time": t,
    }


def ouster64_to_xyzirt(cloud: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Ouster OS ring-format cloud -> unified XYZIRT.

    Parity: Oust64Handler (src/jueying_lio/src/pointcloud_preprocess.cc:120-150):
    the ouster_ros::Point `t` field is NANOSECONDS from scan start (the
    reference stores t/1e6 ms into curvature); here time is seconds."""
    ok = np.isfinite(cloud["x"]) & np.isfinite(cloud["y"]) & np.isfinite(cloud["z"])
    t_ns = np.asarray(cloud.get("t", cloud.get("time", np.zeros_like(cloud["x"]))), np.float64)
    ring = np.asarray(cloud.get("ring", np.zeros(len(cloud["x"]), np.int32)), np.int32)
    return {
        "x": np.asarray(cloud["x"], np.float32)[ok],
        "y": np.asarray(cloud["y"], np.float32)[ok],
        "z": np.asarray(cloud["z"], np.float32)[ok],
        "intensity": np.asarray(cloud.get("intensity", np.zeros_like(cloud["x"])), np.float32)[ok],
        "ring": ring[ok],
        "time": (t_ns[ok] * 1e-9).astype(np.float32),
    }


def livox_pc2_to_xyzirt(cloud: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Livox PointCloud2 (livox_ros::Point with absolute per-point `timestamp`)
    -> unified XYZIRT.

    Parity: LivoxHandler (src/jueying_lio/src/pointcloud_preprocess.cc:89-118):
    time = (timestamp - timestamp[0]) rebased to scan start; here seconds."""
    ok = np.isfinite(cloud["x"]) & np.isfinite(cloud["y"]) & np.isfinite(cloud["z"])
    ts = np.asarray(cloud.get("timestamp", cloud.get("time", np.zeros_like(cloud["x"]))), np.float64)[ok]
    t = (ts - (ts[0] if len(ts) else 0.0)).astype(np.float32)
    line = np.asarray(cloud.get("line", cloud.get("ring", np.zeros(len(cloud["x"]), np.int32))), np.int32)
    return {
        "x": np.asarray(cloud["x"], np.float32)[ok],
        "y": np.asarray(cloud["y"], np.float32)[ok],
        "z": np.asarray(cloud["z"], np.float32)[ok],
        "intensity": np.asarray(cloud.get("intensity", np.zeros_like(cloud["x"])), np.float32)[ok],
        "ring": line[ok],
        "time": t,
    }


def point_times_from_cloud(cloud: Dict[str, np.ndarray], scan_duration: float = 0.1,
                           scan_rate_hz: float = 10.0) -> np.ndarray:
    """Best-available per-point time offsets [s] for deskewing.

    Priority mirrors the reference's handler fallbacks
    (pointcloud_preprocess.cc:150-305): explicit per-point times if present
    (`time` s, `t` ns, `timestamp` absolute s, `curvature` ms), else ring/yaw
    synthesis (VelodyneHandler's omega path), else a LINEAR ramp over the scan
    duration (spinning-lidar approximation) — never a constant."""
    n = len(cloud["x"])
    if "time" in cloud and np.ptp(cloud["time"]) > 0:
        t = np.asarray(cloud["time"], np.float64)
        return (t - t.min()).astype(np.float32)
    if "t" in cloud and np.ptp(cloud["t"]) > 0:
        t = np.asarray(cloud["t"], np.float64) * 1e-9
        return (t - t.min()).astype(np.float32)
    if "timestamp" in cloud and np.ptp(cloud["timestamp"]) > 0:
        t = np.asarray(cloud["timestamp"], np.float64)
        return (t - t.min()).astype(np.float32)
    if "curvature" in cloud and np.ptp(cloud["curvature"]) > 0:
        return (np.asarray(cloud["curvature"], np.float64) * 1e-3).astype(np.float32)
    if "ring" in cloud:
        from ..models.lio.preprocess import synthesize_velodyne_times

        xyz = np.stack([cloud["x"], cloud["y"], cloud["z"]], axis=1)
        return synthesize_velodyne_times(xyz, np.asarray(cloud["ring"], np.int32), scan_rate_hz)
    return np.linspace(0.0, scan_duration, n, endpoint=False).astype(np.float32)


# pitch -> synthetic ring table for fused depth-camera points: 52 entries
# indexed by round(pitch_deg + 40), covering [-40, 12) degrees
# (integrate_points fusion_lidar_camera.cpp:50 RING_MAP_16, used :237-254)
RING_MAP_FUSION = np.array(
    [47, 46, 45, 44, 43, 42, 41, 40, 39, 38, 37, 36, 35, 34, 33, 32,
     31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17, 16,
     0, 1, 2, 3, 4, 5, 6, 7, 15, 14, 13, 12, 11, 10, 9, 8, 48, 49, 50, 51],
    np.int32,
)


def depth_camera_to_velodyne(
    cloud: Dict[str, np.ndarray],
    extrinsic_T: np.ndarray,
    depth_filter: float = -1.0,
    stamp: float = 0.0,
) -> Dict[str, np.ndarray]:
    """One depth camera cloud -> lidar-frame XYZIRT points for fusion.

    Mirrors `handle_pc_msg` in integrate_points/src/fusion_lidar_camera.cpp:215-270:
    NaN drop, the depth gate (camera-frame z > depth_filter dropped when the
    filter is enabled i.e. >= 0), a 4x4 column-major extrinsic transform, a
    synthetic ring from the lidar-frame pitch angle via RING_MAP_FUSION, a
    constant per-cloud timestamp, intensity pinned to 100."""
    x = np.asarray(cloud["x"], np.float64)
    y = np.asarray(cloud["y"], np.float64)
    z = np.asarray(cloud["z"], np.float64)
    keep = np.isfinite(x) & np.isfinite(y) & np.isfinite(z)
    if depth_filter >= 0:
        keep &= ~(z > depth_filter)
    x, y, z = x[keep], y[keep], z[keep]
    T = np.asarray(extrinsic_T, np.float64).reshape(4, 4)
    # the reference indexes a flat 16-vector column-major (camera_T[0], [4],
    # [8], [12] form the output-x row): row-vector convention p' = p @ T3 + t
    nx = x * T[0, 0] + y * T[1, 0] + z * T[2, 0] + T[3, 0]
    ny = x * T[0, 1] + y * T[1, 1] + z * T[2, 1] + T[3, 1]
    nz = x * T[0, 2] + y * T[1, 2] + z * T[2, 2] + T[3, 2]
    dist = np.maximum(np.sqrt(nx * nx + ny * ny + nz * nz), 1e-12)
    pitch = np.arcsin(np.clip(nz / dist, -1.0, 1.0)) * (180.0 / np.pi)
    ring = np.full(len(nx), 51, np.int32)
    in_band = (pitch >= -40.0) & (pitch < 12.0)
    idx = np.clip(np.round(pitch + 40.0).astype(np.int64), 0, len(RING_MAP_FUSION) - 1)
    ring = np.where(in_band, RING_MAP_FUSION[idx], np.where(pitch < -40.0, 47, 51)).astype(np.int32)
    return {
        "x": nx.astype(np.float32),
        "y": ny.astype(np.float32),
        "z": nz.astype(np.float32),
        "intensity": np.full(len(nx), 100.0, np.float32),
        "ring": ring,
        "time": np.full(len(nx), stamp, np.float32),
    }


class ApproximateTimeSync:
    """Host-side N-stream approximate-time synchronizer — the
    message_filters::sync_policies::ApproximateTime role that drives
    integrate_points (fusion_lidar_camera.cpp:12-14, main's Synchronizer).

    Streams buffer (stamp, payload) messages; `add` returns one matched tuple
    (payload_0, ..., payload_{n-1}) whenever every stream holds a message
    within `slop` seconds of the pivot (the newest head), consuming them."""

    def __init__(self, n_streams: int, slop: float = 0.05, queue_size: int = 10):
        self.n = n_streams
        self.slop = slop
        self.queue_size = queue_size
        self.queues = [[] for _ in range(n_streams)]

    def add(self, stream: int, stamp: float, payload):
        q = self.queues[stream]
        q.append((float(stamp), payload))
        if len(q) > self.queue_size:
            q.pop(0)
        return self._try_match()

    def _try_match(self):
        if any(not q for q in self.queues):
            return None
        pivot = max(q[-1][0] for q in self.queues)
        picks = []
        for q in self.queues:
            j = int(np.argmin([abs(t - pivot) for t, _ in q]))
            if abs(q[j][0] - pivot) > self.slop:
                return None
            picks.append(j)
        out = tuple(self.queues[i][j][1] for i, j in enumerate(picks))
        for i, j in enumerate(picks):
            del self.queues[i][: j + 1]
        return out


def fuse_lidar_cameras(
    lidar: Dict[str, np.ndarray],
    camera_clouds,
    camera_T,
    depth_filter: float = -1.0,
    stamp: float = 0.0,
) -> Dict[str, np.ndarray]:
    """Full integrate_points fusion: lidar cloud + N depth-camera clouds with
    per-camera extrinsics/depth gating -> one XYZIRT cloud
    (fusion_lidar_camera.cpp callback :280-340)."""
    parts = [lidar]
    for cloud, T in zip(camera_clouds, camera_T):
        parts.append(depth_camera_to_velodyne(cloud, T, depth_filter=depth_filter, stamp=stamp))
    return merge_clouds(parts)


def merge_clouds(clouds, extrinsics=None) -> Dict[str, np.ndarray]:
    """Multi-sensor fusion: concatenate clouds after per-sensor extrinsic
    transforms (integrate_points fusion_lidar_camera role)."""
    outs = {k: [] for k in ("x", "y", "z", "intensity", "ring", "time")}
    for i, c in enumerate(clouds):
        x, y, z = c["x"], c["y"], c["z"]
        if extrinsics is not None:
            R, t = extrinsics[i]
            p = np.stack([x, y, z], 1) @ np.asarray(R).T + np.asarray(t)
            x, y, z = p[:, 0], p[:, 1], p[:, 2]
        outs["x"].append(x)
        outs["y"].append(y)
        outs["z"].append(z)
        outs["intensity"].append(c.get("intensity", np.zeros_like(x)))
        outs["ring"].append(c.get("ring", np.zeros(len(x), np.int32)))
        outs["time"].append(c.get("time", np.zeros_like(x)))
    return {k: np.concatenate(v) for k, v in outs.items()}
