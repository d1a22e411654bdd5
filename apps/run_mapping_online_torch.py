#!/usr/bin/env python
"""Online LIO mapping loop on the PyTorch/CUDA port: streaming sensor events
-> poses in real time. The counterpart of `apps/run_mapping_online.py`
(reference `run_mapping_online.cc:18-50`, the callback/sync layer
`laser_mapping.cc:391-518`), same flags, with `--device` in place of
`--platform`.

The native C++ ingest shim (`native/src/ingest.cpp`, loaded by the port's
`native` module) plays the buffer/sync role: IMU samples stream into its
ring buffer; once IMU covers a scan's interval, a fixed-shape frame is
assembled and goes through the port's `lio_step` on the device. Poses
stream to the caller, which reads each one back (the /Odometry topic role):
that is the one device -> host read a frame. A synthetic stream is built in.

    python apps/run_mapping_online_torch.py --frames 20                # on the GPU
    python apps/run_mapping_online_torch.py --frames 8 --device cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


class OnlineMapper:
    """The LaserMapping-node role: buffers -> frames -> the LIO step."""

    def __init__(self, cfg=None, n_points=4096, n_imu=64, blind=0.3, filter_num=1, device="cuda"):
        from pointcloud_slam_tpu_torch import native
        from pointcloud_slam_tpu_torch.models import lio

        self.lio = lio
        self.device = device
        self.cfg = cfg or lio.LIOConfig()
        self.state = lio.create_state(self.cfg, device=device)
        self.shim = native.IngestShim(n_points, n_imu)
        self.blind = blind
        self.filter_num = filter_num
        self._pending_scan = None  # (xyz, t_pts, t0, t1)
        self.n_frames = 0

    def push_imu(self, t, acc, gyro):
        self.shim.push_imu(np.atleast_1d(t), np.atleast_2d(acc), np.atleast_2d(gyro))
        return self._try_process()

    def push_scan(self, xyz, t_pts, t0, t1):
        """Queue a scan; processed once IMU covers [t0, t1] (SyncPackages gate)."""
        self._pending_scan = (xyz, t_pts, t0, t1)
        return self._try_process()

    def reset(self):
        """jueying_lio/reset topic semantics: fresh filter + map + IMU init."""
        self.state = self.lio.reset(self.cfg, device=self.device)
        self._pending_scan = None

    def assemble(self):
        """The pending scan as a LIOFrame on the device, or None while the IMU
        does not cover it yet."""
        xyz, t_pts, t0, t1 = self._pending_scan
        raw = self.shim.make_frame(xyz, t_pts, t0, t1, blind=self.blind, filter_num=self.filter_num)
        if raw is None:
            return None
        import torch

        return self.lio.LIOFrame(*(torch.from_numpy(raw[f]).to(self.device) for f in self.lio.LIOFrame._fields))

    def _try_process(self):
        if self._pending_scan is None:
            return None
        frame = self.assemble()
        if frame is None:
            return None  # IMU not caught up yet
        self._pending_scan = None
        self.state, out = self.lio.lio_step(self.cfg, self.state, frame)
        self.n_frames += 1
        return out


def synthetic_stream(n_frames, imu_per_frame=20, frame_dt=0.1, n_pts=2048):
    """Interleaved (imu | scan) events from the synthetic trajectory (the JAX
    app's stream: the same seeds give the same events)."""
    from pointcloud_slam_tpu_torch.io import synthetic

    world = synthetic.make_room_cloud(30000, seed=0)
    traj = synthetic.make_imu_trajectory(n_frames, imu_per_frame, frame_dt, seed=0)
    rng = np.random.default_rng(0)
    for f in range(n_frames):
        i0, i1 = f * imu_per_frame, (f + 1) * imu_per_frame
        for i in range(i0, i1):
            yield ("imu", traj["t"][i + 1], traj["acc"][i], traj["gyro"][i])
        pos, R = traj["pos"][i1], traj["R"][i1]
        rel = (world - pos) @ R
        r = np.linalg.norm(rel, axis=1)
        vis = rel[(r < 25.0) & (r > 0.5)]
        idx = rng.choice(len(vis), min(n_pts, len(vis)), replace=False)
        pts = vis[idx].astype(np.float32)
        t1 = traj["t"][i1]
        yield ("scan", pts, np.full(len(pts), t1), traj["t"][i0], t1)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--n_points", type=int, default=2048)
    p.add_argument("--traj_log_file", default="", help="also write the streamed poses here (TUM)")
    p.add_argument("--device", default="cuda", help="torch device the frame step runs on")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    from pointcloud_slam_tpu_torch.utils import checkpoint as ck

    mapper = OnlineMapper(n_points=args.n_points, n_imu=32, device=args.device)
    stamps, rows = [], []
    t_start = time.perf_counter()
    for ev in synthetic_stream(args.frames, n_pts=args.n_points):
        if ev[0] == "imu":
            _, t, acc, gyro = ev
            out = mapper.push_imu(t, acc, gyro)
        else:
            _, pts, t_pts, t0, t1 = ev
            stamp = t1
            out = mapper.push_scan(pts, t_pts, t0, t1)
        if out is not None:
            # the pose streams out: one read back a frame (position, rotation, effective count)
            row = torch.cat([out.pos, out.rot.reshape(-1), out.num_effective.to(out.pos.dtype).reshape(1)]).cpu().numpy()
            pos = row[:3]
            stamps.append(stamp)
            rows.append(row)
            print(f"frame {mapper.n_frames:4d}  pos [{pos[0]:+.3f} {pos[1]:+.3f} {pos[2]:+.3f}]  "
                  f"eff {int(row[12]):5d}")
    wall = time.perf_counter() - t_start
    print(f"{mapper.n_frames} frames in {wall:.2f}s ({mapper.n_frames / max(wall, 1e-9):.1f} fps incl. warm-up)")
    if args.traj_log_file:
        rows = np.array(rows).reshape(-1, 13)
        quats = [ck._quat_from_R(r[3:12].reshape(3, 3)) for r in rows]
        ck.save_trajectory_tum(args.traj_log_file, stamps, rows[:, :3], quats)
        print(f"trajectory -> {args.traj_log_file}")


if __name__ == "__main__":
    main()
