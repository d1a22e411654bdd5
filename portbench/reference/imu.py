"""IMU initialization, forward propagation, and per-point motion compensation
(port of `pointcloud_slam_tpu/models/lio/imu.py`; reference
imu_processing.hpp `IMUInit` / `UndistortPcl`).

`propagate` is the parallel-in-time form: within one frame the biases and
gravity are constant, so the rotation chain is a prefix product of 3x3
matrices and the covariance recursion is an affine map in P; both run as
log-depth Hillis-Steele scans over the frame's (<= 64) IMU samples.
`propagate_sequential` is the per-sample predict chain, kept as the oracle.

Frozen copy, for the benchmark's plain reference, of
`pointcloud_slam_tpu_torch/models/lio/imu.py` at commit 9c22c1c.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import eskf
from . import lio_state as st
from . import s2, so3


class PoseTable(NamedTuple):
    """Per-IMU-sample states for backward compensation. M+1 entries
    (entry 0 = frame-start state, IMUpose_ in the reference)."""

    offs: torch.Tensor   # (M+1,) time offset from scan start [s]
    R: torch.Tensor      # (M+1, 9) row-major world<-IMU rotation
    pos: torch.Tensor    # (M+1, 3)
    vel: torch.Tensor    # (M+1, 3)
    acc: torch.Tensor    # (M+1, 3) world-frame acceleration incl. gravity
    gyro: torch.Tensor   # (M+1, 3) unbiased body angular rate


def _inclusive_scan(combine: Callable, elems):
    """Hillis-Steele inclusive scan along dim 0 of a tuple of tensors;
    `combine(earlier, later)` must be associative."""
    n = elems[0].shape[0]
    d = 1
    while d < n:
        head = tuple(e[:d] for e in elems)
        tail = combine(tuple(e[:-d] for e in elems), tuple(e[d:] for e in elems))
        elems = tuple(torch.cat([h, t], dim=0) for h, t in zip(head, tail))
        d *= 2
    return elems



def propagate(x, P, Q, imu_acc, imu_gyro, imu_dt, imu_offs, imu_mask, acc_scale, prev_acc_w, prev_gyro):
    """Forward-propagate through the frame's IMU samples (masked), collecting
    the pose table. imu_* are (M, 3)/(M,). Returns (x_end, P_end, table).

    Masked samples contribute neutral elements (Exp = I, dt = 0, A = I,
    B = 0), which reproduces the sequential where-freeze for any mask."""
    dtype, dev = P.dtype, P.device
    M = imu_acc.shape[0]
    dt = imu_dt * imu_mask.to(dtype)                       # (M,) masked
    acc_b = imu_acc * acc_scale - x.ba[None, :]            # (M, 3)
    omega = imu_gyro - x.bg[None, :]                       # (M, 3)
    seg = omega * dt[:, None]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    keep = imu_mask[:, None, None]
    E = torch.where(keep, so3.exp(seg), eye3)

    # rotation prefix products: R_i = x.rot @ (E_1 ... E_i)
    (prefix,) = _inclusive_scan(lambda a, b: (a[0] @ b[0],), (E,))
    R_i = x.rot[None] @ prefix                             # (M, 3, 3) updated rots
    R_im1 = torch.cat([x.rot[None], R_i[:-1]], dim=0)      # OLD-state rots

    # velocity / position cumsums (OLD-state convention, see eskf.predict)
    a_world = (R_im1 @ acc_b[:, :, None])[:, :, 0] + x.grav[None, :]
    v_i = x.vel[None, :] + torch.cumsum(a_world * dt[:, None], dim=0)
    v_im1 = torch.cat([x.vel[None], v_i[:-1]], dim=0)
    p_i = x.pos[None, :] + torch.cumsum(v_im1 * dt[:, None], dim=0)

    acc_w = (R_i @ acc_b[:, :, None])[:, :, 0] + x.grav[None, :]

    x_end = st.NavState(
        pos=p_i[-1], rot=R_i[-1], ext_R=x.ext_R, ext_t=x.ext_t,
        vel=v_i[-1], bg=x.bg, ba=x.ba, grav=x.grav,
    )

    # covariance: batched Fx/Fw blocks (eskf.predict's error-state
    # transition for all samples at once), then one affine scan
    Mx = s2.mx(x.grav, torch.zeros(2, dtype=dtype, device=dev))  # constant in-frame
    A_rot = so3.A_matrix(-seg)                             # (M, 3, 3)
    dtm = dt[:, None, None]
    A = torch.eye(st.DOF, dtype=dtype, device=dev).repeat(M, 1, 1)
    A[:, st.POS:st.POS + 3, st.VEL:st.VEL + 3] = eye3 * dtm
    A[:, st.ROT:st.ROT + 3, st.ROT:st.ROT + 3] = so3.exp(-seg)
    A[:, st.ROT:st.ROT + 3, st.BG:st.BG + 3] = -dtm * A_rot
    A[:, st.VEL:st.VEL + 3, st.ROT:st.ROT + 3] = -dtm * R_im1 @ so3.hat(acc_b)
    A[:, st.VEL:st.VEL + 3, st.BA:st.BA + 3] = -dtm * R_im1
    A[:, st.VEL:st.VEL + 3, st.GRAV:st.GRAV + 2] = dtm * Mx
    Fw = torch.zeros((M, st.DOF, 12), dtype=dtype, device=dev)
    Fw[:, st.ROT:st.ROT + 3, 0:3] = -dtm * A_rot
    Fw[:, st.VEL:st.VEL + 3, 3:6] = -dtm * R_im1
    Fw[:, st.BG:st.BG + 3, 6:9] = dtm * eye3
    Fw[:, st.BA:st.BA + 3, 9:12] = dtm * eye3
    B = Fw @ Q @ Fw.transpose(-1, -2)
    A = torch.where(keep, A, torch.eye(st.DOF, dtype=dtype, device=dev))
    B = torch.where(keep, B, torch.zeros_like(B))

    def combine(a, b):
        Aa, Ba = a
        Ab, Bb = b
        return Ab @ Aa, Ab @ Ba @ Ab.transpose(-1, -2) + Bb

    Ap, Bp = _inclusive_scan(combine, (A, B))
    P_end = Ap[-1] @ P @ Ap[-1].T + Bp[-1]
    P_end = 0.5 * (P_end + P_end.T)

    table = PoseTable(
        offs=torch.cat([torch.zeros(1, dtype=dtype, device=dev), imu_offs]),
        R=torch.cat([x.rot.reshape(1, 9), R_i.reshape(M, 9)]),
        pos=torch.cat([x.pos[None], p_i]),
        vel=torch.cat([x.vel[None], v_i]),
        acc=torch.cat([prev_acc_w[None], acc_w]),
        gyro=torch.cat([prev_gyro[None], omega]),
    )
    return x_end, P_end, table


def _rodrigues_apply(wx, wy, wz, px, py, pz):
    """(Exp([wx,wy,wz]) @ p) with component tensors (N,) — no (N,3,3) tensors."""
    t2 = wx * wx + wy * wy + wz * wz
    t = torch.sqrt(torch.clamp(t2, min=1e-16))
    small = t2 < 1e-8
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2)
    # p' = p + a (w x p) + b (w x (w x p))
    c1x = wy * pz - wz * py
    c1y = wz * px - wx * pz
    c1z = wx * py - wy * px
    c2x = wy * c1z - wz * c1y
    c2y = wz * c1x - wx * c1z
    c2z = wx * c1y - wy * c1x
    return px + a * c1x + b * c2x, py + a * c1y + b * c2y, pz + a * c1z + b * c2z


def undistort(points, t_offs, mask, table: PoseTable, x_end: st.NavState):
    """Motion-compensate every point to the scan-end pose. points (3, N) in
    the LIDAR frame, t_offs (N,) seconds from scan start (any order).

    Returns compensated points (3, N) in the lidar frame at scan end."""
    M1 = table.offs.shape[0]
    # interval search by broadcast-compare against the ~20-entry pose table
    idx = torch.clamp(torch.sum(t_offs[None, :] >= table.offs[:, None], dim=0) - 1, 0, M1 - 1)
    tail = torch.clamp(idx + 1, max=M1 - 1)
    head_tbl = torch.cat([table.R.T, table.pos.T, table.vel.T, table.offs[None, :]], dim=0)  # (16, M+1)
    tail_tbl = torch.cat([table.acc.T, table.gyro.T], dim=0)                              # (6, M+1)
    hg = head_tbl[:, idx]   # (16, N)
    tg = tail_tbl[:, tail]  # (6, N)
    dt = t_offs - hg[15]

    # lidar -> IMU frame
    eR, et = x_end.ext_R, x_end.ext_t
    px = eR[0, 0] * points[0] + eR[0, 1] * points[1] + eR[0, 2] * points[2] + et[0]
    py = eR[1, 0] * points[0] + eR[1, 1] * points[1] + eR[1, 2] * points[2] + et[1]
    pz = eR[2, 0] * points[0] + eR[2, 1] * points[1] + eR[2, 2] * points[2] + et[2]

    # R_i = R_head Exp(gyro_tail dt): apply Exp first, then R_head
    px, py, pz = _rodrigues_apply(tg[3] * dt, tg[4] * dt, tg[5] * dt, px, py, pz)
    qx = hg[0] * px + hg[1] * py + hg[2] * pz
    qy = hg[3] * px + hg[4] * py + hg[5] * pz
    qz = hg[6] * px + hg[7] * py + hg[8] * pz

    # + T_ei (world), relative to scan-end position
    qx = qx + hg[9] + hg[12] * dt + 0.5 * tg[0] * dt * dt - x_end.pos[0]
    qy = qy + hg[10] + hg[13] * dt + 0.5 * tg[1] * dt * dt - x_end.pos[1]
    qz = qz + hg[11] + hg[14] * dt + 0.5 * tg[2] * dt * dt - x_end.pos[2]

    # world -> scan-end IMU -> lidar frame
    Re = x_end.rot
    ux = Re[0, 0] * qx + Re[1, 0] * qy + Re[2, 0] * qz
    uy = Re[0, 1] * qx + Re[1, 1] * qy + Re[2, 1] * qz
    uz = Re[0, 2] * qx + Re[1, 2] * qy + Re[2, 2] * qz
    vx = ux - et[0]
    vy = uy - et[1]
    vz = uz - et[2]
    ox = eR[0, 0] * vx + eR[1, 0] * vy + eR[2, 0] * vz
    oy = eR[0, 1] * vx + eR[1, 1] * vy + eR[2, 1] * vz
    oz = eR[0, 2] * vx + eR[1, 2] * vy + eR[2, 2] * vz
    out = torch.stack([ox, oy, oz], dim=0)
    return torch.where(mask[None, :], out, points)


def init_from_measurements(mean_acc, mean_gyro, gravity: float = s2.GRAVITY):
    """Gravity / gyro-bias / accel-scale from averaged static measurements
    (imu_processing.hpp:113-163)."""
    norm = torch.clamp(torch.linalg.norm(mean_acc), min=1e-6)
    grav = -mean_acc / norm * gravity
    acc_scale = gravity / norm
    return grav, mean_gyro, acc_scale
