"""IMU preintegration (Forster-style deltas) + failure detection (port of
`pointcloud_slam_tpu/models/lio/preintegration.py`).

Reference: `src/jueying_slam/src/imuPreintegration.cpp` — gtsam
`PreintegratedImuMeasurements` (:199-202) as one function producing the
preintegrated deltas (dR, dv, dp) with first-order bias Jacobians, and
`failureDetection` (:440-458).

The preintegrated delta is the measurement of a motion factor between two
states: r = [Log(dR(b)^T R_i^T R_j), R_i^T(v_j - v_i - g dt) - dv(b),
R_i^T(p_j - p_i - v_i dt - 0.5 g dt^2) - dp(b)] with dX(b) corrected to
first order in the bias deviation via the stored Jacobians.

`bias_corrected` and `residual` take leading batch dimensions (one factor
per row), which the pose-graph backend uses in place of the JAX package's
`vmap`. `preintegrate`'s `lax.scan` over the IMU samples is a loop over the
M samples; masked samples leave the deltas unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...geom import so3


class PreintegratedImu(NamedTuple):
    dR: torch.Tensor      # (..., 3, 3) rotation delta at the linearization bias
    dv: torch.Tensor      # (..., 3)
    dp: torch.Tensor      # (..., 3)
    dt: torch.Tensor      # (...) total time
    # first-order bias Jacobians
    dR_dbg: torch.Tensor  # (..., 3, 3) d Log(dR) / d bg
    dv_dbg: torch.Tensor  # (..., 3, 3)
    dv_dba: torch.Tensor  # (..., 3, 3)
    dp_dbg: torch.Tensor  # (..., 3, 3)
    dp_dba: torch.Tensor  # (..., 3, 3)
    bg0: torch.Tensor     # (..., 3) linearization gyro bias
    ba0: torch.Tensor     # (..., 3) linearization accel bias


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def preintegrate(imu_acc, imu_gyro, imu_dt, imu_mask, bg0, ba0) -> PreintegratedImu:
    """Integrate a frame's IMU samples into a relative-motion pseudo-measurement.

    imu_* are (M, 3)/(M,); masked samples are skipped. Gravity is NOT removed
    here (the factor residual subtracts g dt terms), the gtsam convention.
    """
    dtype, dev = imu_acc.dtype, imu_acc.device
    dR = torch.eye(3, dtype=dtype, device=dev)
    dv = torch.zeros(3, dtype=dtype, device=dev)
    dp = torch.zeros(3, dtype=dtype, device=dev)
    T = torch.zeros((), dtype=dtype, device=dev)
    dR_dbg, dv_dbg, dv_dba, dp_dbg, dp_dba = (torch.zeros((3, 3), dtype=dtype, device=dev) for _ in range(5))
    for acc, gyro, dt, m in zip(imu_acc, imu_gyro, imu_dt, imu_mask):
        a = acc - ba0
        w = gyro - bg0
        dRk = so3.exp(w * dt)
        Jr = so3.A_matrix(-w * dt)  # right Jacobian of Exp(w dt)
        Ra = _mv(dR, a)
        dRhat = dR @ so3.hat(a)
        dp_n = dp + dv * dt + 0.5 * Ra * dt * dt
        dv_n = dv + Ra * dt
        # bias Jacobians (standard preintegration recursions)
        dp_dba_n = dp_dba + dv_dba * dt - 0.5 * dR * dt * dt
        dp_dbg_n = dp_dbg + dv_dbg * dt - 0.5 * dRhat @ dR_dbg * dt * dt
        dv_dba_n = dv_dba - dR * dt
        dv_dbg_n = dv_dbg - dRhat @ dR_dbg * dt
        dR_dbg_n = dRk.T @ dR_dbg - Jr * dt
        dR_n = dR @ dRk
        dR, dv, dp = torch.where(m, dR_n, dR), torch.where(m, dv_n, dv), torch.where(m, dp_n, dp)
        T = T + torch.where(m, dt, 0.0)
        dR_dbg, dv_dbg = torch.where(m, dR_dbg_n, dR_dbg), torch.where(m, dv_dbg_n, dv_dbg)
        dv_dba, dp_dbg = torch.where(m, dv_dba_n, dv_dba), torch.where(m, dp_dbg_n, dp_dbg)
        dp_dba = torch.where(m, dp_dba_n, dp_dba)
    return PreintegratedImu(dR, dv, dp, T, dR_dbg, dv_dbg, dv_dba, dp_dbg, dp_dba, bg0, ba0)


def bias_corrected(pim: PreintegratedImu, bg, ba):
    """First-order bias-corrected deltas (gtsam biasCorrectedDelta)."""
    dbg = bg - pim.bg0
    dba = ba - pim.ba0
    dR = pim.dR @ so3.exp(_mv(pim.dR_dbg, dbg))
    dv = pim.dv + _mv(pim.dv_dbg, dbg) + _mv(pim.dv_dba, dba)
    dp = pim.dp + _mv(pim.dp_dbg, dbg) + _mv(pim.dp_dba, dba)
    return dR, dv, dp


def residual(pim: PreintegratedImu, Ri, pi, vi, Rj, pj, vj, bg, ba, grav):
    """9-dim IMU factor residual between states i and j (gtsam ImuFactor)."""
    dR, dv, dp = bias_corrected(pim, bg, ba)
    T = pim.dt[..., None]
    RiT = Ri.transpose(-1, -2)
    er = so3.log(dR.transpose(-1, -2) @ (RiT @ Rj))
    ev = _mv(RiT, vj - vi - grav * T) - dv
    ep = _mv(RiT, pj - pi - vi * T - 0.5 * grav * T * T) - dp
    return torch.cat([er, ev, ep], dim=-1)


def failure_detection(vel, bg, ba, vel_limit: float = 30.0, bias_limit: float = 1.0):
    """Divergence gate (imuPreintegration.cpp:440-458): large velocity or bias
    means the optimization diverged -> caller should reset."""
    return ((torch.linalg.norm(vel) > vel_limit) | (torch.linalg.norm(bg) > bias_limit)
            | (torch.linalg.norm(ba) > bias_limit))
