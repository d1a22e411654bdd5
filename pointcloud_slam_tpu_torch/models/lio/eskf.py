"""Iterated error-state Kalman filter on the 23-DoF manifold
(port of `pointcloud_slam_tpu/models/lio/eskf.py`; reference esekfom.hpp
`predict` and `update_iterated_dyn_share_modified`).

The iterated update keeps the JAX package's fixed `max_iter` loop with
`done`-masking, so with `research=False` it reads nothing back from the
device. With `research=True` the re-search decision depends on a device
value (the previous iteration's convergence); the loop reads it once per
iteration after the first (`UpdateResult.host_syncs` counts the reads) and
stops as soon as the update is done — the masked iterations after that
change nothing. The iterations run and the searches among them are counted
in the open frame (`Timer.count`, `lio_step.iterations` and
`lio_step.searches`).

The update's 23x23 algebra (the two inverses of the information form and
the covariance it leaves) runs in float64, as the reference's esekfom does
in double: P spans ~8 decades after a few frames (rotation ~1e-8 against an
unobserved accelerometer bias ~1), so inv(P / R) is past float32's reach,
and in float32 one frame could wreck the bias estimate and grow P.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ...geom import s2, so3
from ...utils.timer import Timer
from . import state as st

_H_COLS = 12  # measurement Jacobian covers pos/rot/ext_R/ext_t only


def process_noise_cov(
    dtype=torch.float32,
    gyr_cov: float = 1e-4,
    acc_cov: float = 1e-4,
    b_gyr_cov: float = 1e-5,
    b_acc_cov: float = 1e-5,
    device=None,
) -> torch.Tensor:
    """Q (12x12): gyro, accel, gyro-bias, accel-bias noise (use-ikfom.hpp:21-33)."""
    d = torch.empty(12, dtype=dtype, device=device)
    for i, v in enumerate((gyr_cov, acc_cov, b_gyr_cov, b_acc_cov)):
        d[3 * i:3 * i + 3] = v
    return torch.diag(d)


def init_P(dtype=torch.float32, device=None) -> torch.Tensor:
    """Initial covariance: identity with small extrinsic/gravity blocks."""
    P = torch.eye(st.DOF, dtype=dtype, device=device)
    P[st.EXT_R:st.EXT_R + 3, st.EXT_R:st.EXT_R + 3] *= 1e-5
    P[st.EXT_T:st.EXT_T + 3, st.EXT_T:st.EXT_T + 3] *= 1e-5
    P[st.GRAV:st.GRAV + 2, st.GRAV:st.GRAV + 2] *= 1e-5
    return P


def predict(x: st.NavState, P: torch.Tensor, acc: torch.Tensor, gyro: torch.Tensor, dt, Q: torch.Tensor):
    """One forward propagation step with IMU input (esekfom.hpp predict).
    Returns (x', P')."""
    dtype, dev = P.dtype, P.device
    omega = gyro - x.bg
    acc_b = acc - x.ba
    a_world = x.rot @ acc_b + x.grav

    x_new = st.NavState(
        pos=x.pos + x.vel * dt,
        rot=x.rot @ so3.exp(omega * dt),
        ext_R=x.ext_R,
        ext_t=x.ext_t,
        vel=x.vel + a_world * dt,
        bg=x.bg,
        ba=x.ba,
        grav=x.grav,
    )

    seg_rot = -omega * dt
    A_rot = so3.A_matrix(seg_rot)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Fx = torch.eye(st.DOF, dtype=dtype, device=dev)
    Fx[st.POS:st.POS + 3, st.VEL:st.VEL + 3] = eye3 * dt
    Fx[st.ROT:st.ROT + 3, st.ROT:st.ROT + 3] = so3.exp(seg_rot)
    Fx[st.ROT:st.ROT + 3, st.BG:st.BG + 3] = -dt * A_rot
    Fx[st.VEL:st.VEL + 3, st.ROT:st.ROT + 3] = -dt * x.rot @ so3.hat(acc_b)
    Fx[st.VEL:st.VEL + 3, st.BA:st.BA + 3] = -dt * x.rot
    Mx = s2.mx(x.grav, torch.zeros(2, dtype=dtype, device=dev))  # (3, 2), delta = 0
    Fx[st.VEL:st.VEL + 3, st.GRAV:st.GRAV + 2] = dt * Mx

    Fw = torch.zeros((st.DOF, 12), dtype=dtype, device=dev)
    Fw[st.ROT:st.ROT + 3, 0:3] = -dt * A_rot
    Fw[st.VEL:st.VEL + 3, 3:6] = -dt * x.rot
    Fw[st.BG:st.BG + 3, 6:9] = dt * eye3
    Fw[st.BA:st.BA + 3, 9:12] = dt * eye3

    P_new = Fx @ P @ Fx.T + Fw @ Q @ Fw.T
    P_new = 0.5 * (P_new + P_new.T)
    return x_new, P_new


def _transport(dx: torch.Tensor, x: st.NavState, x_prop: st.NavState) -> torch.Tensor:
    """Block-diagonal tangent transport T(dx) (23x23): A(dx_blk)^T for the
    SO(3) blocks, Nx(x) Mx(x_prop, dx_blk) for the S2 block, identity elsewhere
    (esekfom.hpp:1560-1601)."""
    T = torch.eye(st.DOF, dtype=dx.dtype, device=dx.device)
    T[st.ROT:st.ROT + 3, st.ROT:st.ROT + 3] = so3.A_matrix(dx[st.ROT:st.ROT + 3]).T
    T[st.EXT_R:st.EXT_R + 3, st.EXT_R:st.EXT_R + 3] = so3.A_matrix(dx[st.EXT_R:st.EXT_R + 3]).T
    T[st.GRAV:st.GRAV + 2, st.GRAV:st.GRAV + 2] = s2.nx_yy(x.grav) @ s2.mx(x_prop.grav, dx[st.GRAV:st.GRAV + 2])
    return T


class UpdateResult(NamedTuple):
    x: st.NavState
    P: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    cache: tuple = ()  # final correspondence cache from obs_fn (Nearest_Points role)
    host_syncs: int = 0  # device -> host reads the update made


def _inv(A: torch.Tensor) -> torch.Tensor:
    # inv_ex: no singularity check, so no device -> host read
    return torch.linalg.inv_ex(A)[0]


def update_iterated(
    x0: st.NavState,
    P0: torch.Tensor,
    obs_fn: Callable,
    R: float,
    max_iter: int = 4,
    epsi: float = 0.001,
    research: bool = True,
    reduce: Optional[Callable] = None,
) -> UpdateResult:
    """Iterated measurement update, small-state path (n <= measurements).

    obs_fn(x, do_search: bool, cache) -> (h_x (N, 12), h (N,), mask (N,), cache):
    the point-to-plane observation model; `do_search` mirrors the reference's
    `ekfom_data.converge` flag gating the NN re-search (laser_mapping.cc:618).
    The first iteration always searches (cache is None there).

    `reduce` is applied to the (HTH, HTh) pair right after the local point
    reductions, before the float64 algebra: the point-axis sharding hook
    (`parallel.sharded_lio_update` passes a sum over the ranks of a mesh
    axis, so each rank linearizes only its point shard).
    """
    dev, dtype, f64 = P0.device, P0.dtype, torch.float64
    P0d = P0.to(f64)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    do_search = torch.ones((), dtype=torch.bool, device=dev)
    t_conv = torch.zeros((), dtype=torch.int32, device=dev)
    cache = None
    x, P_out = x0, P0
    syncs = 0
    for it in range(max_iter):
        if it == 0:
            search = True
        elif research:
            flags = torch.stack([done, do_search & ~done]).tolist()
            syncs += 1
            if flags[0]:
                break  # every later iteration is masked out by `done`
            search = flags[1]
        else:
            search = False
        Timer.count("lio_step.iterations")
        if search:
            Timer.count("lio_step.searches")
        h_x, h, mask, cache = obs_fn(x, search, cache)
        m = mask.to(P0.dtype)
        h_x = h_x * m[:, None]
        h = h * m

        dx = st.boxminus(x, x0)
        T = _transport(dx, x, x0).to(f64)
        dx_new = T @ dx.to(f64)
        P = T @ P0d @ T.T

        HTH = h_x.T @ h_x  # (12, 12) reduction over points
        HTh = h_x.T @ h
        if reduce is not None:
            HTH, HTh = reduce((HTH, HTh))
        HTH, HTh = HTH.to(f64), HTh.to(f64)
        P_temp = _inv(P / R)
        P_temp[:_H_COLS, :_H_COLS] += HTH
        P_inv = _inv(P_temp)
        K_h = P_inv[:, :_H_COLS] @ HTh
        K_x12 = P_inv[:, :_H_COLS] @ HTH  # (23, 12)

        # dx = K_h + (K_x - I) dx_new, with K_x nonzero only in its first 12 cols
        dx_ = K_h + K_x12 @ dx_new[:_H_COLS] - dx_new
        dx_ = dx_.to(dtype)
        x_new = st.boxplus(x, dx_)
        x = st.where(done, x, x_new)
        conv = torch.all(torch.abs(dx_) < epsi)
        t_conv = t_conv + (conv & ~done).to(torch.int32)
        do_search = conv if research else torch.zeros_like(conv)
        finish = (t_conv > 1) | (it == max_iter - 1)

        # final covariance at the finishing iteration (esekfom.hpp:1737-1860):
        #   P_final = T2 P T2^T - (T2 K_x)[:, :12] (P T2^T)[:12, :]
        T2 = _transport(dx_, x_new, x0).to(f64)
        L = T2 @ P @ T2.T
        P_cols = P @ T2.T
        P_fin = L - (T2 @ K_x12) @ P_cols[:_H_COLS, :]
        P_fin = (0.5 * (P_fin + P_fin.T)).to(dtype)
        P_out = torch.where(done, P_out, P_fin)
        done = done | finish
    return UpdateResult(x, P_out, t_conv, done, cache, syncs)
