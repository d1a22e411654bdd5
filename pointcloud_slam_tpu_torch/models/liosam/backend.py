"""Pose-graph back-end: (pose, vel, bias) keyframe nodes + factors + GN/PCG
(port of `pointcloud_slam_tpu/models/liosam/backend.py`).

Reference: `src/jueying_slam/src/mapOptmization.cpp` — keyframe gating by
motion thresholds (`saveKeyFramesAndFactor` :1637-1884), odometry between
factors (`addOdomFactor` :1658), GPS position priors (`addGPSFactor`
:1678), loop between factors with a Cauchy kernel on the SC loops
(:822-835, here IRLS weights w = c^2 / (c^2 + chi^2)); and
`imuPreintegration.cpp` (:243-438) — the IMU factor graph over (pose,
velocity, bias) nodes. iSAM2 becomes batched Gauss-Newton with a
chain-preconditioned conjugate-gradient solve, matrix-free: H v is
accumulated factor by factor with gathers and scatter-adds (`_scatter_add`:
`index_add_`, atomics on a GPU, so single-device sums are not bit-stable
from run to run; a sharded solve's partial sums are added in order).

Node tangent layout (15 dims): [rot 0:3, trans 3:6, vel 6:9, bg 9:12,
ba 12:15], right perturbations R' = R Exp(dr), t' = t + R dt. The IMU
factor Jacobians are forward-mode autodiff of the local residual,
`torch.func.vmap(torch.func.jacfwd(...))` over factors, as the JAX package
does with `vmap(jacfwd)`.

Every loop has a fixed trip count (GN sweeps, PCG iterations, reduction
levels) and no function here reads a device value on the host, except
`grow` (host-side, once per growth). Writes that the JAX package drops when
a store is full (`mode="drop"`) land in one extra sink row that is cut off.
The block inverse of the chain preconditioner is a Cholesky inverse after
the same Jacobi scaling (the JAX package uses Newton-Schulz, a TPU choice);
the dense tail is `cholesky_ex` and two triangular solves. The chain
preconditioner is factored and applied in float64 (the JAX package: f32):
on a long chain that loops tie only in part, the f32 Schur complements of
the reduction lose the tail's smallest eigenvalues, and the f32 tail
factor of a 4,096-keyframe circle was NaN on the GPU. The slot-subset
arguments of `_graph_terms` serve the factor-sharded backend
(`parallel.sharded_optimize`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ...geom import so3
from ..lio import preintegration as pre

D = 15          # node tangent dims
RMAX = 9        # max residual rows per factor (IMU factor)


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    max_keyframes: int = 2048
    max_loops: int = 256
    gn_iterations: int = 6
    pcg_iterations: int = 60
    keyframe_angle_thresh: float = 0.2     # rad (surroundingkeyframeAddingAngleThreshold)
    keyframe_dist_thresh: float = 1.0      # m  (surroundingkeyframeAddingDistThreshold)
    prior_info: float = 1e8                # gauge prior on node 0
    loop_cauchy_c: float = 1.0             # robust kernel scale (whitened chi)
    # information of the bias random-walk between factor over one keyframe gap
    bias_walk_info: float = 1e4
    # trust region of one GN sweep of optimize(): the largest per-node pose
    # update (rad | m) a sweep may apply; the whole step is scaled
    max_step: float = 30.0
    # the per-keyframe window solve's tighter bound
    window_max_step: float = 5.0


class PoseGraph(NamedTuple):
    # nodes
    R: torch.Tensor          # (KF, 3, 3)
    t: torch.Tensor          # (KF, 3)
    vel: torch.Tensor        # (KF, 3) world-frame velocity
    bg: torch.Tensor         # (KF, 3) gyro bias
    ba: torch.Tensor         # (KF, 3) accel bias
    n: torch.Tensor          # () int32 active keyframes
    # odometry between factor i-1 -> i (slot i; slot 0 unused)
    odom_R: torch.Tensor     # (KF, 3, 3)
    odom_t: torch.Tensor     # (KF, 3)
    odom_info: torch.Tensor  # (KF, 6) diagonal information
    # IMU preintegration factor i-1 -> i (slot i)
    imu_pim: pre.PreintegratedImu  # batched (KF, ...) preintegrated deltas
    imu_info: torch.Tensor   # (KF, 9) diagonal information [er, ev, ep]
    imu_mask: torch.Tensor   # (KF,) bool — slot has an IMU factor
    bias_info: torch.Tensor  # (KF, 6) bias random-walk information
    # loop factors i -> j
    loop_i: torch.Tensor     # (L,) int32
    loop_j: torch.Tensor     # (L,) int32
    loop_R: torch.Tensor     # (L, 3, 3)
    loop_t: torch.Tensor     # (L, 3)
    loop_info: torch.Tensor  # (L, 6)
    loop_robust: torch.Tensor  # (L,) bool — apply the Cauchy kernel
    n_loops: torch.Tensor    # () int32
    # position priors (GPS)
    prior_mask: torch.Tensor  # (KF,)
    prior_pos: torch.Tensor   # (KF, 3)
    prior_info: torch.Tensor  # (KF, 3)
    grav: torch.Tensor        # (3,) gravity vector for IMU factors


def _eyes(n: int, dtype, device) -> torch.Tensor:
    return torch.eye(3, dtype=dtype, device=device).repeat(n, 1, 1)


def _empty_pim(KF: int, dtype, device) -> pre.PreintegratedImu:
    z3 = torch.zeros((KF, 3), dtype=dtype, device=device)
    z33 = torch.zeros((KF, 3, 3), dtype=dtype, device=device)
    return pre.PreintegratedImu(dR=_eyes(KF, dtype, device), dv=z3, dp=z3.clone(),
                                dt=torch.zeros((KF,), dtype=dtype, device=device), dR_dbg=z33, dv_dbg=z33.clone(),
                                dv_dba=z33.clone(), dp_dbg=z33.clone(), dp_dba=z33.clone(), bg0=z3.clone(),
                                ba0=z3.clone())


def create(cfg: BackendConfig, dtype=torch.float32, gravity: float = 9.81, device="cuda") -> PoseGraph:
    """An empty graph, on the GPU unless `device` says otherwise."""
    KF, L = cfg.max_keyframes, cfg.max_loops

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return PoseGraph(
        R=_eyes(KF, dtype, device), t=z(KF, 3), vel=z(KF, 3), bg=z(KF, 3), ba=z(KF, 3), n=z(dt=torch.int32),
        odom_R=_eyes(KF, dtype, device), odom_t=z(KF, 3), odom_info=z(KF, 6),
        imu_pim=_empty_pim(KF, dtype, device), imu_info=z(KF, 9), imu_mask=z(KF, dt=torch.bool),
        bias_info=z(KF, 6),
        loop_i=z(L, dt=torch.int32), loop_j=z(L, dt=torch.int32), loop_R=_eyes(L, dtype, device), loop_t=z(L, 3),
        loop_info=z(L, 6), loop_robust=z(L, dt=torch.bool), n_loops=z(dt=torch.int32),
        prior_mask=z(KF, dt=torch.bool), prior_pos=z(KF, 3), prior_info=z(KF, 3),
        grav=torch.tensor([0.0, 0.0, -gravity], dtype=dtype, device=device),
    )


def _pad_into(old, new):
    """`new` with `old` written over its leading slots (NamedTuples recursively)."""
    if isinstance(old, tuple):
        return type(old)(*(_pad_into(a, b) for a, b in zip(old, new)))
    if old.shape == new.shape:   # scalars (n, n_loops) and grav
        return old.clone()
    new[tuple(slice(0, s) for s in old.shape)] = old
    return new


def grow(cfg: BackendConfig, g: PoseGraph, max_keyframes: Optional[int] = None, max_loops: Optional[int] = None):
    """HOST-side capacity growth: re-pad every graph array to a larger
    `max_keyframes` / `max_loops` (defaults: double each). Returns
    `(new_cfg, new_graph)`. Existing nodes and factors are bit-identical;
    padded slots carry `create`'s inert values (identity rotations, zero
    information). Reads gravity back once."""
    KF_new = cfg.max_keyframes * 2 if max_keyframes is None else max_keyframes
    L_new = cfg.max_loops * 2 if max_loops is None else max_loops
    if KF_new < cfg.max_keyframes or L_new < cfg.max_loops:
        raise ValueError("grow() cannot shrink the graph")
    new_cfg = dataclasses.replace(cfg, max_keyframes=KF_new, max_loops=L_new)
    blank = create(new_cfg, g.t.dtype, gravity=-float(g.grav[2]), device=g.t.device)
    return new_cfg, _pad_into(g, blank)


def _row(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a[i] for a device scalar index i, without reading it on the host."""
    return a.index_select(0, i.reshape(1))[0]


def _set_rows(a: torch.Tensor, i: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a.at[i].set(v, mode="drop") for indices i (1-d) in [0, len(a)]: the
    index len(a) writes into a sink row that is cut off."""
    out = torch.cat([a, a[:1]])
    out.index_copy_(0, i, v.to(a.dtype))
    return out[:-1]


def _set_row(a: torch.Tensor, i: torch.Tensor, v) -> torch.Tensor:
    """a.at[i].set(v, mode="drop") for one device index i. A Python value is
    filled on the device (a host-to-device copy would wait for the stream)."""
    if not torch.is_tensor(v):
        v = torch.full(a.shape[1:], v, dtype=a.dtype, device=a.device)
    return _set_rows(a, i.reshape(1), v.expand(a.shape[1:])[None])


def _diag(*parts, dtype, device) -> torch.Tensor:
    """Concatenated constant runs, e.g. ((1e6, 3), (1e4, 3)), filled on the device."""
    return torch.cat([torch.full((n,), v, dtype=dtype, device=device) for v, n in parts])


def should_add_keyframe(cfg: BackendConfig, g: PoseGraph, R_new, t_new):
    """Motion gating vs the last keyframe (saveKeyFramesAndFactor :1637), and
    no keyframe at capacity (`grow` extends it host-side)."""
    last = torch.clamp(g.n - 1, min=0)
    dR = so3.boxminus(R_new, _row(g.R, last))
    dt = t_new - _row(g.t, last)
    move = (torch.amax(torch.abs(dR)) > cfg.keyframe_angle_thresh) | (torch.linalg.norm(dt) > cfg.keyframe_dist_thresh)
    return (move | (g.n == 0)) & (g.n < cfg.max_keyframes)


def add_keyframe(
    cfg: BackendConfig,
    g: PoseGraph,
    R_new,
    t_new,
    odom_info_diag=None,
    vel_new=None,
    pim: Optional[pre.PreintegratedImu] = None,
    imu_info_diag=None,
    bias_info_diag=None,
) -> PoseGraph:
    """Append a node + odometry between factor from the previous node; with
    `pim` (the IMU preintegration since the last keyframe) also an IMU factor
    and a bias random-walk factor (imuPreintegration.cpp:243-438).

    At `n == max_keyframes` it is a strict no-op: every write lands in the
    sink row and `n` does not change."""
    dtype, dev = g.t.dtype, g.t.device
    KF = cfg.max_keyframes
    if odom_info_diag is None:
        # reference odometryNoise variances: rot 1e-6, trans 1e-4
        # (mapOptmization.cpp:1666) -> information 1e6 / 1e4
        odom_info_diag = _diag((1e6, 3), (1e4, 3), dtype=dtype, device=dev)
    full = g.n >= KF
    i = torch.where(full, KF, g.n).to(torch.int64)
    last = torch.clamp(g.n - 1, min=0)
    R_last, t_last = _row(g.R, last), _row(g.t, last)
    relR = R_last.T @ R_new
    relt = R_last.T @ (t_new - t_last)
    first = g.n == 0
    if vel_new is None:
        vel_new = torch.zeros(3, dtype=dtype, device=dev)
    g = g._replace(
        R=_set_row(g.R, i, R_new),
        t=_set_row(g.t, i, t_new),
        vel=_set_row(g.vel, i, vel_new),
        bg=_set_row(g.bg, i, _row(g.bg, last)),
        ba=_set_row(g.ba, i, _row(g.ba, last)),
        odom_R=_set_row(g.odom_R, i, torch.where(first, torch.eye(3, dtype=dtype, device=dev), relR)),
        odom_t=_set_row(g.odom_t, i, torch.where(first, 0.0, relt)),
        odom_info=_set_row(g.odom_info, i, torch.where(first, 0.0, odom_info_diag)),
        n=torch.clamp(g.n + 1, max=KF),
    )
    if pim is not None:
        if imu_info_diag is None:
            imu_info_diag = _diag((1e6, 3), (1e4, 6), dtype=dtype, device=dev)
        if bias_info_diag is None:
            bias_info_diag = torch.full((6,), cfg.bias_walk_info, dtype=dtype, device=dev)
        has = ~first
        g = g._replace(
            imu_pim=pre.PreintegratedImu(*(_set_row(a, i, b) for a, b in zip(g.imu_pim, pim))),
            imu_info=_set_row(g.imu_info, i, torch.where(has, imu_info_diag, 0.0)),
            imu_mask=_set_row(g.imu_mask, i, has),
            bias_info=_set_row(g.bias_info, i, torch.where(has, bias_info_diag, 0.0)),
        )
    return g


def add_loop(cfg: BackendConfig, g: PoseGraph, i, j, relR, relt, info_diag, robust=True) -> PoseGraph:
    """Append a loop-closure between factor i -> j (addLoopFactor :1757).
    At capacity it is a strict no-op (`grow` extends the store)."""
    L = cfg.max_loops
    k = torch.where(g.n_loops >= L, L, g.n_loops).to(torch.int64)
    return g._replace(
        loop_i=_set_row(g.loop_i, k, i),
        loop_j=_set_row(g.loop_j, k, j),
        loop_R=_set_row(g.loop_R, k, relR),
        loop_t=_set_row(g.loop_t, k, relt),
        loop_info=_set_row(g.loop_info, k, info_diag),
        loop_robust=_set_row(g.loop_robust, k, robust),
        n_loops=torch.clamp(g.n_loops + 1, max=L),
    )


def add_gps(g: PoseGraph, i, pos, info_diag) -> PoseGraph:
    """Position prior on node i (addGPSFactor :1678)."""
    if not torch.is_tensor(i):
        i = torch.full((), i, dtype=torch.int64, device=g.t.device)
    i = i.to(torch.int64)
    return g._replace(
        prior_mask=_set_row(g.prior_mask, i, True),
        prior_pos=_set_row(g.prior_pos, i, pos),
        prior_info=_set_row(g.prior_info, i, info_diag),
    )


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _adjoint(R, t):
    """SE(3) adjoint for [rot, trans] tangent ordering: (..., 6, 6)."""
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([so3.hat(t) @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _between_residual(Ri, ti, Rj, tj, Rm, tm):
    """e = Log(M^-1 (T_i^-1 T_j)) with T = (R, t), M the measurement."""
    RiT, RmT = Ri.transpose(-1, -2), Rm.transpose(-1, -2)
    Re = RmT @ (RiT @ Rj)
    te = _mv(RmT, _mv(RiT, tj - ti) - tm)
    return torch.cat([so3.log(Re), te], dim=-1)


def _between_jacobians(Ri, ti, Rj, tj):
    """Right-perturbation Jacobian of node i with Jr^-1 ~ I:
    J_i = -Ad(T_j^-1 T_i) (J_j = I)."""
    RjT = Rj.transpose(-1, -2)
    return -_adjoint(RjT @ Ri, _mv(RjT, ti - tj))


def _pad_between(Ji6, F, dtype):
    """Embed a (F, 6, 6) pose-block Jacobian into (F, RMAX, D) factor rows."""
    Ji = torch.zeros((F, RMAX, D), dtype=dtype, device=Ji6.device)
    Ji[:, 0:6, 0:6] = Ji6
    Jj = torch.zeros((F, RMAX, D), dtype=dtype, device=Ji6.device)
    Jj[:, 0:6, 0:6] = torch.eye(6, dtype=dtype, device=Ji6.device)
    return Ji, Jj


def _rows6(e6, F, dtype):
    """(F, 6) -> (F, RMAX) with zero rows 6:9."""
    return torch.cat([e6, torch.zeros((F, RMAX - 6), dtype=dtype, device=e6.device)], dim=1)


def _imu_local_residual(dxi, dxj, Ri, ti, vi, bgi, bai, Rj, tj, vj, pim, grav):
    """IMU factor residual under right perturbations of nodes i and j."""
    Ri_ = Ri @ so3.exp(dxi[..., 0:3])
    ti_ = ti + _mv(Ri, dxi[..., 3:6])
    vi_ = vi + dxi[..., 6:9]
    bgi_ = bgi + dxi[..., 9:12]
    bai_ = bai + dxi[..., 12:15]
    Rj_ = Rj @ so3.exp(dxj[..., 0:3])
    tj_ = tj + _mv(Rj, dxj[..., 3:6])
    vj_ = vj + dxj[..., 6:9]
    return pre.residual(pim, Ri_, ti_, vi_, Rj_, tj_, vj_, bgi_, bai_, grav)


def _imu_terms(Ri, ti, vi, bgi, bai, Rj, tj, vj, pim, grav):
    """IMU factors (one per row): Jacobians (F, 9, 15) for nodes i and j at
    dx = 0 by forward-mode autodiff, and residuals (F, 9).

    Each factor keeps a leading axis of 1 inside the vmapped function: on
    0-d intermediates torch.func's forward mode promotes the tangent of
    `x * python_float` to float64 and a later matmul refuses the mix."""
    F = Ri.shape[0]
    z = torch.zeros((F, 1, D), dtype=Ri.dtype, device=Ri.device)
    one = [a[:, None] for a in (Ri, ti, vi, bgi, bai, Rj, tj, vj)]
    jac = torch.func.vmap(torch.func.jacfwd(_imu_local_residual, argnums=(0, 1)), in_dims=(0,) * 11 + (None,))
    Ji, Jj = jac(z, z, *one, pre.PreintegratedImu(*(a[:, None] for a in pim)), grav)
    return (Ji.reshape(F, RMAX, D), Jj.reshape(F, RMAX, D),
            pre.residual(pim, Ri, ti, vi, Rj, tj, vj, bgi, bai, grav))


def _bias_jacobians(F, dtype, device):
    """Bias random-walk factor rows: -I / +I on the bias block [9:15]."""
    Ji = torch.zeros((F, RMAX, D), dtype=dtype, device=device)
    Jj = torch.zeros((F, RMAX, D), dtype=dtype, device=device)
    eye6 = torch.eye(6, dtype=dtype, device=device)
    Ji[:, 0:6, 9:15] = -eye6
    Jj[:, 0:6, 9:15] = eye6
    return Ji, Jj


def _loop_terms(cfg: BackendConfig, Ri, ti, Rj, tj, g: PoseGraph, act, lidx=None):
    """Loop between factors with the Cauchy IRLS weight: Ji, Jj, e, info.
    `lidx` picks loop slots (all of them when None)."""
    L = Ri.shape[0]
    loop_R, loop_t, loop_info, loop_robust = (
        (g.loop_R, g.loop_t, g.loop_info, g.loop_robust) if lidx is None
        else (g.loop_R[lidx], g.loop_t[lidx], g.loop_info[lidx], g.loop_robust[lidx]))
    e6 = _between_residual(Ri, ti, Rj, tj, loop_R, loop_t)
    chi2 = torch.sum(e6 * e6 * loop_info, dim=-1)
    c2 = cfg.loop_cauchy_c ** 2
    w_rob = torch.where(loop_robust, c2 / (c2 + chi2), 1.0)
    Ji, Jj = _pad_between(_between_jacobians(Ri, ti, Rj, tj), L, Ri.dtype)
    return Ji, Jj, _rows6(e6, L, Ri.dtype), _rows6(loop_info * (act * w_rob)[:, None], L, Ri.dtype)


def _graph_terms(cfg: BackendConfig, g: PoseGraph, kf_slots=None, loop_slots=None):
    """Assemble the padded per-factor arrays over ALL factor families.

    Returns (fi, fj, Ji (F, RMAX, D), Jj, e (F, RMAX), info (F, RMAX), B):
    odometry, loop, IMU and bias factors in that order; inactive rows carry
    zero information. B (KF, D, D) holds the sub-diagonal blocks of the
    sequential families for the chain preconditioner.

    `kf_slots` / `loop_slots` (int tensors) restrict the linearization to
    those keyframe slots (odometry, IMU and bias factors share slot k
    between nodes k-1 and k) and loop slots: the factor-sharded backend
    gives each rank its own range. Slots at or beyond their table are
    inert: zero information, their gathers clamped into the table, so their
    scatters add exact zeros. B then holds only the slots' sub-diagonal
    terms, and the shards must be summed before `chain_factor`."""
    KF = cfg.max_keyframes
    dtype, dev = g.t.dtype, g.t.device
    L = g.loop_i.shape[0]
    if kf_slots is None:
        idx = torch.arange(KF, device=dev)
        oj, take = idx, (lambda a: a)
    else:
        idx = kf_slots.to(torch.int64)
        oj = torch.clamp(idx, max=KF - 1)
        take = (lambda a: a[oj])

    # ---- odometry between factors (slots 1..n-1; i = k-1, j = k) ----
    o_act = (idx >= 1) & (idx < g.n)
    oi = torch.clamp(oj - 1, min=0)
    nk = idx.shape[0]
    Ri, ti, Rj, tj = g.R[oi], g.t[oi], take(g.R), take(g.t)
    Ji_o, Jj_o = _pad_between(_between_jacobians(Ri, ti, Rj, tj), nk, dtype)
    e_o = _rows6(_between_residual(Ri, ti, Rj, tj, take(g.odom_R), take(g.odom_t)), nk, dtype)
    info_o = _rows6(take(g.odom_info) * o_act[:, None], nk, dtype)

    # ---- loop between factors, Cauchy-robust IRLS weight ----
    if loop_slots is None:
        lidx, lsel = torch.arange(L, device=dev), None
    else:
        lidx = loop_slots.to(torch.int64)
        lsel = torch.clamp(lidx, max=L - 1)
    li = (g.loop_i if lsel is None else g.loop_i[lsel]).to(torch.int64)
    lj = (g.loop_j if lsel is None else g.loop_j[lsel]).to(torch.int64)
    l_act = lidx < g.n_loops
    Ji_l, Jj_l, e_l, info_l = _loop_terms(cfg, g.R[li], g.t[li], g.R[lj], g.t[lj], g, l_act, lsel)

    # ---- IMU preintegration factors (slot k between k-1, k) ----
    i_act = o_act & take(g.imu_mask)
    pim = g.imu_pim if kf_slots is None else pre.PreintegratedImu(*(a[oj] for a in g.imu_pim))
    Ji_i9, Jj_i9, e9_i = _imu_terms(Ri, ti, g.vel[oi], g.bg[oi], g.ba[oi], Rj, tj, take(g.vel), pim, g.grav)
    info_i = take(g.imu_info) * i_act[:, None]

    # ---- bias random-walk between factors ----
    Ji_b, Jj_b = _bias_jacobians(nk, dtype, dev)
    e_b = _rows6(torch.cat([take(g.bg) - g.bg[oi], take(g.ba) - g.ba[oi]], dim=-1), nk, dtype)
    info_b = _rows6(take(g.bias_info) * i_act[:, None], nk, dtype)

    fi = torch.cat([oi, li, oi, oi])
    fj = torch.cat([oj, lj, oj, oj])
    Ji = torch.cat([Ji_o, Ji_l, Ji_i9, Ji_b])
    Jj = torch.cat([Jj_o, Jj_l, Jj_i9, Jj_b])
    e = torch.cat([e_o, e_l, e9_i, e_b])
    info = torch.cat([info_o, info_l, info_i, info_b])
    # loops stay out of the chain preconditioner (the low-rank PCG part)
    B = _offdiag_blocks(KF, dtype, oj, (Ji_o, Ji_i9, Ji_b), (Jj_o, Jj_i9, Jj_b), (info_o, info_i, info_b))
    return fi, fj, Ji, Jj, e, info, B


def _scatter_add(out, idx, rows, sharded):
    """out[idx[f]] += rows[f] for every factor f. On the GPU `index_add_`'s
    atomics add in any order, so its sums move by ulps from run to run. The
    partial sums of a sharded solve (`sharded`) must be equal on every
    replica of a shard (the dp groups of a mesh), so there the GPU adds in
    the factors' order: `index_put_(accumulate=True)` sorts the indices
    stably (~1,000 more launches a 3 GN x 24 PCG solve). On the CPU
    `index_add_` adds in the factors' order already."""
    if sharded and out.is_cuda:
        return out.index_put_((idx,), rows, accumulate=True)
    return out.index_add_(0, idx, rows)


def _hv(fi, fj, Ji, Jj, info, prior_diag, v, reduce=None):
    """Matrix-free H @ v over all factors. v (KF, D) -> (KF, D). `reduce`
    sums the factor part across factor shards before the prior is added."""
    fv = torch.einsum("fab,fb->fa", Ji, v[fi]) + torch.einsum("fab,fb->fa", Jj, v[fj])
    w = info * fv
    out = torch.zeros_like(v)
    _scatter_add(out, fi, torch.einsum("fba,fb->fa", Ji, w), reduce is not None)
    _scatter_add(out, fj, torch.einsum("fba,fb->fa", Jj, w), reduce is not None)
    if reduce is not None:
        out = reduce(out)
    return out + prior_diag * v


def _precond_blocks(KF, dtype, fi, fj, Ji, Jj, info, prior_diag, reduce=None):
    """Block-diagonal of H (KF, D, D), NOT inverted (the chain
    preconditioner's diagonal). `reduce` as in `_hv`."""
    blocks = torch.zeros((KF, D, D), dtype=dtype, device=Ji.device)
    _scatter_add(blocks, fi, torch.einsum("fba,fb,fbc->fac", Ji, info, Ji), reduce is not None)
    _scatter_add(blocks, fj, torch.einsum("fba,fb,fbc->fac", Jj, info, Jj), reduce is not None)
    if reduce is not None:
        blocks = reduce(blocks)
    return blocks + torch.diag_embed(prior_diag) + 1e-6 * torch.eye(D, dtype=dtype, device=Ji.device)


def _offdiag_blocks(KF, dtype, slots, Ji_fams, Jj_fams, info_fams):
    """Sub-diagonal blocks L (KF, D, D): L[k] = H[node k, node k-1] =
    Jj^T W Ji summed over the sequential families (odometry, IMU, bias),
    whose slot k couples nodes (k-1, k). Loop factors are excluded."""
    acc = 0
    for Ji_f, Jj_f, info_f in zip(Ji_fams, Jj_fams, info_fams):
        acc = acc + torch.einsum("fba,fb,fbc->fac", Jj_f, info_f, Ji_f)
    out = torch.zeros((KF, D, D), dtype=dtype, device=slots.device)
    return out.index_add_(0, slots, acc)


def _spd_inv(A):
    """Batched SPD inverse: Jacobi-scaled to unit diagonal (the blocks'
    diagonals span 1e0-1e8), then a Cholesky inverse, symmetrized. A block
    whose Cholesky fails (not reachable: every block carries a ridge) falls
    back to the inverse diagonal."""
    d = torch.sqrt(torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), min=1e-20))
    dd = d[..., :, None] * d[..., None, :]
    L, info = torch.linalg.cholesky_ex(A / dd)
    X = torch.cholesky_inverse(L)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    X = torch.where((info == 0)[..., None, None], 0.5 * (X + X.transpose(-1, -2)), eye)
    return X / dd


def chain_factor(Dblk, L, direct_n=256):
    """Block cyclic reduction factorization of the SPD block-tridiagonal
    system diag(Dblk) + sub-diagonal L (L[k] couples node k-1 -> k, L[0]=0):
    log2 levels of batched 15x15 block algebra down to `direct_n` nodes, and
    the remainder solved densely by one Cholesky factorization (Jacobi-
    scaled: the raw diagonal spans 1e0-1e8). The factorization is float64
    whatever the input's dtype (module docstring). Returns (levels, tail)
    for `chain_solve`."""
    Dblk, L = Dblk.to(torch.float64), L.to(torch.float64)
    dtype, dev = Dblk.dtype, Dblk.device
    B = Dblk.shape[-1]
    eye = torch.eye(B, dtype=dtype, device=dev)
    z1 = torch.zeros((1, B, B), dtype=dtype, device=dev)
    levels = []
    Dl, Ll = Dblk, L
    n = Dl.shape[0]
    while n > max(direct_n, 1):
        n_odd = n // 2
        n_even = n - n_odd
        De, Do = Dl[0::2], Dl[1::2]
        Le, Lo = Ll[0::2], Ll[1::2]          # L[2m]: 2m-1 -> 2m ; L[2m+1]: 2m -> 2m+1
        Do_inv = _spd_inv(Do + 1e-8 * eye)
        pad = n_even - n_odd
        Do_inv_p = torch.cat([Do_inv, eye[None].expand(pad, B, B)]) if pad else Do_inv
        Lo_p = torch.cat([Lo, z1.expand(pad, B, B)]) if pad else Lo
        # A[m] = L[2m] @ Do_inv[m-1]  (A[0] = 0 since L[0] = 0)
        A = Le @ torch.cat([eye[None], Do_inv_p[:-1]])
        # C[m] = L[2m+1]^T @ Do_inv[m]  (zero at the padded tail)
        C = Lo_p.transpose(-1, -2) @ Do_inv_p
        D_new = De - A @ Le.transpose(-1, -2) - C @ Lo_p
        L_new = -(A @ torch.cat([z1, Lo_p[:-1]]))
        LeT_next = torch.cat([Le[1:], z1]).transpose(-1, -2)[:n_odd]
        levels.append({"A": A, "C": C, "Do_inv": Do_inv, "Lo": Lo, "LeT_next": LeT_next, "n": n})
        Dl, Ll, n = D_new, L_new, n_even
    M = torch.zeros((n, B, n, B), dtype=dtype, device=dev)
    idx = torch.arange(n, device=dev)
    M[idx, :, idx, :] = Dl
    if n > 1:
        M[idx[1:], :, idx[:-1], :] = Ll[1:]
        M[idx[:-1], :, idx[1:], :] = Ll[1:].transpose(-1, -2)
    M = M.reshape(n * B, n * B)
    d = torch.sqrt(torch.clamp(torch.diagonal(M), min=1e-20))
    M = M / (d[:, None] * d[None, :]) + 1e-6 * torch.eye(n * B, dtype=dtype, device=dev)
    return levels, (torch.linalg.cholesky_ex(M)[0], d, n)


def chain_solve(levels, tail, r):
    """Apply the cyclic-reduction factorization: solve M x = r, r (KF, D),
    in float64; x comes back in r's dtype."""
    out_dtype, r = r.dtype, r.to(torch.float64)
    stack = []
    for lv in levels:
        r_e, r_o = r[0::2], r[1::2]
        pad = r_e.shape[0] - r_o.shape[0]
        zrow = r.new_zeros((1, r.shape[1]))
        r_o_p = torch.cat([r_o, zrow]) if pad else r_o
        r_o_shift = torch.cat([zrow, r_o_p[:-1]])
        r = r_e - _mv(lv["A"], r_o_shift) - _mv(lv["C"], r_o_p)
        stack.append(r_o)
    chol, d, n_tail = tail
    # two triangular solves: cholesky_solve copies the whole factor each call
    y = torch.linalg.solve_triangular(chol, (r.reshape(-1) / d)[:, None], upper=False)
    x = torch.linalg.solve_triangular(chol.T, y, upper=True)[:, 0] / d
    x = x.reshape(n_tail, r.shape[1])
    for lv, r_o in zip(reversed(levels), reversed(stack)):
        n_odd = r_o.shape[0]
        x_e = x
        x_e_next = torch.cat([x_e[1:], x.new_zeros((1, x.shape[1]))])[:n_odd]
        x_o = _mv(lv["Do_inv"], r_o - _mv(lv["Lo"], x_e[:n_odd]) - _mv(lv["LeT_next"], x_e_next))
        x = x.new_zeros((lv["n"], x.shape[1]))
        x[0::2] = x_e
        x[1::2] = x_o
    return x.to(out_dtype)


def _pcg(hv, precond, b, n_iter):
    """Preconditioned conjugate gradient on H dx = -b, fixed n_iter."""
    x = torch.zeros_like(b)
    r = -b - hv(x)
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(n_iter):
        Ap = hv(p)
        denom = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(denom) < 1e-20, 1e-20, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.where(torch.abs(rz) < 1e-20, 1e-20, rz)
        p = z + beta * p
        rz = rz_new
    return x


def _priors(cfg: BackendConfig, slot0, active, vb_obs, gpsw3):
    """Per-node prior diagonal (N, D): the gauge prior on node 0, unit priors
    on inactive slots and on vel/bias blocks no IMU factor observes, plus the
    GPS information on the translation block."""
    pose_prior = torch.where(slot0 & active, cfg.prior_info, torch.where(active, 0.0, 1.0))
    vb_prior = torch.where(slot0 & active, max(cfg.prior_info * 1e-4, 1.0), torch.where(vb_obs, 0.0, 1.0))
    prior = torch.cat([pose_prior[:, None].expand(-1, 6), vb_prior[:, None].expand(-1, 9)], dim=1).to(gpsw3.dtype)
    gpsw = torch.zeros_like(prior)
    gpsw[:, 3:6] = gpsw3
    return prior + gpsw, gpsw


def _rhs(nn, fi, fj, Ji, Jj, e, info, R, t, gps_pos, gpsw, reduce=None):
    """b = sum_f J^T W e, minus the GPS residual terms (r = R^T (p_gps - t)
    under t' = t + R dt, J_dt = -I). `reduce` as in `_hv`."""
    w_e = info * e
    b = Ji.new_zeros((nn, D))
    _scatter_add(b, fi, torch.einsum("fba,fb->fa", Ji, w_e), reduce is not None)
    _scatter_add(b, fj, torch.einsum("fba,fb->fa", Jj, w_e), reduce is not None)
    if reduce is not None:
        b = reduce(b)
    gps_r = torch.zeros_like(b)
    gps_r[:, 3:6] = _mv(R.transpose(-1, -2), gps_pos - t)
    return b - gpsw * gps_r


def _retract(R, t, vel, bg, ba, dx, active, max_step):
    """Trust-region-scaled right retraction of every node by dx (N, D)."""
    dx = torch.where(active[:, None], dx, 0.0)
    step_max = torch.amax(torch.abs(dx[:, 0:6]))
    dx = dx * torch.clamp(max_step / torch.clamp(step_max, min=1e-12), max=1.0)
    return (R @ so3.exp(dx[:, 0:3]), t + _mv(R, dx[:, 3:6]), vel + dx[:, 6:9], bg + dx[:, 9:12],
            ba + dx[:, 12:15])


def optimize_window(
    cfg: BackendConfig,
    g: PoseGraph,
    window: int = 32,
    gn_iterations: int = 2,
    pcg_iterations: int = 8,
) -> PoseGraph:
    """Sliding-window GN: relinearize + solve only the last `window` nodes
    (the iSAM2 per-keyframe update role, imuPreintegration.cpp:305-332,
    mapOptmization.cpp:1835-1850), with the node before the window held
    fixed as anchor; in-window loop factors are absorbed by a few PCG
    iterations. Older nodes are untouched."""
    KF = cfg.max_keyframes
    dtype, dev = g.t.dtype, g.t.device
    W = min(window, KF)
    L = g.loop_i.shape[0]
    ar = torch.arange(W, device=dev)
    start = torch.clamp(g.n - W, min=0)
    w_pos = start + ar
    w_idx = torch.clamp(w_pos, max=KF - 1).to(torch.int64)
    active = w_pos < g.n

    # fixed anchor = node start-1 (never moves; virtual identity when start==0)
    a_idx = torch.clamp(start - 1, min=0).to(torch.int64).reshape(1)
    anchor = [a.index_select(0, a_idx) for a in (g.R, g.t, g.vel, g.bg, g.ba)]

    # in-window loop factors (both ends free)
    l_act = (torch.arange(L, device=dev) < g.n_loops) & (g.loop_i >= start) & (g.loop_j >= start)
    lwi = torch.clamp(g.loop_i - start, 0, W - 1).to(torch.int64)
    lwj = torch.clamp(g.loop_j - start, 0, W - 1).to(torch.int64)

    gpsw3 = (g.prior_info * g.prior_mask[:, None])[w_idx] * active[:, None]
    gps_pos_w = g.prior_pos[w_idx]

    # vel/bias observability inside the window (same pinning as optimize())
    imu_w = g.imu_mask[w_idx] & active
    imu_next = torch.cat([imu_w[1:], torch.zeros(1, dtype=torch.bool, device=dev)])
    vb_obs = active & (imu_w | imu_next)
    prior_diag, gpsw = _priors(cfg, w_idx == 0, active, vb_obs, gpsw3)

    f_act = active & (w_idx >= 1)
    i_act = f_act & g.imu_mask[w_idx]
    # the anchor node is fixed: zero its (i-side) Jacobians for factor 0
    fixm = torch.where((ar == 0) & (start > 0), 0.0, 1.0).to(dtype)[:, None, None]
    fi_seq = torch.clamp(ar - 1, min=0)
    fi = torch.cat([fi_seq, lwi, fi_seq, fi_seq])
    fj = torch.cat([ar, lwj, ar, ar])
    odom_R, odom_t = g.odom_R[w_idx], g.odom_t[w_idx]
    info_o = _rows6(g.odom_info[w_idx] * f_act[:, None], W, dtype)
    info_i = g.imu_info[w_idx] * i_act[:, None]
    info_b = _rows6(g.bias_info[w_idx] * i_act[:, None], W, dtype)
    pim_w = pre.PreintegratedImu(*(a[w_idx] for a in g.imu_pim))
    Ji_b, Jj_b = _bias_jacobians(W, dtype, dev)
    Ji_b = Ji_b * fixm

    R, t, vel, bg, ba = (a[w_idx] for a in (g.R, g.t, g.vel, g.bg, g.ba))
    for _ in range(gn_iterations):
        Ri, ti, veli, bgi, bai = (torch.cat([a, x[:-1]]) for a, x in zip(anchor, (R, t, vel, bg, ba)))
        Ji_o, Jj_o = _pad_between(_between_jacobians(Ri, ti, R, t), W, dtype)
        e_o = _rows6(_between_residual(Ri, ti, R, t, odom_R, odom_t), W, dtype)
        Ji_i9, Jj_i9, e9_i = _imu_terms(Ri, ti, veli, bgi, bai, R, t, vel, pim_w, g.grav)
        e_b = _rows6(torch.cat([bg - bgi, ba - bai], dim=-1), W, dtype)
        Ji_o, Ji_i9 = Ji_o * fixm, Ji_i9 * fixm
        Ji_l, Jj_l, e_l, info_l = _loop_terms(cfg, R[lwi], t[lwi], R[lwj], t[lwj], g, l_act)

        Ji = torch.cat([Ji_o, Ji_l, Ji_i9, Ji_b])
        Jj = torch.cat([Jj_o, Jj_l, Jj_i9, Jj_b])
        e = torch.cat([e_o, e_l, e9_i, e_b])
        info = torch.cat([info_o, info_l, info_i, info_b])
        b = _rhs(W, fi, fj, Ji, Jj, e, info, R, t, gps_pos_w, gpsw)
        Dblk = _precond_blocks(W, dtype, fi, fj, Ji, Jj, info, prior_diag)
        B = _offdiag_blocks(W, dtype, ar, (Ji_o, Ji_i9, Ji_b), (Jj_o, Jj_i9, Jj_b), (info_o, info_i, info_b))
        levels, tail = chain_factor(Dblk, B)
        dx = _pcg(lambda v: _hv(fi, fj, Ji, Jj, info, prior_diag, v), lambda r: chain_solve(levels, tail, r), b,
                  pcg_iterations)
        R, t, vel, bg, ba = _retract(R, t, vel, bg, ba, dx, active, cfg.window_max_step)

    tgt = torch.where(active, w_idx, KF)
    return g._replace(R=_set_rows(g.R, tgt, R), t=_set_rows(g.t, tgt, t), vel=_set_rows(g.vel, tgt, vel),
                      bg=_set_rows(g.bg, tgt, bg), ba=_set_rows(g.ba, tgt, ba))


def residual_stats(cfg: BackendConfig, g: PoseGraph):
    """Whitened residual diagnostics over all active factors: (chi2 total, rms)."""
    _, _, _, _, e, info, _ = _graph_terms(cfg, g)
    chi2 = torch.sum(info * e * e)
    n_rows = torch.clamp(torch.sum(info > 0), min=1)
    return chi2, torch.sqrt(chi2 / n_rows.to(e.dtype))


def optimize(cfg: BackendConfig, g: PoseGraph, gn_iterations: Optional[int] = None,
             pcg_iterations: Optional[int] = None) -> PoseGraph:
    """Batch GN over the whole graph (the correctPoses moment).

    Node 0 carries a huge prior (gauge); inactive slots get unit priors so H
    stays non-singular without affecting active nodes; vel/bias blocks no IMU
    factor touches are pinned the same way. `gn_iterations` /
    `pcg_iterations` override the config (the deferred loop-event solve runs
    one sweep per frame)."""
    n_gn = cfg.gn_iterations if gn_iterations is None else gn_iterations
    n_pcg = cfg.pcg_iterations if pcg_iterations is None else pcg_iterations
    return _gauss_newton(cfg, g, n_gn, n_pcg)


def _gauss_newton(cfg: BackendConfig, g: PoseGraph, n_gn: int, n_pcg: int, kf_slots=None, loop_slots=None,
                  reduce=None) -> PoseGraph:
    """`optimize`'s sweeps. With `kf_slots` / `loop_slots` and `reduce`, this
    rank linearizes only its factor slots (`_graph_terms`) and `reduce` sums
    the factor parts of B, b, the diagonal blocks and every H @ v across the
    shards before the replicated terms (priors, GPS) are added once; the
    chain factorization, PCG, trust region and retraction run whole on
    every rank (`parallel.sharded_optimize`)."""
    KF = cfg.max_keyframes
    dtype, dev = g.t.dtype, g.t.device
    idx = torch.arange(KF, device=dev)
    active = idx < torch.clamp(g.n, min=1)
    # a node's vel/bias are observable iff an IMU factor touches it
    imu_next = torch.cat([g.imu_mask[1:], torch.zeros(1, dtype=torch.bool, device=dev)])
    vb_obs = active & (g.imu_mask | imu_next)
    prior_diag, gpsw = _priors(cfg, idx == 0, active, vb_obs, g.prior_info * g.prior_mask[:, None])
    for _ in range(n_gn):
        fi, fj, Ji, Jj, e, info, B = _graph_terms(cfg, g, kf_slots, loop_slots)
        if reduce is not None:
            B = reduce(B)
        b = _rhs(KF, fi, fj, Ji, Jj, e, info, g.R, g.t, g.prior_pos, gpsw, reduce)
        Dblk = _precond_blocks(KF, dtype, fi, fj, Ji, Jj, info, prior_diag, reduce)
        levels, tail = chain_factor(Dblk, B)
        # PCG preconditioned by the EXACT chain solve: iterations ~ loops, not keyframes
        dx = _pcg(lambda v: _hv(fi, fj, Ji, Jj, info, prior_diag, v, reduce), lambda r: chain_solve(levels, tail, r),
                  b, n_pcg)
        R, t, vel, bg, ba = _retract(g.R, g.t, g.vel, g.bg, g.ba, dx, active, cfg.max_step)
        g = g._replace(R=R, t=t, vel=vel, bg=bg, ba=ba)
    return g
