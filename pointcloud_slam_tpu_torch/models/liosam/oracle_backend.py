"""Independent f64 pose-graph oracle: scipy-sparse Gauss-Newton with
finite-difference Jacobians.

Role: the repo's backend (backend.py) REPLACED the reference's gtsam/iSAM2
(mapOptmization.cpp:1835-1850) with a chain-preconditioned f32 PCG solver —
the one major component without an external oracle until round 5. This module
is that oracle: it shares only the residual DEFINITION with the backend
(both must optimize the same objective to be comparable) and nothing else —
numpy/scipy float64 instead of JAX float32, exact sparse Cholesky
(scipy.sparse.linalg.spsolve) of the normal equations instead of
matrix-free chain-PCG, and central-difference Jacobians instead of the
backend's analytic Jr^-1~I linearization. Agreement between the two says the
PCG solution is the graph's optimum, not an underconverged iterate.

Scope: the pose slice (odometry + loop between factors, GPS position priors,
gauge prior, Cauchy-robust IRLS loops — the same robust model) over the
active nodes. IMU/vel/bias factors are outside the oracle (their own parity
is FD-tested at the factor level in test_backend_inertial.py).

Everything here is host numpy. This is the PyTorch port's copy of
`pointcloud_slam_tpu/models/liosam/oracle_backend.py` (importing that one
imports jax through its package); `extract_pose_slice` also takes a pose
graph of tensors on any device and reads back the fields it needs.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
import scipy.sparse.linalg as spla


# ---------------------------------------------------------------- numpy so3

def _hat(v):
    return np.array([
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ])


def so3_exp(w):
    th = float(np.linalg.norm(w))
    K = _hat(w)
    if th < 1e-12:
        return np.eye(3) + K + 0.5 * (K @ K)
    return np.eye(3) + np.sin(th) / th * K + (1.0 - np.cos(th)) / th**2 * (K @ K)


def so3_log(R):
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    th = float(np.arccos(c))
    if th < 1e-9:
        return 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th / (2.0 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    )


# ---------------------------------------------------------------- residuals

def _between_residual(Ri, ti, Rj, tj, Rm, tm):
    """e = [Log(Rm^T Ri^T Rj), Rm^T (Ri^T (tj - ti) - tm)] — the backend's
    between-factor model (backend.py _between_residual)."""
    R_ij = Ri.T @ Rj
    t_ij = Ri.T @ (tj - ti)
    return np.concatenate([so3_log(Rm.T @ R_ij), Rm.T @ (t_ij - tm)])


def _retract(R, t, dx):
    """Right perturbation, the backend's retraction: R' = R Exp(dr),
    t' = t + R dt."""
    return R @ so3_exp(dx[0:3]), t + R @ dx[3:6]


def _fd_jacobians(Ri, ti, Rj, tj, Rm, tm, eps=1e-6):
    """(6, 6) central-difference Jacobians wrt the right perturbations of
    node i and node j — numerically independent of the backend's analytic
    adjoint formulas."""
    Ji = np.empty((6, 6))
    Jj = np.empty((6, 6))
    for k in range(6):
        d = np.zeros(6)
        d[k] = eps
        Rp, tp = _retract(Ri, ti, d)
        Rn, tn = _retract(Ri, ti, -d)
        Ji[:, k] = (
            _between_residual(Rp, tp, Rj, tj, Rm, tm)
            - _between_residual(Rn, tn, Rj, tj, Rm, tm)
        ) / (2 * eps)
        Rp, tp = _retract(Rj, tj, d)
        Rn, tn = _retract(Rj, tj, -d)
        Jj[:, k] = (
            _between_residual(Ri, ti, Rp, tp, Rm, tm)
            - _between_residual(Ri, ti, Rn, tn, Rm, tm)
        ) / (2 * eps)
    return Ji, Jj


# ------------------------------------------------------------------- solver

def _host(v):
    """A numpy view of a graph field: tensors (any device) are read back."""
    return v.detach().cpu().numpy() if torch.is_tensor(v) else v


def extract_pose_slice(g, n=None):
    """PoseGraph -> plain f64 dict (host copy) of the pose-slice factors."""
    n = int(g.n) if n is None else n
    nl = int(g.n_loops)
    return {
        "R": np.asarray(_host(g.R[:n]), np.float64),
        "t": np.asarray(_host(g.t[:n]), np.float64),
        "odom_R": np.asarray(_host(g.odom_R[:n]), np.float64),
        "odom_t": np.asarray(_host(g.odom_t[:n]), np.float64),
        "odom_info": np.asarray(_host(g.odom_info[:n]), np.float64),
        "loop_i": np.asarray(_host(g.loop_i[:nl]), np.int64),
        "loop_j": np.asarray(_host(g.loop_j[:nl]), np.int64),
        "loop_R": np.asarray(_host(g.loop_R[:nl]), np.float64),
        "loop_t": np.asarray(_host(g.loop_t[:nl]), np.float64),
        "loop_info": np.asarray(_host(g.loop_info[:nl]), np.float64),
        "loop_robust": np.asarray(_host(g.loop_robust[:nl]), bool),
        "gps_mask": np.asarray(_host(g.prior_mask[:n]), bool),
        "gps_pos": np.asarray(_host(g.prior_pos[:n]), np.float64),
        "gps_info": np.asarray(_host(g.prior_info[:n]), np.float64),
    }


def chi2(d, R, t, cauchy_c=1.0):
    """Robust objective value at (R, t): sum over factors of rho(e^T W e),
    rho = identity for plain factors and the Cauchy M-estimator
    c^2 log(1 + s/c^2) for robust loops (whose IRLS weight in both solvers
    is w = c^2/(c^2+s), the stationary condition of this rho). GPS position
    priors included; the gauge prior pins node 0 and contributes 0 at it."""
    n = len(d["t"])
    total = 0.0
    for k in range(1, n):
        e = _between_residual(R[k - 1], t[k - 1], R[k], t[k], d["odom_R"][k], d["odom_t"][k])
        total += float(e @ (d["odom_info"][k] * e))
    c2 = cauchy_c**2
    for li, lj, Rm, tm, info, rob in zip(
        d["loop_i"], d["loop_j"], d["loop_R"], d["loop_t"], d["loop_info"], d["loop_robust"]
    ):
        e = _between_residual(R[li], t[li], R[lj], t[lj], Rm, tm)
        s = float(e @ (info * e))
        total += c2 * np.log1p(s / c2) if rob else s
    for k in np.nonzero(d["gps_mask"])[0]:
        r = R[k].T @ (d["gps_pos"][k] - t[k])
        total += float(r @ (d["gps_info"][k] * r))
    return total


def solve(d, iters=30, gauge_info=1e8, cauchy_c=1.0, tol=1e-10):
    """Gauss-Newton in float64 with exact sparse solves. Returns
    (R (n,3,3), t (n,3), chi2_history list)."""
    R = d["R"].copy()
    t = d["t"].copy()
    n = len(t)
    history = [chi2(d, R, t, cauchy_c)]
    c2 = cauchy_c**2
    for _ in range(iters):
        rows_i, rows_j, blocks_i, blocks_j, errs, winfos = [], [], [], [], [], []
        # odometry between factors
        for k in range(1, n):
            e = _between_residual(R[k - 1], t[k - 1], R[k], t[k], d["odom_R"][k], d["odom_t"][k])
            Ji, Jj = _fd_jacobians(R[k - 1], t[k - 1], R[k], t[k], d["odom_R"][k], d["odom_t"][k])
            rows_i.append(k - 1); rows_j.append(k)
            blocks_i.append(Ji); blocks_j.append(Jj)
            errs.append(e); winfos.append(d["odom_info"][k])
        # loop between factors with the same Cauchy IRLS reweighting
        for li, lj, Rm, tm, info, rob in zip(
            d["loop_i"], d["loop_j"], d["loop_R"], d["loop_t"], d["loop_info"], d["loop_robust"]
        ):
            e = _between_residual(R[li], t[li], R[lj], t[lj], Rm, tm)
            w = c2 / (c2 + float(e @ (info * e))) if rob else 1.0
            Ji, Jj = _fd_jacobians(R[li], t[li], R[lj], t[lj], Rm, tm)
            rows_i.append(int(li)); rows_j.append(int(lj))
            blocks_i.append(Ji); blocks_j.append(Jj)
            errs.append(e); winfos.append(info * w)
        F = len(errs)
        data = np.concatenate([np.stack(blocks_i), np.stack(blocks_j)])  # (2F, 6, 6)
        r_idx = np.repeat(np.arange(F) * 6, 36).reshape(-1, 6, 6) + np.arange(6)[None, :, None]
        r_idx = np.concatenate([r_idx, r_idx])
        c_base = np.concatenate([np.asarray(rows_i), np.asarray(rows_j)]) * 6
        c_idx = c_base[:, None, None] + np.arange(6)[None, None, :]
        c_idx = np.broadcast_to(c_idx, data.shape)
        J = sp.coo_matrix(
            (data.ravel(), (r_idx.ravel(), c_idx.ravel())), shape=(6 * F, 6 * n)
        ).tocsr()
        e_all = np.concatenate(errs)
        w_all = np.concatenate(winfos)
        W = sp.diags(w_all)
        H = (J.T @ W @ J).tolil()
        b = J.T @ (w_all * e_all)
        # GPS position priors: residual r = R^T (p - t), d r / d dt = -I
        for k in np.nonzero(d["gps_mask"])[0]:
            r = R[k].T @ (d["gps_pos"][k] - t[k])
            gi = d["gps_info"][k]
            H[6 * k + 3 : 6 * k + 6, 6 * k + 3 : 6 * k + 6] += np.diag(gi)
            b[6 * k + 3 : 6 * k + 6] += -gi * r
        # gauge prior on node 0 + tiny regularization
        for a in range(6):
            H[a, a] += gauge_info
        H = H.tocsr() + sp.eye(6 * n) * 1e-9
        dx = spla.spsolve(H, -b)
        for k in range(n):
            R[k], t[k] = _retract(R[k], t[k], dx[6 * k : 6 * (k + 1)])
        history.append(chi2(d, R, t, cauchy_c))
        if abs(history[-2] - history[-1]) <= tol * max(history[-2], 1.0):
            break
    return R, t, history
