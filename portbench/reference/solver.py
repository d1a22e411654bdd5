"""Shared Gauss-Newton SE(3) solver steps: the benchmark's plain reference.
A frozen copy of `pointcloud_slam_tpu_torch/register/solver.py` at commit
9c22c1c, with the eigendecomposition `torch.linalg.eigh` and the solvers
that NDT does not call left out.

Reference: fast_gicp `lsq_registration_impl.hpp` (`step_gn`, `step_lm`: LM
with rho-ratio accept, lambda *= max(1/3, 1-(2rho-1)^3) on accept,
lambda *= nu, nu *= 2 on reject; convergence on rotation/translation
epsilon) and the LOAM degeneracy guard (`mapOptmization.cpp:1508-1536`).

The user supplies `linearize(pose) -> (H (6, 6), b (6,), err ())` with the
6-dim tangent ordered [rot, trans] and a LEFT-multiplicative retraction
(`se3.retract_left`), and optionally `error(pose) -> err ()` for LM's
re-evaluation.

Fixed trip counts with `done` masks, as in the JAX package: every loop runs
its full length and freezes the pose after convergence, so a solve never
reads a device value on the host. The solves also take a leading batch
dimension ((B, 6, 6), (B, 6)): the batched ICP's `vmap` is that dimension.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import se3


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    max_iterations: int = 30
    lm_max_inner: int = 6
    init_lambda_factor: float = 1e-9
    rotation_epsilon: float = 2e-3
    translation_epsilon: float = 5e-4
    # degeneracy guard: eigenvalues of H below this are projected out of the
    # update (mapOptmization.cpp LMOptimization's isDegenerate path). <= 0 disables.
    degeneracy_threshold: float = 0.0


class SolveResult(NamedTuple):
    pose: se3.Pose
    iterations: torch.Tensor  # int32, iterations actually applied
    converged: torch.Tensor   # bool
    final_error: torch.Tensor
    H: torch.Tensor           # (6, 6) last linearization


def _chol_solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD A (..., 6, 6), b (..., 6): one batched
    `cholesky_ex` (no host-side check of its info) and two triangular solves.

    The JAX package unrolls a scalar Cholesky with pivots clamped at 1e-20
    (a batched-LAPACK call costs ~1-2 ms on a TPU); eagerly that would be
    ~150 one-element launches per solve. Where A is not positive definite in
    float32 (info > 0, not reachable with the 1e-6 ridge of `_solve_step` on
    a PSD H) the step is 0, a frozen pose, where the clamped pivots give a
    huge finite step."""
    L, info = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
    return torch.where((info == 0)[..., None], x, 0.0)


def degeneracy_projection(H: torch.Tensor, threshold: float):
    """(degenerate, P) for the LOAM degeneracy guard: P projects an update out
    of the eigendirections of H whose eigenvalue is below `threshold`. With
    eigenvalues ascending, the reference's zero-trailing-rows-until-first-keep
    loop is exactly `keep = w > threshold`.

    Every default config has `degeneracy_threshold=0.0`, so
    `inline_projection` keeps this off the solve path."""
    w, V = torch.linalg.eigh(H)
    keep = (w > threshold).to(H.dtype)
    P = (V * keep[..., None, :]) @ V.mT
    return torch.any(w <= threshold, dim=-1), P


def inline_projection(H: torch.Tensor, threshold: float):
    """Per-iteration degeneracy projection; None (zero cost) when the guard
    is disabled."""
    return degeneracy_projection(H, threshold) if threshold > 0 else None


def _solve_step(H: torch.Tensor, b: torch.Tensor, lam, proj=None) -> torch.Tensor:
    """Solve (H + lam*I) d = -b; `proj` is an optional (degenerate, P) pair
    from `degeneracy_projection` applied to the update (None = guard off).
    `lam` is a Python number or a tensor of H's batch shape.

    The 1e-6 ridge keeps the solve finite when a frame has no valid
    correspondences at all (H = b = 0 -> d = 0, a frozen pose)."""
    ridge = lam + 1e-6
    if torch.is_tensor(ridge):
        ridge = ridge[..., None, None]
    A = H + ridge * torch.eye(6, dtype=H.dtype, device=H.device)
    d = _chol_solve6(A, -b)
    if proj is not None:
        degenerate, P = proj
        d = torch.where(degenerate[..., None], (P @ d[..., None])[..., 0], d)
    return d


def _converged(d: torch.Tensor, cfg: SolverConfig) -> torch.Tensor:
    return ((d[..., :3].abs().amax(dim=-1) < cfg.rotation_epsilon)
            & (d[..., 3:].abs().amax(dim=-1) < cfg.translation_epsilon))


def _select(keep: torch.Tensor, a: se3.Pose, b: se3.Pose) -> se3.Pose:
    """Pose a where `keep` (batch-shaped bool), else b."""
    return se3.Pose(torch.where(keep[..., None, None], a.R, b.R), torch.where(keep[..., None], a.t, b.t))


def _gn_update(H, b, pose, done, iters, cfg: SolverConfig, lam=0.0):
    """One masked Gauss-Newton update: solve, retract, freeze the converged.
    Returns (pose, done, iters, step)."""
    d = _solve_step(H, b, lam, inline_projection(H, cfg.degeneracy_threshold))
    pose = _select(done, pose, se3.retract_left(pose, d))
    return pose, done | _converged(d, cfg), iters + (~done).to(torch.int32), d


def _start(x0: se3.Pose):
    """(done, iters) for a solve from x0: False and 0 in x0's batch shape."""
    batch = x0.t.shape[:-1]
    return (torch.zeros(batch, dtype=torch.bool, device=x0.t.device),
            torch.zeros(batch, dtype=torch.int32, device=x0.t.device))
