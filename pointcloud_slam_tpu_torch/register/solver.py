"""Shared Gauss-Newton / Levenberg-Marquardt SE(3) solver (port of
`pointcloud_slam_tpu/register/solver.py`).

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
from typing import Callable, NamedTuple, Optional

import torch

from ..geom import se3
from ..ops import small_eigh


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

    The eigendecomposition is `ops.small_eigh.eigh`: on CUDA tensors one
    launch of kernel K6 and no host read (`torch.linalg.eigh` checks its
    info on the host); on CPU tensors `torch.linalg.eigh`. Every default
    config has `degeneracy_threshold=0.0`, so `inline_projection` keeps this
    off the solve path."""
    w, V = small_eigh.eigh(H)
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


def gauss_newton(linearize: Callable, x0: se3.Pose, cfg: SolverConfig = SolverConfig()) -> SolveResult:
    """Fixed-iteration GN with masked early-out (no update after convergence)."""
    x = x0
    done, iters = _start(x0)
    err = torch.full(x0.t.shape[:-1], float("inf"), dtype=x0.t.dtype, device=x0.t.device)
    H = torch.zeros(x0.t.shape[:-1] + (6, 6), dtype=x0.t.dtype, device=x0.t.device)
    for _ in range(cfg.max_iterations):
        H, b, err = linearize(x)
        x, done, iters, _ = _gn_update(H, b, x, done, iters, cfg)
    return SolveResult(x, iters, done, err, H)


def levenberg_marquardt(
    linearize: Callable,
    x0: se3.Pose,
    cfg: SolverConfig = SolverConfig(),
    error: Optional[Callable] = None,
) -> SolveResult:
    """LM with the reference's rho-ratio lambda schedule, fixed trip counts.

    The JAX package's inner `while_loop` (retry until a step is accepted, at
    most `lm_max_inner` times) runs here all `lm_max_inner` times, with the
    tries after the accepted one masked out: the same result, no host read
    of the accept flag, up to `lm_max_inner` error evaluations per outer
    iteration. The degeneracy guard is an extension (the reference's LM has
    none), off by default."""
    if error is None:
        error = lambda x: linearize(x)[2]
    dt, dev = x0.t.dtype, x0.t.device
    x = x0
    lam = torch.full((), -1.0, dtype=dt, device=dev)
    nu = torch.full((), 2.0, dtype=dt, device=dev)
    done, iters = _start(x0)
    H = torch.zeros((6, 6), dtype=dt, device=dev)
    e = torch.full((), float("inf"), dtype=dt, device=dev)
    for _ in range(cfg.max_iterations):
        H, b, e = linearize(x)
        proj = inline_projection(H, cfg.degeneracy_threshold)
        # lazy lambda init: the first iteration uses init_lambda_factor * max diag
        lam = torch.where(lam < 0, cfg.init_lambda_factor * H.diagonal().abs().amax(), lam)
        accepted = torch.zeros((), dtype=torch.bool, device=dev)
        x_acc, d_acc = x, torch.zeros(6, dtype=dt, device=dev)
        for _ in range(cfg.lm_max_inner):
            live = ~accepted
            d = _solve_step(H, b, lam, proj)
            x_try = se3.retract_left(x, d)
            e_try = error(x_try)
            denom = torch.dot(d, lam * d - b)
            rho = (e - e_try) / torch.where(denom.abs() < 1e-30, 1e-30, denom)
            ok = (rho > 0) & torch.isfinite(e_try)
            lam_next = torch.where(ok, lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0), lam * nu)
            nu_next = torch.where(ok, 2.0, 2.0 * nu)
            take = live & ok
            lam = torch.where(live, lam_next, lam)
            nu = torch.where(live, nu_next, nu)
            x_acc = _select(take, x_try, x_acc)
            d_acc = torch.where(take, d, d_acc)
            accepted = accepted | take
        conv = _converged(d_acc, cfg) | ~accepted
        x = _select(done, x, x_acc)
        iters = iters + (~done).to(torch.int32)
        done = done | conv
    return SolveResult(x, iters, done, e, H)
