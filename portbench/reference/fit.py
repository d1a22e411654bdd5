"""Batched geometric fitting primitives (port of `pointcloud_slam_tpu/geom/fit.py`):
plane fit, LOAM line fit, the closed-form 3x3 symmetric eigendecomposition
and solve, and the fixed-sweep Jacobi `eigh_small` for small matrices.

Point blocks are (3, K, N) — coordinate axis leading, the big point axis
minor. All solves are closed-form component arithmetic on (N,) tensors; no
batched LAPACK call sits on the hot path.

Frozen copy, for the benchmark's plain reference, of
`pointcloud_slam_tpu_torch/geom/fit.py` at commit 9c22c1c.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _eigvals3x3(a00, a01, a02, a11, a12, a22):
    """Cardano eigenvalues of symmetric 3x3 given by components. Ascending (3 tensors)."""
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    inv_p = 1.0 / p
    c00, c11, c22 = b00 * inv_p, b11 * inv_p, b22 * inv_p
    c01, c02, c12 = a01 * inv_p, a02 * inv_p, a12 * inv_p
    detB = (
        c00 * (c11 * c22 - c12 * c12)
        - c01 * (c01 * c22 - c12 * c02)
        + c02 * (c01 * c12 - c11 * c02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    two_p = 2.0 * p
    lam_max = q + two_p * torch.cos(phi)
    lam_min = q + two_p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min
    iso = p2 < _EPS
    lam_min = torch.where(iso, q, lam_min)
    lam_mid = torch.where(iso, q, lam_mid)
    lam_max = torch.where(iso, q, lam_max)
    return lam_min, lam_mid, lam_max


def _eigvec3x3(a00, a01, a02, a11, a12, a22, lam):
    """Eigenvector for eigenvalue lam: largest cross product of rows of (A - lam I)."""
    m00, m11, m22 = a00 - lam, a11 - lam, a22 - lam
    c01x = a01 * a12 - a02 * m11
    c01y = a02 * a01 - m00 * a12
    c01z = m00 * m11 - a01 * a01
    c02x = a01 * m22 - a02 * a12
    c02y = a02 * a02 - m00 * m22
    c02z = m00 * a12 - a01 * a02
    c12x = m11 * m22 - a12 * a12
    c12y = a12 * a02 - a01 * m22
    c12z = a01 * a12 - m11 * a02
    n01 = c01x * c01x + c01y * c01y + c01z * c01z
    n02 = c02x * c02x + c02y * c02y + c02z * c02z
    n12 = c12x * c12x + c12y * c12y + c12z * c12z
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = (~use01) & (n02 >= n12)
    vx = torch.where(use01, c01x, torch.where(use02, c02x, c12x))
    vy = torch.where(use01, c01y, torch.where(use02, c02y, c12y))
    vz = torch.where(use01, c01z, torch.where(use02, c02z, c12z))
    nrm2 = torch.clamp(vx * vx + vy * vy + vz * vz, min=_EPS)
    degenerate = nrm2 <= _EPS * 2
    vx = torch.where(degenerate, torch.ones_like(vx), vx)
    vy = torch.where(degenerate, torch.zeros_like(vy), vy)
    vz = torch.where(degenerate, torch.zeros_like(vz), vz)
    inv = 1.0 / torch.sqrt(torch.clamp(vx * vx + vy * vy + vz * vz, min=_EPS))
    return vx * inv, vy * inv, vz * inv


def eigh3x3_soa(a00, a01, a02, a11, a12, a22):
    """Full analytic eigendecomposition from components, each (...,).

    Returns (vals (3, ...) ascending, vecs (3, 3, ...)) where vecs[i] is the
    i-th eigenvector (ascending) and vecs[i][c] its c-th component.
    """
    lmin, lmid, lmax = _eigvals3x3(a00, a01, a02, a11, a12, a22)
    v0 = _eigvec3x3(a00, a01, a02, a11, a12, a22, lmin)
    v2 = _eigvec3x3(a00, a01, a02, a11, a12, a22, lmax)
    # orthogonalize v2 against v0 (repeated eigenvalue robustness)
    dot = v2[0] * v0[0] + v2[1] * v0[1] + v2[2] * v0[2]
    w = tuple(v2[i] - dot * v0[i] for i in range(3))
    wn2 = w[0] ** 2 + w[1] ** 2 + w[2] ** 2
    # fallback: any vector orthogonal to v0
    zero = torch.zeros_like(v0[0])
    alt = (-v0[1], v0[0], zero)
    altn2 = alt[0] ** 2 + alt[1] ** 2
    alt2 = (-v0[2], zero, v0[0])
    use_alt2 = altn2 < 1e-12
    alt = tuple(torch.where(use_alt2, alt2[i], alt[i]) for i in range(3))
    altn2 = torch.where(use_alt2, alt[0] ** 2 + alt[2] ** 2, altn2)
    bad = wn2 < 1e-12
    w = tuple(torch.where(bad, alt[i], w[i]) for i in range(3))
    wn2 = torch.where(bad, altn2, wn2)
    inv = 1.0 / torch.sqrt(torch.clamp(wn2, min=_EPS))
    v2 = tuple(w[i] * inv for i in range(3))
    # middle = v2 x v0
    v1 = (
        v2[1] * v0[2] - v2[2] * v0[1],
        v2[2] * v0[0] - v2[0] * v0[2],
        v2[0] * v0[1] - v2[1] * v0[0],
    )
    vals = torch.stack([lmin, lmid, lmax], dim=0)
    vecs = torch.stack([torch.stack(v0, 0), torch.stack(v1, 0), torch.stack(v2, 0)], dim=0)
    return vals, vecs



def solve3x3_sym(a00, a01, a02, a11, a12, a22, bx, by, bz):
    """Closed-form (adjugate) solve of a symmetric 3x3 system, component tensors.

    Returns (x, y, z, det). Caller decides what to do with tiny determinants.
    """
    i00 = a11 * a22 - a12 * a12
    i01 = a02 * a12 - a01 * a22
    i02 = a01 * a12 - a02 * a11
    i11 = a00 * a22 - a02 * a02
    i12 = a01 * a02 - a00 * a12
    i22 = a00 * a11 - a01 * a01
    det = a00 * i00 + a01 * i01 + a02 * i02
    inv_det = 1.0 / torch.where(torch.abs(det) < _EPS, torch.full_like(det, _EPS), det)
    x = (i00 * bx + i01 * by + i02 * bz) * inv_det
    y = (i01 * bx + i11 * by + i12 * bz) * inv_det
    z = (i02 * bx + i12 * by + i22 * bz) * inv_det
    return x, y, z, det


def plane_fit(pts: torch.Tensor, mask: torch.Tensor, threshold: float = 0.1, min_pts: int = 3):
    """Fit plane n.p + d = 0 by solving A n = -1 (reference esti_plane).

    pts: (3, K, ...), mask: (K, ...) boolean validity.
    Returns (coef (4, ...) = [n_hat, d_hat] with |n_hat| = 1, valid (...,)).
    `valid` requires >= min_pts points and every masked point within
    `threshold` of the plane.
    """
    m = mask.to(pts.dtype)
    px, py, pz = pts[0] * m, pts[1] * m, pts[2] * m
    a00 = torch.sum(px * px, dim=0) + 1e-6
    a01 = torch.sum(px * py, dim=0)
    a02 = torch.sum(px * pz, dim=0)
    a11 = torch.sum(py * py, dim=0) + 1e-6
    a12 = torch.sum(py * pz, dim=0)
    a22 = torch.sum(pz * pz, dim=0) + 1e-6
    bx = -torch.sum(px, dim=0)
    by = -torch.sum(py, dim=0)
    bz = -torch.sum(pz, dim=0)
    nx, ny, nz, det = solve3x3_sym(a00, a01, a02, a11, a12, a22, bx, by, bz)
    finite = torch.isfinite(nx) & torch.isfinite(ny) & torch.isfinite(nz)
    zero = torch.zeros_like(nx)
    nx = torch.where(finite, nx, zero)
    ny = torch.where(finite, ny, zero)
    nz = torch.where(finite, nz, zero)
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    inv_norm = 1.0 / torch.clamp(norm, min=_EPS)
    nx, ny, nz = nx * inv_norm, ny * inv_norm, nz * inv_norm
    d = inv_norm
    coef = torch.stack([nx, ny, nz, d], dim=0)
    resid = torch.abs(pts[0] * nx[None] + pts[1] * ny[None] + pts[2] * nz[None] + d[None])
    ok_resid = torch.all(~mask | (resid <= threshold), dim=0)
    enough = torch.sum(mask, dim=0) >= min_pts
    valid = ok_resid & enough & finite & (norm > _EPS)
    return coef, valid
