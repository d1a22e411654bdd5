"""S2 sphere manifold (gravity direction with fixed magnitude), 2-DoF tangent
(port of `pointcloud_slam_tpu/geom/s2.py`: reference S2.hpp with
`S2<double, 98090, 10000, 1>`, the x-axis singularity chart).

The element is stored as the raw 3-vector `vec` with |vec| == length; all ops
preserve the norm. Functions are batched over leading dims.

Frozen copy, for the benchmark's plain reference, of
`pointcloud_slam_tpu_torch/geom/s2.py` at commit 9c22c1c.
"""

from __future__ import annotations

import math

import torch

from . import so3

GRAVITY = 9.809  # 98090 / 10000, reference use-ikfom.hpp:10
_TOL = 1e-11


def bx(vec: torch.Tensor) -> torch.Tensor:
    """Tangent basis (3, 2), orthonormal, orthogonal to vec. S2_typ == 1 chart."""
    length = torch.linalg.norm(vec, dim=-1)
    v0, v1, v2 = vec[..., 0], vec[..., 1], vec[..., 2]
    denom = length + v0
    one = torch.ones_like(denom)
    safe_denom = torch.where(torch.abs(denom) < _TOL, one, denom)
    b_main = torch.stack(
        [
            torch.stack([-v1, -v2], dim=-1),
            torch.stack([length - v1 * v1 / safe_denom, -v2 * v1 / safe_denom], dim=-1),
            torch.stack([-v2 * v1 / safe_denom, length - v2 * v2 / safe_denom], dim=-1),
        ],
        dim=-2,
    ) / torch.where(length < _TOL, one, length)[..., None, None]
    # singular chart (vec ~ -length * e_x): fixed basis (fill_, not item
    # assignment: a python scalar assigned into a CUDA element is a
    # host-to-device copy that waits for the stream)
    b_sing = torch.zeros_like(b_main)
    b_sing[..., 1, 1].fill_(-1.0)
    b_sing[..., 2, 0].fill_(1.0)
    singular = (denom <= _TOL)[..., None, None]
    return torch.where(singular, b_sing, b_main)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., i, j) x (..., j) -> (..., i)."""
    return (M @ v[..., None])[..., 0]


def boxplus(vec: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """vec' = Exp(Bx(vec) @ delta) @ vec. delta is (..., 2)."""
    Bu = _mv(bx(vec), delta)
    return _mv(so3.exp(Bu), vec)


def boxminus(vec: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """2-dim tangent delta at `other` with other [+] delta == vec (S2.hpp:140-158)."""
    cross = torch.linalg.cross(vec, other, dim=-1)
    v_sin = torch.linalg.norm(cross, dim=-1)
    v_cos = torch.sum(vec * other, dim=-1)
    theta = torch.atan2(v_sin, v_cos)
    Bx_o = bx(other)
    hat_o_v = torch.linalg.cross(other, vec, dim=-1)
    safe_sin = torch.where(v_sin < _TOL, torch.ones_like(v_sin), v_sin)
    res_main = (theta / safe_sin)[..., None] * _mv(Bx_o.transpose(-1, -2), hat_o_v)
    # degenerate: parallel (0) or antiparallel (pi, ill-defined direction)
    res_anti = torch.zeros_like(res_main)
    res_anti[..., 0].fill_(math.pi)
    res_zero = torch.zeros_like(res_main)
    degen = (v_sin < _TOL)[..., None]
    anti = (torch.abs(theta) > _TOL)[..., None]
    return torch.where(degen, torch.where(anti, res_anti, res_zero), res_main)


def nx_yy(vec: torch.Tensor) -> torch.Tensor:
    """N(x, x) projection Jacobian, (2, 3): (1/len^2) Bx^T hat(vec) (S2.hpp:225-229)."""
    length2 = torch.sum(vec * vec, dim=-1)
    BtH = bx(vec).transpose(-1, -2) @ so3.hat(vec)
    return BtH / torch.where(length2 < _TOL, torch.ones_like(length2), length2)[..., None, None]


def mx(vec: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """M(x, delta) retraction Jacobian, (3, 2) (S2.hpp:231-242).

    delta ~ 0:  -hat(vec) @ Bx
    else:       -Exp(Bu) @ hat(vec) @ A(Bu)^T @ Bx,  Bu = Bx @ delta
    """
    Bx = bx(vec)
    Bu = _mv(Bx, delta)
    small = (torch.sum(delta * delta, dim=-1) < _TOL * _TOL)[..., None, None]
    m_small = -so3.hat(vec) @ Bx
    m_big = -so3.exp(Bu) @ so3.hat(vec) @ so3.A_matrix(Bu).transpose(-1, -2) @ Bx
    return torch.where(small, m_small, m_big)
