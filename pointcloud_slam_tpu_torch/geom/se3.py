"""SE(3) operations (port of `pointcloud_slam_tpu/geom/se3.py`).

Pose representation: a pair (R: (..., 3, 3), t: (..., 3)). The 6-dim
tangent ordering is [rot(3), trans(3)].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import so3


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


class Pose(NamedTuple):
    """Rigid transform world <- local."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        """Transform an SoA cloud (..., 3, N) -> (..., 3, N)."""
        return self.R @ pts + self.t[..., :, None]

    def compose(self, other: "Pose") -> "Pose":
        return Pose(self.R @ other.R, _mv(self.R, other.t) + self.t)

    def inverse(self) -> "Pose":
        Rt = self.R.transpose(-1, -2)
        return Pose(Rt, -_mv(Rt, self.t))

    @property
    def matrix(self) -> torch.Tensor:
        """Homogeneous (..., 4, 4)."""
        bottom = torch.zeros(self.t.shape[:-1] + (1, 4), dtype=self.t.dtype, device=self.t.device)
        bottom[..., 0, 3].fill_(1.0)
        return torch.cat([torch.cat([self.R, self.t[..., :, None]], dim=-1), bottom], dim=-2)


def identity(dtype=torch.float32, batch=(), device=None) -> Pose:
    R = torch.eye(3, dtype=dtype, device=device).expand(tuple(batch) + (3, 3))
    t = torch.zeros(tuple(batch) + (3,), dtype=dtype, device=device)
    return Pose(R, t)


def from_matrix(M: torch.Tensor) -> Pose:
    return Pose(M[..., :3, :3], M[..., :3, 3])


def exp(xi: torch.Tensor) -> Pose:
    """xi = [omega(3), v(3)] -> Pose. Uses the full SE(3) exponential."""
    omega, v = xi[..., :3], xi[..., 3:]
    R = so3.exp(omega)
    V = so3.A_matrix(omega)  # left Jacobian doubles as the V matrix
    return Pose(R, _mv(V, v))


def retract_left(p: Pose, xi: torch.Tensor) -> Pose:
    """Left-multiplicative update used by the LM solver: p' = exp_approx(xi) * p
    (rotation applied exactly via SO(3) exp, translation added directly)."""
    dR = so3.exp(xi[..., :3])
    return Pose(dR @ p.R, _mv(dR, p.t) + xi[..., 3:])


def log(p: Pose) -> torch.Tensor:
    omega = so3.log(p.R)
    V = so3.A_matrix(omega)
    v = torch.linalg.solve_ex(V, p.t[..., None])[0][..., 0]
    return torch.cat([omega, v], dim=-1)


def boxminus(a: Pose, b: Pose) -> torch.Tensor:
    """Left-tangent difference: xi with retract_left(b, xi) ~= a (exact for R)."""
    dR = a.R @ b.R.transpose(-1, -2)
    return torch.cat([so3.log(dR), a.t - _mv(dR, b.t)], dim=-1)
