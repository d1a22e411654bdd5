"""SE(3) operations (port of `pointcloud_slam_tpu/geom/se3.py`).

Pose representation: a pair (R: (..., 3, 3), t: (..., 3)). The 6-dim
tangent ordering is [rot(3), trans(3)].

Frozen copy, for the benchmark's plain reference, of
`pointcloud_slam_tpu_torch/geom/se3.py` at commit 9c22c1c.
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



def retract_left(p: Pose, xi: torch.Tensor) -> Pose:
    """Left-multiplicative update used by the LM solver: p' = exp_approx(xi) * p
    (rotation applied exactly via SO(3) exp, translation added directly)."""
    dR = so3.exp(xi[..., :3])
    return Pose(dR @ p.R, _mv(dR, p.t) + xi[..., 3:])



def boxminus(a: Pose, b: Pose) -> torch.Tensor:
    """Left-tangent difference: xi with retract_left(b, xi) ~= a (exact for R)."""
    dR = a.R @ b.R.transpose(-1, -2)
    return torch.cat([so3.log(dR), a.t - _mv(dR, b.t)], dim=-1)
