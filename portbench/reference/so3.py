"""SO(3) operations, batched (port of `pointcloud_slam_tpu/geom/so3.py`).

All functions accept arbitrary leading batch dimensions (trailing (3,) for
tangent vectors, (3, 3) for rotation matrices) and run on the device of
their inputs.

Frozen copy, for the benchmark's plain reference, of
`pointcloud_slam_tpu_torch/geom/so3.py` at commit 9c22c1c.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w: hat(w) @ v == cross(w, v). (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat. (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta2: torch.Tensor):
    """(sin t / t, (1 - cos t) / t^2) with small-angle Taylor fallback."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    return a, b


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' exponential map. (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b = _sinc_coeffs(theta2)
    W = hat(w)
    WW = W @ W
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * WW


def log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map (rotation matrix -> axis-angle). (..., 3, 3) -> (..., 3).

    Valid for angles in [0, pi); near pi uses the symmetric-part fallback.
    """
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    axis_sin = 0.5 * vee(R - R.transpose(-1, -2))
    sin_theta = torch.sqrt(torch.sum(axis_sin * axis_sin, dim=-1) + 1e-30)
    theta = torch.atan2(sin_theta, cos_theta)
    small = theta < 1e-5
    near_pi = theta > 3.0
    one = torch.ones_like(theta)
    scale = torch.where(small, 1.0 + theta * theta / 6.0, theta / torch.where(sin_theta == 0, one, sin_theta))
    w_generic = scale[..., None] * axis_sin
    B = (R + R.transpose(-1, -2)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    denom = torch.where(torch.abs(1.0 - cos_theta) < _EPS, one, 1.0 - cos_theta)
    u2 = torch.clamp((diag - cos_theta[..., None]) / denom[..., None], 0.0, 1.0)
    u = torch.sqrt(u2)
    sgn = torch.where(axis_sin >= 0, torch.ones_like(axis_sin), -torch.ones_like(axis_sin))
    off = torch.stack(
        [
            torch.ones_like(u[..., 0]),
            torch.where(B[..., 0, 1] >= 0, one, -one),
            torch.where(B[..., 0, 2] >= 0, one, -one),
        ],
        dim=-1,
    )
    use_off = torch.abs(axis_sin).amax(dim=-1, keepdim=True) < 1e-6
    sgn = torch.where(use_off, off, sgn)
    w_pi = theta[..., None] * u * sgn
    return torch.where(near_pi[..., None], w_pi, w_generic)


def A_matrix(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of the exponential map (MTK's `A_matrix`).

    A(w) = I + (1-cos t)/t^2 * hat(w) + (t - sin t)/t^3 * hat(w)^2
    """
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta))
    W = hat(w)
    WW = W @ W
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * WW


def boxplus(R: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Right-multiplicative retraction: R' = R @ exp(delta) (MTK SO3 boxplus)."""
    return R @ exp(delta)


def boxminus(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """delta with Rb @ exp(delta) == Ra."""
    return log(Rb.transpose(-1, -2) @ Ra)
