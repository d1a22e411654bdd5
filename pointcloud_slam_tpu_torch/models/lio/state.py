"""24-dim navigation state on the manifold, 23-DoF error state
(port of `pointcloud_slam_tpu/models/lio/state.py`).

Error-state index layout (23):
  pos 0:3 | rot 3:6 | ext_R 6:9 | ext_t 9:12 | vel 12:15 | bg 15:18
  | ba 18:21 | grav 21:23 (S2 tangent, 2-DoF)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...geom import s2, so3

DOF = 23

# error-state block offsets
POS, ROT, EXT_R, EXT_T, VEL, BG, BA, GRAV = 0, 3, 6, 9, 12, 15, 18, 21


class NavState(NamedTuple):
    pos: torch.Tensor    # (3,) world position of IMU
    rot: torch.Tensor    # (3, 3) world <- IMU rotation
    ext_R: torch.Tensor  # (3, 3) IMU <- lidar rotation (offset_R_L_I)
    ext_t: torch.Tensor  # (3,) IMU <- lidar translation (offset_T_L_I)
    vel: torch.Tensor    # (3,) world velocity
    bg: torch.Tensor     # (3,) gyro bias
    ba: torch.Tensor     # (3,) accel bias
    grav: torch.Tensor   # (3,) gravity vector (S2, |grav| = 9.809)


def identity(dtype=torch.float32, gravity: float = s2.GRAVITY, device=None) -> NavState:
    z = torch.zeros(3, dtype=dtype, device=device)
    grav = torch.zeros(3, dtype=dtype, device=device)
    grav[2].fill_(-gravity)
    eye = torch.eye(3, dtype=dtype, device=device)
    return NavState(pos=z, rot=eye, ext_R=eye.clone(), ext_t=z.clone(), vel=z.clone(),
                    bg=z.clone(), ba=z.clone(), grav=grav)


def boxplus(s: NavState, dx: torch.Tensor) -> NavState:
    """s [+] dx with the 23-dim error vector (MTK right-multiplicative SO3,
    S2 tangent retraction for gravity)."""
    return NavState(
        pos=s.pos + dx[POS:POS + 3],
        rot=s.rot @ so3.exp(dx[ROT:ROT + 3]),
        ext_R=s.ext_R @ so3.exp(dx[EXT_R:EXT_R + 3]),
        ext_t=s.ext_t + dx[EXT_T:EXT_T + 3],
        vel=s.vel + dx[VEL:VEL + 3],
        bg=s.bg + dx[BG:BG + 3],
        ba=s.ba + dx[BA:BA + 3],
        grav=s2.boxplus(s.grav, dx[GRAV:GRAV + 2]),
    )


def boxminus(a: NavState, b: NavState) -> torch.Tensor:
    """23-dim dx with b [+] dx == a."""
    return torch.cat(
        [
            a.pos - b.pos,
            so3.boxminus(a.rot, b.rot),
            so3.boxminus(a.ext_R, b.ext_R),
            a.ext_t - b.ext_t,
            a.vel - b.vel,
            a.bg - b.bg,
            a.ba - b.ba,
            s2.boxminus(a.grav, b.grav),
        ]
    )


def where(cond: torch.Tensor, a: NavState, b: NavState) -> NavState:
    """Field-wise torch.where(cond, a, b) (the JAX package's tree.map of jnp.where)."""
    return NavState(*(torch.where(cond, x, y) for x, y in zip(a, b)))
