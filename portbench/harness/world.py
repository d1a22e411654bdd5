"""The benchmark's traffic generator: a closed hall, a sensor walking laps in
it, and the LiDAR sweeps and IMU samples it records, in plain PyTorch on the
run's device.

The hall and the ray cast are copies of `make_box_world` and `ray_cast` of
`pointcloud_slam_tpu_torch/io/synthetic.py` at commit 9c22c1c (numpy there,
torch here, so that a lap is cast on the card); the spinning sweep follows
that file's `spinning_scan` (rings over the vertical field of view, column j
at azimuth pi - (j + 0.5) 2 pi / columns) and extends it: every column is
cast from the sensor's pose at its own time in the sweep, so LIO's
undistortion has real work, or from the pose at the sweep's end for a
deskewed sweep. The lap and its IMU samples are new: a closed ellipse walked
at a fixed period, with a gait's sway, whose IMU readings are the path's
analytic derivatives, so lap after lap joins with no seam.

Everything a run draws comes from one `Lap`: the hall is fixed by the
traffic file (`hall_seed`), and `--seed` picks where on the lap the walk
starts, which way round it goes, and the range noise: the same amount of
work in another order.
"""

from __future__ import annotations

import math
import random
from typing import NamedTuple

import numpy as np
import torch

GRAVITY = 9.809   # the filter's gravity (the reference's S2 length 98090 / 10000)


def make_box_world(seed: int, half=(8.0, 6.0), height=5.0):
    """A closed hall as axis-aligned boxes: the room's inside (floor z = 0,
    ceiling, four walls) and solid boxes on the floor, six square pillars up
    to the ceiling and six crates. Returns (room_lo (3,), room_hi (3,),
    solids (B, 2, 3)) as float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    hx, hy = half
    solids = []
    for k in range(12):
        pillar = k < 6
        w = rng.uniform(0.4, 0.7) if pillar else rng.uniform(0.6, 1.4)
        c = rng.uniform([-hx + 1.0, -hy + 1.0], [hx - 1.0, hy - 1.0])
        if np.abs(c[1]) < 2.6 and np.abs(c[0]) < 4.6:      # keep the walking loop clear
            c[1] = np.sign(c[1] + 1e-9) * rng.uniform(3.2, hy - 0.8)
        top = height if pillar else rng.uniform(0.6, 1.5)
        solids.append([[c[0] - w / 2, c[1] - w / 2, 0.0], [c[0] + w / 2, c[1] + w / 2, top]])
    return np.array([-hx, -hy, 0.0]), np.array([hx, hy, height]), np.asarray(solids)


def ray_cast(world, origin: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Range along each unit ray dirs (N, 3) from origin (N, 3) to the first
    surface of the hall: the nearest solid box entered, else the wall, floor
    or ceiling where the ray leaves the room. float64."""
    room_lo, room_hi, solids = (torch.as_tensor(a, dtype=torch.float64, device=dirs.device) for a in world)
    d = torch.where(dirs.abs() < 1e-12, torch.full_like(dirs, 1e-12), dirs)
    inv = 1.0 / d
    t_room = torch.amin(torch.maximum((room_lo - origin) * inv, (room_hi - origin) * inv), dim=1)
    a = (solids[None, :, 0, :] - origin[:, None, :]) * inv[:, None, :]
    b = (solids[None, :, 1, :] - origin[:, None, :]) * inv[:, None, :]
    t_near = torch.amax(torch.minimum(a, b), dim=2)
    t_far = torch.amin(torch.maximum(a, b), dim=2)
    t_box = torch.where((t_near <= t_far) & (t_near > 0), t_near, torch.full_like(t_near, math.inf))
    return torch.minimum(t_room, torch.amin(t_box, dim=1))


def _rot_zyx(yaw, pitch, roll):
    """R = Rz(yaw) Ry(pitch) Rx(roll), batched over the inputs' shape: (..., 3, 3)."""
    cy, sy, cp, sp, cr, sr = (f(x) for x in (yaw, pitch, roll) for f in (torch.cos, torch.sin))
    return torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        torch.stack([-sp, cp * sr, cp * cr], -1),
    ], -2)


class Lap(NamedTuple):
    """One walk round the lap, fixed by the traffic file and the seed."""

    period_s: float       # one lap
    semi_axes: tuple      # (a, b) of the ellipse, metres
    height: float         # IMU height above the floor, metres
    bob: tuple            # (metres, Hz) of the gait's vertical bob
    sway: tuple           # (roll rad, pitch rad, Hz) of the gait's sway
    yaw_wobble: float     # amplitude (rad) of the yaw's twice-a-lap wobble
    start_s: float        # where on the lap the walk starts (seconds into it)
    direction: float      # +1 or -1


def make_lap(traffic: dict, seed: int) -> Lap:
    """The lap of a traffic file, with its start and direction drawn from the
    seed. The start is a whole number of sweeps into the lap, so every seed
    walks the same sweeps in another order."""
    rng = random.Random(seed)
    period, sweep = traffic["lap_period_s"], traffic["sweep_s"]
    n = round(period / sweep)
    return Lap(period_s=period, semi_axes=tuple(traffic["lap_semi_axes_m"]), height=traffic["imu_height_m"],
               bob=tuple(traffic["gait_bob"]), sway=tuple(traffic["gait_sway"]),
               yaw_wobble=traffic["yaw_wobble_rad"], start_s=rng.randrange(n) * sweep,
               direction=1.0 if rng.random() < 0.5 else -1.0)


def imu_state(lap: Lap, t: torch.Tensor):
    """The IMU's true state at walk times t (any shape, float64): (R (..., 3, 3)
    world <- IMU, p (..., 3), acc (..., 3) specific force in the IMU frame,
    gyro (..., 3) body rate). Closed form: the lap and its derivatives are
    periodic in `period_s`."""
    a, b = lap.semi_axes
    w = 2.0 * math.pi / lap.period_s
    u = lap.direction * w
    phi = u * (t + lap.start_s)                      # lap angle
    zb, fb = lap.bob
    rr, pr, fs = lap.sway
    wb, ws = 2.0 * math.pi * fb, 2.0 * math.pi * fs
    tt = t + lap.start_s
    x, y = a * torch.sin(phi), -b * torch.cos(phi)
    z = lap.height + zb * torch.sin(wb * tt)
    ddx, ddy = -a * u * u * torch.sin(phi), b * u * u * torch.cos(phi)
    ddz = -zb * wb * wb * torch.sin(wb * tt)
    yaw = phi + lap.yaw_wobble * torch.sin(2.0 * phi)
    dyaw = u * (1.0 + 2.0 * lap.yaw_wobble * torch.cos(2.0 * phi))
    roll, droll = rr * torch.sin(ws * tt), rr * ws * torch.cos(ws * tt)
    pitch, dpitch = pr * torch.sin(ws * tt + 1.0), pr * ws * torch.cos(ws * tt + 1.0)
    R = _rot_zyx(yaw, pitch, roll)
    acc_w = torch.stack([ddx, ddy, ddz + GRAVITY], -1)          # specific force in the world
    acc = (R.transpose(-1, -2) @ acc_w[..., None])[..., 0]
    gyro = torch.stack([droll - dyaw * torch.sin(pitch),
                        dpitch * torch.cos(roll) + dyaw * torch.cos(pitch) * torch.sin(roll),
                        -dpitch * torch.sin(roll) + dyaw * torch.cos(pitch) * torch.cos(roll)], -1)
    return R, torch.stack([x, y, z], -1), acc, gyro


class Sensor(NamedTuple):
    rings: int
    columns: int
    fov_deg: tuple        # (lowest ring, highest ring), degrees
    min_range_m: float    # points nearer than this are masked (blind / min_range)
    noise_m: float        # range noise, 1 sigma
    ext_t: tuple          # lidar origin in the IMU frame (the config's extrinsic; rotation identity)


def sensor_from_config(cfg: dict) -> Sensor:
    s = cfg["sensor"]
    return Sensor(rings=s["rings"], columns=s["columns"], fov_deg=tuple(s["fov_deg"]),
                  min_range_m=s["min_range_m"], noise_m=s["range_noise_m"], ext_t=tuple(s["lidar_in_imu_m"]))


def sensor_rays(sensor: Sensor, device) -> torch.Tensor:
    """Unit ray directions in the sensor frame, ring-major: (rings * columns, 3) float64."""
    elev = torch.deg2rad(torch.linspace(sensor.fov_deg[0], sensor.fov_deg[1], sensor.rings, dtype=torch.float64,
                                        device=device))
    az = math.pi - (torch.arange(sensor.columns, dtype=torch.float64, device=device) + 0.5) * 2.0 * math.pi \
        / sensor.columns
    ce, se = torch.cos(elev)[:, None], torch.sin(elev)[:, None]
    d = torch.stack([ce * torch.cos(az)[None, :], ce * torch.sin(az)[None, :], se.expand(-1, sensor.columns)], -1)
    return d.reshape(-1, 3)


def lidar_pose(lap: Lap, sensor: Sensor, t: torch.Tensor):
    """(R, origin) of the lidar at walk times t: the IMU pose composed with
    the extrinsic (identity rotation)."""
    R, p, _, _ = imu_state(lap, t)
    ext = torch.as_tensor(sensor.ext_t, dtype=torch.float64, device=t.device)
    return R, p + (R @ ext)


def sweeps(world, lap: Lap, sensor: Sensor, t_start: torch.Tensor, sweep_s: float, deskewed: bool,
           gen: torch.Generator):
    """Sweeps beginning at walk times t_start (F,): (points (F, 3, N) float32 in
    the sensor frame, mask (F, N), t_offs (F, N) float32 seconds into the
    sweep). Column j is measured at t_start + j / columns * sweep_s; a
    deskewed sweep casts every column from the pose at the sweep's end, as a
    driver that motion-compensates hands it on."""
    dev = t_start.device
    d_s = sensor_rays(sensor, dev)                                           # (N, 3)
    col_t = torch.arange(sensor.columns, dtype=torch.float64, device=dev) / sensor.columns * sweep_s
    t_offs = col_t.repeat(sensor.rings)                                      # (N,) ring-major
    F, N = t_start.shape[0], d_s.shape[0]
    if deskewed:
        t_cast = (t_start + sweep_s)[:, None].expand(F, sensor.columns)
    else:
        t_cast = t_start[:, None] + col_t[None, :]
    R, o = lidar_pose(lap, sensor, t_cast.reshape(-1))                       # per (frame, column)
    R = R.reshape(F, 1, sensor.columns, 3, 3).expand(F, sensor.rings, sensor.columns, 3, 3).reshape(F * N, 3, 3)
    o = o.reshape(F, 1, sensor.columns, 3).expand(F, sensor.rings, sensor.columns, 3).reshape(F * N, 3)
    dirs = (R @ d_s.repeat(F, 1)[:, :, None])[:, :, 0]
    rng_m = ray_cast(world, o, dirs)
    rng_m = rng_m + sensor.noise_m * torch.randn(rng_m.shape, generator=gen, dtype=torch.float64, device=dev)
    pts = (d_s.repeat(F, 1) * rng_m[:, None]).reshape(F, N, 3).transpose(1, 2)
    mask = (rng_m >= sensor.min_range_m).reshape(F, N)
    return pts.to(torch.float32).contiguous(), mask, t_offs.to(torch.float32).expand(F, N).contiguous()


def imu_samples(lap: Lap, t_start: torch.Tensor, sweep_s: float, per_sweep: int):
    """The IMU samples of sweeps beginning at t_start (F,): each sample is
    stamped at the end of its interval and reads the path's derivatives at
    the interval's middle. Returns (acc (F, M, 3), gyro (F, M, 3), dt (F, M),
    offs (F, M)) float32, offs seconds into the sweep."""
    dt = sweep_s / per_sweep
    k = torch.arange(per_sweep, dtype=torch.float64, device=t_start.device)
    t_mid = t_start[:, None] + (k + 0.5) * dt
    _, _, acc, gyro = imu_state(lap, t_mid)
    offs = ((k + 1.0) * dt).expand(t_start.shape[0], per_sweep)
    return (acc.to(torch.float32), gyro.to(torch.float32), torch.full_like(offs, dt, dtype=torch.float32),
            offs.to(torch.float32).contiguous())


def prior_map(world, density_per_m2: float, noise_m: float, gen: torch.Generator, device) -> torch.Tensor:
    """A prior map of the hall: points drawn uniformly on every visible face
    (the room's six inner faces, five faces of each solid), `density_per_m2`
    on average, with range-like noise; points inside a solid are dropped.
    Returns (3, P) float32."""
    room_lo, room_hi, solids = (torch.as_tensor(a, dtype=torch.float64, device=device) for a in world)
    faces = []                                    # (origin, u, v) rectangles

    def box_faces(lo, hi, with_bottom):
        ex = hi - lo
        for axis in range(3):
            for side in (0, 1):
                if axis == 2 and side == 0 and not with_bottom:
                    continue
                u_ax, v_ax = [a for a in range(3) if a != axis]
                o = lo.clone()
                o[axis] = (lo if side == 0 else hi)[axis]
                u = torch.zeros(3, dtype=torch.float64, device=device)
                v = torch.zeros(3, dtype=torch.float64, device=device)
                u[u_ax], v[v_ax] = ex[u_ax], ex[v_ax]
                faces.append((o, u, v))

    box_faces(room_lo, room_hi, True)
    for s in solids:
        box_faces(s[0], s[1], False)
    pts = []
    for o, u, v in faces:
        area = float(torch.linalg.norm(u) * torch.linalg.norm(v))
        n = max(1, int(round(area * density_per_m2)))
        uv = torch.rand((n, 2), generator=gen, dtype=torch.float64, device=device)
        pts.append(o + uv[:, :1] * u + uv[:, 1:] * v)
    p = torch.cat(pts)
    p = p + noise_m * torch.randn(p.shape, generator=gen, dtype=torch.float64, device=device)
    inside = ((p[:, None, :] > solids[None, :, 0, :] + 1e-3) & (p[:, None, :] < solids[None, :, 1, :] - 1e-3))
    keep = ~inside.all(dim=2).any(dim=1)
    return p[keep].T.to(torch.float32).contiguous()
