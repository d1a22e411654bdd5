"""Synthetic LiDAR world / scan / IMU generators for tests and benchmarks.

Numpy-only copies of the generators in `pointcloud_slam_tpu/io/synthetic.py`
(that module cannot be imported without jax): the same seeds give the same
worlds, trajectories and scans, so the port and the JAX package can be fed
identical data. `simulate_lio_sequence` builds its frames with this
package's `feed.make_frame` on the requested device; `make_feature_world`
and `take_scan` feed the SLAM tests, `chip_smoke.py` and
`apps/run_slam_offline_torch.py`; the hard worlds (`make_corridor_world`,
`make_doorway_world` with `take_scan_occluded`, `moving_object_points`) feed
the degeneracy, doorway and dynamic-object scenarios; `eigh_hard_spectra`
feeds the small-eigh kernel's tests.
"""

from __future__ import annotations

import numpy as np


def make_room_cloud(n_points: int, seed: int = 0, size: float = 20.0, noise: float = 0.005) -> np.ndarray:
    """Points sampled on the 6 faces of a box plus a few interior walls."""
    rng = np.random.default_rng(seed)
    s = size / 2
    # face: (origin, u axis, v axis)
    faces = [
        ((-s, -s, 0.0), (1, 0, 0), (0, 1, 0)),   # floor
        ((-s, -s, 3.0), (1, 0, 0), (0, 1, 0)),   # ceiling
        ((-s, -s, 0.0), (1, 0, 0), (0, 0, 1)),   # wall y=-s
        ((-s, s, 0.0), (1, 0, 0), (0, 0, 1)),    # wall y=+s
        ((-s, -s, 0.0), (0, 1, 0), (0, 0, 1)),   # wall x=-s
        ((s, -s, 0.0), (0, 1, 0), (0, 0, 1)),    # wall x=+s
        ((-s / 2, -s, 0.0), (0, 1, 0), (0, 0, 1)),  # interior wall 1
        ((0.0, 0.0, 0.0), (1, 0, 0), (0, 0, 1)),    # interior wall 2
    ]
    per = n_points // len(faces)
    pts = []
    for k, (o, u, v) in enumerate(faces):
        m = per if k < len(faces) - 1 else n_points - per * (len(faces) - 1)
        uu = rng.uniform(0, size, size=(m, 1))
        vv = rng.uniform(0, 3.0 if u[2] == 0 and v[2] == 1 else size, size=(m, 1))
        vv = np.where(np.asarray(v)[2] == 1, np.clip(vv, 0, 3.0), vv % size)
        p = np.asarray(o) + uu * np.asarray(u) + vv * np.asarray(v)
        pts.append(p)
    cloud = np.concatenate(pts, axis=0)
    cloud = np.clip(cloud, -s, s)
    cloud += rng.normal(scale=noise, size=cloud.shape)
    return cloud.astype(np.float32)


def make_scan_from_world(world: np.ndarray, sensor_pos: np.ndarray, max_range: float = 30.0, seed: int = 0,
                         n_out: int | None = None) -> np.ndarray:
    """Range-gated view of the world from a sensor position, in the SENSOR frame
    (identity orientation). Subsamples to n_out points if given."""
    rng = np.random.default_rng(seed)
    rel = world - sensor_pos[None, :]
    r = np.linalg.norm(rel, axis=1)
    vis = rel[(r < max_range) & (r > 0.3)]
    if n_out is not None:
        idx = rng.choice(len(vis), size=min(n_out, len(vis)), replace=len(vis) < n_out)
        vis = vis[idx]
    return vis.astype(np.float32)


def random_pose(seed: int = 0, rot_scale: float = 0.1, trans_scale: float = 0.5):
    """Small random SE(3) perturbation as (R, t) numpy pair."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=3)
    w = w / np.linalg.norm(w) * rng.uniform(0, rot_scale)
    t = rng.normal(size=3)
    t = t / np.linalg.norm(t) * rng.uniform(0, trans_scale)
    theta = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if theta < 1e-12:
        R = np.eye(3)
    else:
        K = K / theta
        R = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K
    return R.astype(np.float32), t.astype(np.float32)


def make_imu_trajectory(
    n_frames: int,
    imu_per_frame: int = 20,
    frame_dt: float = 0.1,
    seed: int = 0,
    gravity: float = 9.809,
    still_frames: int = 2,
    acc_amp: float = 1.0,
    yaw_rate_amp: float = 0.4,
):
    """Discrete-exact trajectory with IMU measurements: ground truth is defined
    by the filter's own first-order integration rule, so IMU integration is
    exact by construction. Stationary for `still_frames` frames."""
    rng = np.random.default_rng(seed)
    n = n_frames * imu_per_frame + 1
    dt = frame_dt / imu_per_frame
    t = np.arange(n) * dt
    t_still = still_frames * frame_dt
    ramp = np.clip((t - t_still) / max(frame_dt, 1e-6), 0.0, 1.0)
    env = ramp * ramp * (3 - 2 * ramp)  # smoothstep

    freq = rng.uniform(0.2, 0.5, size=3)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    acc_w = (acc_amp * np.sin(2 * np.pi * freq * t[:, None] + phase)) * env[:, None]
    yaw_rate = yaw_rate_amp * np.sin(2 * np.pi * 0.3 * t) * env

    grav_w = np.array([0.0, 0.0, -gravity])
    pos = np.zeros((n, 3))
    vel = np.zeros((n, 3))
    R = np.zeros((n, 3, 3))
    R[0] = np.eye(3)
    acc_b = np.zeros((n, 3), np.float32)
    gyro_b = np.zeros((n, 3), np.float32)
    for i in range(n - 1):
        acc_b[i] = R[i].T @ (acc_w[i] - grav_w)
        gyro_b[i] = np.array([0.0, 0.0, yaw_rate[i]])
        pos[i + 1] = pos[i] + vel[i] * dt
        vel[i + 1] = vel[i] + acc_w[i] * dt
        th = yaw_rate[i] * dt
        dR = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
        R[i + 1] = R[i] @ dR
    acc_b[-1] = R[-1].T @ (acc_w[-1] - grav_w)
    gyro_b[-1] = np.array([0.0, 0.0, yaw_rate[-1]])
    return {
        "t": t.astype(np.float64),
        "acc": acc_b.astype(np.float32),
        "gyro": gyro_b.astype(np.float32),
        "pos": pos.astype(np.float32),
        "vel": vel.astype(np.float32),
        "R": R.astype(np.float32),
        "imu_per_frame": imu_per_frame,
        "frame_dt": frame_dt,
    }


def simulate_lio_sequence(n_frames=40, n_pts=3000, imu_per_frame=20, frame_dt=0.1, seed=0, device="cuda"):
    """Synthetic world + trajectory + exact IMU -> (world, traj, [(frame, gt_pos, gt_R)]).

    Frame f applies IMU samples i0..i1-1 stamped at their interval ENDS; the
    scan is taken at the frame-end pose."""
    from . import feed

    world = make_room_cloud(40000, seed=seed)
    traj = make_imu_trajectory(n_frames, imu_per_frame, frame_dt, seed=seed)
    frames = []
    rng = np.random.default_rng(seed)
    for f in range(n_frames):
        i0 = f * imu_per_frame
        i1 = (f + 1) * imu_per_frame
        pos, R = traj["pos"][i1], traj["R"][i1]
        rel = (world - pos) @ R  # world -> body
        r = np.linalg.norm(rel, axis=1)
        vis = rel[(r < 25.0) & (r > 0.3)]
        idx = rng.choice(len(vis), size=min(n_pts, len(vis)), replace=False)
        pts = vis[idx].astype(np.float32)
        t_offs = np.full(len(pts), frame_dt, np.float32)
        imu_t = (traj["t"][i0 + 1 : i1 + 1] - traj["t"][i0]).astype(np.float32)
        fr = feed.make_frame(
            pts, t_offs, traj["acc"][i0:i1], traj["gyro"][i0:i1], imu_t,
            n_points=n_pts, n_imu=imu_per_frame, prev_imu_t=0.0, device=device,
        )
        frames.append((fr, pos, R))
    return world, traj, frames


def make_feature_world(seed=0, half=8.0):
    """Poles (corners) + walls/floor (surfs) in a dense (2*half)^2 m area —
    the LOAM-feature world used by the SLAM tests and --synthetic replay."""
    rng = np.random.default_rng(seed)
    poles = []
    for _ in range(30):
        px, py = rng.uniform(-half, half, 2)
        z = rng.uniform(0, 3, (50, 1))
        poles.append(np.concatenate([np.full((50, 1), px), np.full((50, 1), py), z], 1))
    corners = np.concatenate(poles).astype(np.float32)
    floor = np.concatenate([rng.uniform(-half, half, (16000, 2)), np.zeros((16000, 1))], 1)
    walls = []
    for (a, c) in [(0, half), (0, -half), (1, half), (1, -half)]:
        w = np.zeros((4000, 3))
        w[:, a] = c
        w[:, 1 - a] = rng.uniform(-half, half, 4000)
        w[:, 2] = rng.uniform(0, 3, 4000)
        walls.append(w)
    surfs = np.concatenate([floor] + walls).astype(np.float32)
    return corners, surfs


def take_scan(world, pose_R, pose_t, n_out, max_range=30.0, seed=0):
    """Range-gated sensor-frame sample of a world cloud, padded to n_out."""
    rng = np.random.default_rng(seed)
    rel = (world - pose_t) @ pose_R  # world -> sensor
    r = np.linalg.norm(rel, axis=1)
    vis = rel[(r < max_range) & (r > 0.5)]
    if len(vis) == 0:
        vis = rel[:1]
    idx = rng.choice(len(vis), min(n_out, len(vis)), replace=len(vis) < n_out)
    out = np.zeros((n_out, 3), np.float32)
    m = np.zeros(n_out, bool)
    out[: len(idx)] = vis[idx]
    m[: len(idx)] = True
    return out, m


def make_corridor_world(length=40.0, width=3.0, height=3.0, seed=0,
                        n_wall=24000, n_poles=0, junction_gap=0.5):
    """Long featureless corridor along +x — translation-degenerate geometry.

    Two side walls + floor + ceiling, all parallel to the x axis and NO end
    caps inside the traversed stretch: every plane normal is orthogonal to x,
    so scan-to-map matching cannot observe motion along the corridor (the
    scenario the reference's eigenvalue degeneracy guard exists for,
    mapOptmization.cpp:1508-1536 / localization.cpp:424-476). Optional
    `n_poles` doorframe poles at the entrance restore observability locally.
    `junction_gap` leaves the wall/floor/ceiling junction strips empty so
    5-NN plane-fit neighborhoods never mix two faces (a mixed edge cluster
    is fit-degenerate and yields an arbitrary normal, which injects spurious
    along-corridor information into H — measured: H_xx 28 with junctions vs
    ~0 without; the reference's esti_plane has the same artifact).
    Returns (corners, surfs) like make_feature_world.
    """
    rng = np.random.default_rng(seed)
    n4 = n_wall // 4
    xs = rng.uniform(0.0, length, (4, n4))
    g = junction_gap
    walls = []
    for i, (fix_axis, fix_val, free_axis, lo, hi) in enumerate([
        (1, -width / 2, 2, g, height - g),         # wall y=-w/2, z free
        (1, +width / 2, 2, g, height - g),         # wall y=+w/2
        (2, 0.0, 1, -width / 2 + g, width / 2 - g),        # floor
        (2, height, 1, -width / 2 + g, width / 2 - g),     # ceiling
    ]):
        w = np.zeros((n4, 3))
        w[:, 0] = xs[i]
        w[:, fix_axis] = fix_val
        w[:, free_axis] = rng.uniform(lo, hi, n4)
        walls.append(w)
    surfs = np.concatenate(walls).astype(np.float32)
    if n_poles:
        poles = []
        for k in range(n_poles):
            px = 0.5
            py = (-1) ** k * (width / 2 - 0.2)
            z = rng.uniform(0, height, (60, 1))
            poles.append(np.concatenate([np.full((60, 1), px), np.full((60, 1), py), z], 1))
        corners = np.concatenate(poles).astype(np.float32)
    else:
        corners = np.zeros((1, 3), np.float32)
    return corners, surfs


def make_doorway_world(room=8.0, door_width=0.7, door_height=2.0,
                       wall_thickness=3.0, seed=0):
    """Two feature-rich rooms joined by a doorway TUNNEL through a thick
    dividing wall (planes at x=0 and x=wall_thickness, both with the door
    cut out, plus the tunnel's own side walls/lintel). Inside the tunnel
    the visible geometry collapses to the tunnel walls and the two aperture
    slivers — the doorway-transition stress the reference's loss machinery
    exists for (localization.cpp:424-476). Use with `take_scan_occluded`.
    Returns (corners, surfs, doors) where doors is the occluder list
    [(x_plane, door_width, door_height), ...] for take_scan_occluded."""
    rng = np.random.default_rng(seed)
    th = wall_thickness
    corners_list, surf_list = [], []
    for cx in (-room / 2, th + room / 2):   # room A: [-room, 0]; room B: [th, th+room]
        for _ in range(12):
            px = cx + rng.uniform(-room / 2 + 0.5, room / 2 - 0.5)
            py = rng.uniform(-room / 2 + 0.5, room / 2 - 0.5)
            z = rng.uniform(0, 3, (50, 1))
            corners_list.append(np.concatenate([np.full((50, 1), px), np.full((50, 1), py), z], 1))
        floor = np.stack([cx + rng.uniform(-room / 2, room / 2, 8000),
                          rng.uniform(-room / 2, room / 2, 8000),
                          np.zeros(8000)], 1)
        surf_list.append(floor)
        for (a, c) in [(1, room / 2), (1, -room / 2)]:
            w = np.zeros((2500, 3))
            w[:, 0] = cx + rng.uniform(-room / 2, room / 2, 2500)
            w[:, a] = c
            w[:, 2] = rng.uniform(0, 3, 2500)
            surf_list.append(w)
    # outer end walls
    for c in (-room, th + room):
        w = np.zeros((2500, 3))
        w[:, 0] = c
        w[:, 1] = rng.uniform(-room / 2, room / 2, 2500)
        w[:, 2] = rng.uniform(0, 3, 2500)
        surf_list.append(w)
    # the two dividing-wall faces with the door cut out
    for xp in (0.0, th):
        n = 6000
        wy = rng.uniform(-room / 2, room / 2, n)
        wz = rng.uniform(0, 3, n)
        keep = ~((np.abs(wy) < door_width / 2) & (wz < door_height))
        surf_list.append(np.stack([np.full(keep.sum(), xp), wy[keep], wz[keep]], 1))
    # tunnel interior: side walls + lintel + floor strip
    nt = 1200
    tx = rng.uniform(0, th, (4, nt))
    for i, y in enumerate((-door_width / 2, door_width / 2)):
        surf_list.append(np.stack([tx[i], np.full(nt, y), rng.uniform(0, door_height, nt)], 1))
    surf_list.append(np.stack([tx[2], rng.uniform(-door_width / 2, door_width / 2, nt),
                               np.full(nt, door_height)], 1))
    surf_list.append(np.stack([tx[3], rng.uniform(-door_width / 2, door_width / 2, nt),
                               np.zeros(nt)], 1))
    corners = np.concatenate(corners_list).astype(np.float32)
    surfs = np.concatenate(surf_list).astype(np.float32)
    # side: which sensor half-space the plane's FACE points are visible from
    # (a wall face is room-facing paint; from inside the tunnel only the
    # tunnel's own walls are visible)
    doors = [(0.0, door_width, door_height, -1.0), (th, door_width, door_height, +1.0)]
    return corners, surfs, doors


def take_scan_occluded(world, pose_R, pose_t, n_out, doors, max_range=30.0, seed=0):
    """take_scan with line-of-sight blocking by the dividing-wall planes of
    make_doorway_world: a point is visible iff, for EVERY occluder plane the
    sensor-to-point segment crosses, the crossing lies inside that plane's
    door aperture. Visible points are sampled WITHOUT replacement, so a
    collapsed view (inside the tunnel) yields fewer valid points — the
    fixed-shape mask carries the visibility dip downstream."""
    rng = np.random.default_rng(seed)
    visible = np.ones(len(world), bool)
    rel_w = world - pose_t                     # world frame, sensor at origin
    x0 = pose_t[0]
    xw = world[:, 0]
    for door in doors:
        xp, dw, dh = door[:3]
        side = door[3] if len(door) > 3 else 0.0
        crosses = ((x0 - xp) * (xw - xp) < 0)
        denom = xw - x0
        tpar = np.where(np.abs(denom) > 1e-9, (xp - x0) / np.where(np.abs(denom) > 1e-9, denom, 1.0), 0.0)
        iy = pose_t[1] + tpar * rel_w[:, 1]
        iz = pose_t[2] + tpar * rel_w[:, 2]
        through_door = (np.abs(iy) < dw / 2) & (iz > 0) & (iz < dh)
        visible &= ~crosses | through_door
        if side != 0.0:
            # one-sided wall face: its own points show only from `side`
            on_plane = np.abs(xw - xp) < 1e-6
            visible &= ~on_plane | ((x0 - xp) * side > 0)
    rel = (world[visible] - pose_t) @ pose_R   # world -> sensor
    r = np.linalg.norm(rel, axis=1)
    vis = rel[(r < max_range) & (r > 0.5)]
    if len(vis) == 0:
        vis = np.zeros((1, 3), np.float32)
    idx = rng.choice(len(vis), min(n_out, len(vis)), replace=False)
    out = np.zeros((n_out, 3), np.float32)
    m = np.zeros(n_out, bool)
    out[: len(idx)] = vis[idx]
    m[: len(idx)] = True
    return out, m


def moving_object_points(t_sec, n=120, seed=0, start=(4.0, -3.0, 0.0),
                         velocity=(0.0, 1.2, 0.0), size=(0.5, 0.5, 1.7)):
    """A pedestrian-sized box cloud at start + velocity * t (WORLD frame) —
    dynamic-object outliers to inject into scans. The reference has no
    dynamic-object filter either; the gate is that plane-fit validity checks
    and robust residuals keep the pose solution from latching onto it."""
    rng = np.random.default_rng(seed + int(t_sec * 1000) % 97)
    c = np.asarray(start, np.float32) + np.asarray(velocity, np.float32) * t_sec
    pts = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32) * np.asarray(size, np.float32)
    pts[:, 2] += size[2] / 2
    return pts + c


HALL_HALF = (8.0, 6.0)          # the box-world hall: 16 x 12 m ...
HALL_HEIGHT = 5.0               # ... and 5 m high
LIDAR_RINGS, LIDAR_COLUMNS = 16, 1800   # a VLP-16: rings at -15 .. +15 deg, 0.2 deg columns
LIDAR_FOV_DEG = (-15.0, 15.0)


def make_box_world(seed=0):
    """A closed hall as axis-aligned boxes: the room's inside (floor z = 0,
    ceiling, four walls) and solid boxes standing on the floor, six square
    pillars up to the ceiling and six crates. Returns (room_lo, room_hi,
    solids (B, 2, 3)), the input of `ray_cast` and `spinning_scan`."""
    rng = np.random.default_rng(seed)
    hx, hy = HALL_HALF
    solids = []
    for k in range(12):
        pillar = k < 6
        w = rng.uniform(0.4, 0.7) if pillar else rng.uniform(0.6, 1.4)
        c = rng.uniform([-hx + 1.0, -hy + 1.0], [hx - 1.0, hy - 1.0])
        if np.abs(c[1]) < 2.6 and np.abs(c[0]) < 4.6:      # keep the driving loop clear
            c[1] = np.sign(c[1] + 1e-9) * rng.uniform(3.2, hy - 0.8)
        top = HALL_HEIGHT if pillar else rng.uniform(0.6, 1.5)
        solids.append([[c[0] - w / 2, c[1] - w / 2, 0.0], [c[0] + w / 2, c[1] + w / 2, top]])
    return np.array([-hx, -hy, 0.0]), np.array([hx, hy, HALL_HEIGHT]), np.asarray(solids)


def ray_cast(world, origin, dirs):
    """Range along each unit ray (N, 3) from `origin` (3,) to the first surface
    of a `make_box_world` world: the nearest solid box entered, else the wall,
    floor or ceiling where the ray leaves the room."""
    room_lo, room_hi, solids = world
    d = np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)
    inv = 1.0 / d
    t_room = np.min(np.maximum((room_lo - origin) * inv, (room_hi - origin) * inv), axis=1)
    a = (solids[None, :, 0, :] - origin) * inv[:, None, :]
    b = (solids[None, :, 1, :] - origin) * inv[:, None, :]
    t_near = np.max(np.minimum(a, b), axis=2)
    t_far = np.min(np.maximum(a, b), axis=2)
    t_box = np.where((t_near <= t_far) & (t_near > 0), t_near, np.inf)
    return np.minimum(t_room, np.min(t_box, axis=1))


def spinning_scan(world, pose_R, pose_t, seed=0):
    """One 0.1 s sweep of the spinning LiDAR at the pose, ray-cast against a
    `make_box_world` world: each ring an ordered azimuth sweep of real
    surfaces, as the LOAM front end expects. Ring r has elevation
    -15 + 2 r deg; column j sits at the centre of range-image column j
    (azimuth pi - (j + 0.5) * 2 pi / 1,800); ranges carry 5 mm of noise.
    Returns sensor-frame points (16 * 1,800, 3) ring-major, ring (uint16)
    and per-point time offset within the sweep (float32)."""
    rng = np.random.default_rng(seed)
    elev = np.deg2rad(np.linspace(LIDAR_FOV_DEG[0], LIDAR_FOV_DEG[1], LIDAR_RINGS))
    az = np.pi - (np.arange(LIDAR_COLUMNS) + 0.5) * 2.0 * np.pi / LIDAR_COLUMNS
    ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
    d_s = np.stack([ce * np.cos(az)[None, :], ce * np.sin(az)[None, :],
                    np.broadcast_to(se, (LIDAR_RINGS, LIDAR_COLUMNS))], axis=-1).reshape(-1, 3)
    rng_m = ray_cast(world, np.asarray(pose_t, np.float64), d_s @ np.asarray(pose_R, np.float64).T)
    rng_m = rng_m + rng.normal(0.0, 0.005, rng_m.shape)
    pts = (d_s * rng_m[:, None]).astype(np.float32)
    ring = np.repeat(np.arange(LIDAR_RINGS, dtype=np.uint16), LIDAR_COLUMNS)
    t_off = np.tile((np.arange(LIDAR_COLUMNS) / LIDAR_COLUMNS * 0.1).astype(np.float32), LIDAR_RINGS)
    return pts, ring, t_off


def box_world_poses(n_frames):
    """The sensor's path through the `make_box_world` hall: an ellipse
    (4 x 2.2 m semi-axes) at 2 m height, 0.3 m a frame, with a slow yaw sway.
    Returns (R (n, 3, 3), t (n, 3))."""
    s = 0.3 * np.arange(n_frames) / 3.2          # ellipse phase (~0.3 m a frame)
    t = np.stack([4.0 * np.sin(s), 2.2 * (1.0 - np.cos(s)) - 1.1, np.full_like(s, 2.0)], axis=1)
    yaw = 0.15 * np.sin(0.7 * s)
    c, sn = np.cos(yaw), np.sin(yaw)
    R = np.zeros((n_frames, 3, 3))
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1], R[:, 2, 2] = c, -sn, sn, c, 1.0
    return R, t


def write_ring_bag(path, n_frames=30, seed=0):
    """A ROS1 bag of `n_frames` spinning-LiDAR sweeps of the box-world hall at
    10 Hz on /velodyne_points (sensor_msgs/PointCloud2 with x, y, z,
    intensity, ring and time), written with `io.rosbag.BagWriter`. Returns
    (stamps (n,), R (n, 3, 3), t (n, 3)): every sweep's ground truth."""
    from .rosbag import BagWriter

    world = make_box_world(seed)
    Rs, ts = box_world_poses(n_frames)
    stamps = 100.0 + 0.1 * np.arange(n_frames)
    with BagWriter(path) as bw:
        for k in range(n_frames):
            pts, ring, t_off = spinning_scan(world, Rs[k], ts[k], seed=seed + k)
            bw.write_pointcloud2("/velodyne_points", float(stamps[k]), {
                "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                "intensity": np.full(len(pts), 100.0, np.float32), "ring": ring, "time": t_off})
    return stamps, Rs, ts


def drifting_circle_graph(cfg, n_loops, stride, span, radius=20.0, climb=0.05, rng=0, device="cuda"):
    """`__graft_entry__.dryrun_multichip`'s pose graph for a
    `models.liosam.backend.BackendConfig`: `cfg.max_keyframes` nodes on a
    helix (`radius` m, rising `climb` m a radian) with 1 cm of drift a node
    (cumulative noise from `rng`, a seed or a numpy Generator), exact
    odometry of information 1e4 and `n_loops` loops (i, i + span) of
    information 1e3, i = k * stride mod (KF - span), in `cfg.max_loops`
    slots. Returns (graph, true t (KF, 3), noisy t (KF, 3))."""
    import torch

    from ..models.liosam import backend as bk

    KF, L = cfg.max_keyframes, cfg.max_loops
    rng = np.random.default_rng(rng)
    ang = np.linspace(0, 2 * np.pi, KF)
    t_true = np.stack([radius * np.cos(ang), radius * np.sin(ang), climb * ang], 1).astype(np.float32)
    t_noisy = t_true + np.cumsum(rng.normal(0, 0.01, (KF, 3)), 0).astype(np.float32)
    odom_t = np.zeros((KF, 3), np.float32)
    odom_t[1:] = t_true[1:] - t_true[:-1]
    live = np.arange(L) < n_loops
    li = np.where(live, (np.arange(L) * stride) % (KF - span), 0)
    lj = np.where(live, li + span, 0)
    loop_t = np.where(live[:, None], t_true[lj] - t_true[li], 0).astype(np.float32)
    loop_info = np.where(live[:, None], np.float32(1e3), np.float32(0)) * np.ones((L, 6), np.float32)
    f = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    g = bk.create(cfg, device=device)._replace(
        t=f(t_noisy), n=f(KF, torch.int32), odom_t=f(odom_t), odom_info=torch.full((KF, 6), 1e4, device=device),
        loop_i=f(li, torch.int32), loop_j=f(lj, torch.int32), loop_t=f(loop_t), loop_info=f(loop_info),
        n_loops=f(n_loops, torch.int32))
    return g, t_true, t_noisy


def eigh_hard_spectra(seed=0):
    """Hard inputs for kernel K6 (`ops.small_eigh`): (batch, 6, 6) float64
    symmetric matrices by name — ties, a rank-deficient corridor, scales
    1e-30 to 1e34, condition 1e8, indefinite, zero. Every one stays inside
    float32's range; "scale_1e-30" and "scale_1e34" put the off-diagonal
    entries below 2^-120 and the entries near 2^120 in float32, which K6
    takes by IEEE division and square root."""
    g = np.random.default_rng(seed)
    Q = np.linalg.qr(g.normal(size=(64, 6, 6)))[0]
    J = g.normal(size=(64, 6, 120))
    corridor = J.copy()
    corridor[:, 0] = 0.0                 # one translation unobserved: a zero eigenvalue
    corridor[:, 4] *= 1e-4               # one nearly so
    cond = 10.0 ** g.uniform(-2, 6, size=(64, 6))
    cond[:, 0], cond[:, 1] = 1e-2, 1e6   # condition number 1e8
    ties = np.tile([1.0, 1.0, 1.0, 5.0, 5.0, 9.0], (64, 1))
    gram = J @ J.transpose(0, 2, 1)
    return {
        "identity": np.tile(np.eye(6), (4, 1, 1)),
        "diagonal_ties": np.tile(np.diag([3.0, 1.0, 3.0, 2.0, 1.0, 3.0]), (4, 1, 1)),
        "rotated_ties": Q @ (ties[..., None] * Q.transpose(0, 2, 1)),
        "corridor_rank_deficient": Q @ corridor @ corridor.transpose(0, 2, 1) @ Q.transpose(0, 2, 1),
        "scale_1e-3": 1e-3 * gram,
        "scale_1e6": 1e6 * gram,
        "scale_1e-30": 1e-30 * gram,
        "scale_1e34": 1e34 * gram,
        "condition_1e8": Q @ (cond[..., None] * Q.transpose(0, 2, 1)),
        "indefinite": (lambda X: X + X.transpose(0, 2, 1))(g.normal(size=(64, 6, 6))),
        "zero": np.zeros((2, 6, 6)),
    }
