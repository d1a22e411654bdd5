"""The LIO odometry frame step (port of `pointcloud_slam_tpu/models/lio/pipeline.py`).

Reference: laser_mapping.cc `Run` (sync -> IMU process/undistort -> scan
downsample -> iterated ESKF update -> incremental map insert), `ObsModel`
(5-NN + plane fit + point-to-plane residual and Jacobian rows) and
`MapIncremental` (voxel-center insert gating).

One frame runs on the device of the state's tensors with no read back to
the host in steady state. The JAX package's `lax.cond(initialized, ...)`
is a host branch here: whether the IMU is initialized depends only on the
IMU sample counts, which the step reads from the device during the
initialization frames only. `lio_step.host_syncs` counts every
device -> host read the step makes (initialization frames, and one per
update iteration with `research_on_converge=True`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ... import ops
from ...geom import fit, s2
from . import eskf, imu
from . import state as st


@dataclasses.dataclass(frozen=True)
class LIOConfig:
    grid: ops.GridConfig = dataclasses.field(
        default_factory=lambda: ops.GridConfig(
            capacity=1 << 17, pts_per_voxel=8, resolution=0.5, nearby=7, claim_rounds=2
        )
    )
    scan_leaf: float = 0.5           # filter_size_surf (laser_mapping.cc:325)
    map_leaf: float = 0.5            # filter_size_map_min
    scan_budget: int = 10240         # points carried into the iterated update (0 = no compaction)
    insert_budget: int = 6144        # gated map-insert candidates per frame (0 = no compaction)
    max_iterations: int = 4          # options::NUM_MAX_ITERATIONS
    epsi: float = 0.001              # convergence limit per error dim
    # reference semantics (laser_mapping.cc:618): re-run the NN search after a
    # converged iteration. False = one search per frame, correspondences
    # cached for all iterations.
    research_on_converge: bool = True
    laser_point_cov: float = 0.001   # options::LASER_POINT_COV
    num_match: int = 5               # options::NUM_MATCH_POINTS
    min_match: int = 3               # options::MIN_NUM_MATCH_POINTS
    plane_threshold: float = 0.1     # options::ESTI_PLANE_THRESHOLD
    knn_max_dist: float = 5.0        # GetClosestPoint max distance
    init_imu_frames: int = 2         # frames of IMU averaging before start (~20 samples)
    gravity: float = s2.GRAVITY
    extrinsic_est: bool = False      # extrinsic_est_en
    gyr_cov: float = 1e-4
    acc_cov: float = 1e-4
    b_gyr_cov: float = 1e-5
    b_acc_cov: float = 1e-5
    extrinsic_T: tuple = (0.0, 0.0, 0.0)
    extrinsic_R: tuple = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


class LIOState(NamedTuple):
    """Carried state of the odometry loop. `initialized`, `first_scan` and
    `init_count` are host values (the JAX package keeps them on the device)."""

    x: st.NavState
    P: torch.Tensor           # (23, 23)
    grid: ops.VoxelHashMap
    initialized: bool         # IMU init done
    first_scan: bool          # map seeded with first scan
    init_count: int           # accumulated IMU samples
    acc_sum: torch.Tensor     # (3,) running sums for init averaging
    gyro_sum: torch.Tensor    # (3,)
    acc_scale: torch.Tensor   # () G / |mean_acc|
    prev_acc_w: torch.Tensor  # (3,) last world-frame accel (pose-table seed)
    prev_gyro: torch.Tensor   # (3,) last unbiased gyro


class LIOFrame(NamedTuple):
    """One host-prepared sensor frame, fixed shapes (pad + mask)."""

    pts: torch.Tensor       # (3, N) lidar points, lidar frame
    pt_mask: torch.Tensor   # (N,)
    t_offs: torch.Tensor    # (N,) point time offset from scan start [s]
    imu_acc: torch.Tensor   # (M, 3)
    imu_gyro: torch.Tensor  # (M, 3)
    imu_dt: torch.Tensor    # (M,) integration interval per sample [s]
    imu_offs: torch.Tensor  # (M,) sample offset from scan start [s]; pad = 1e9
    imu_mask: torch.Tensor  # (M,)


class LIOOutput(NamedTuple):
    pos: torch.Tensor        # (3,) IMU position in world
    rot: torch.Tensor        # (3, 3)
    vel: torch.Tensor        # (3,)
    num_effective: torch.Tensor  # effective feature count
    converged: torch.Tensor
    P_diag: torch.Tensor     # (23,) covariance diagonal (status channel)


def create_state(cfg: LIOConfig, dtype=torch.float32, device="cuda") -> LIOState:
    """A fresh filter state and map, on the GPU unless `device` says otherwise."""
    x0 = st.identity(dtype, cfg.gravity, device=device)
    ext_R = torch.tensor(cfg.extrinsic_R, dtype=dtype).reshape(3, 3).to(device)
    ext_t = torch.tensor(cfg.extrinsic_T, dtype=dtype).to(device)
    z3 = torch.zeros(3, dtype=dtype, device=device)
    return LIOState(
        x=x0._replace(ext_R=ext_R, ext_t=ext_t),
        P=eskf.init_P(dtype, device=device),
        grid=ops.create(cfg.grid, dtype, device=device),
        initialized=False,
        first_scan=True,
        init_count=0,
        acc_sum=z3,
        gyro_sum=z3.clone(),
        acc_scale=torch.ones((), dtype=dtype, device=device),
        prev_acc_w=z3.clone(),
        prev_gyro=z3.clone(),
    )


def _obs_model(cfg: LIOConfig, grid, pts_body, body_norm, mask):
    """Builds the iterated-update observation fn over the downsampled scan."""

    def obs(x: st.NavState, do_search: bool, cache):
        R_wl = x.rot @ x.ext_R
        t_wl = x.rot @ x.ext_t + x.pos
        pw = R_wl @ pts_body + t_wl[:, None]

        if do_search or cache is None:
            nbrs, d2, cnt, _ = ops.knn(cfg.grid, grid, pw, k=cfg.num_match, max_range=cfg.knn_max_dist)
            nmask = torch.arange(d2.shape[0], device=d2.device)[:, None] < cnt[None, :]
            coef, ok = fit.plane_fit(nbrs, nmask, cfg.plane_threshold, cfg.min_match)
            sel = mask & ok & (cnt >= cfg.min_match)
            cache = (coef, sel, nbrs, d2, cnt)
        coef, sel = cache[0], cache[1]

        zero = torch.zeros_like(coef[0])
        nx = torch.where(sel, coef[0], zero)
        ny = torch.where(sel, coef[1], zero)
        nz = torch.where(sel, coef[2], zero)
        pd2 = torch.where(sel, pw[0] * nx + pw[1] * ny + pw[2] * nz + coef[3], zero)
        valid = sel & (body_norm > 81.0 * pd2 * pd2)  # laser_mapping.cc:631

        # Jacobian rows (laser_mapping.cc:674-698):
        # p_imu = extR p_body + extT; C = R^T n; A = hat(p_imu) C;
        # B = hat(p_body) extR^T C (extrinsic estimation only)
        eR, et, R = x.ext_R, x.ext_t, x.rot
        p_ix = eR[0, 0] * pts_body[0] + eR[0, 1] * pts_body[1] + eR[0, 2] * pts_body[2] + et[0]
        p_iy = eR[1, 0] * pts_body[0] + eR[1, 1] * pts_body[1] + eR[1, 2] * pts_body[2] + et[1]
        p_iz = eR[2, 0] * pts_body[0] + eR[2, 1] * pts_body[1] + eR[2, 2] * pts_body[2] + et[2]
        cx = R[0, 0] * nx + R[1, 0] * ny + R[2, 0] * nz
        cy = R[0, 1] * nx + R[1, 1] * ny + R[2, 1] * nz
        cz = R[0, 2] * nx + R[1, 2] * ny + R[2, 2] * nz
        ax = p_iy * cz - p_iz * cy
        ay = p_iz * cx - p_ix * cz
        az = p_ix * cy - p_iy * cx
        if cfg.extrinsic_est:
            # w = extR^T C; B = p_body x w
            wx = eR[0, 0] * cx + eR[1, 0] * cy + eR[2, 0] * cz
            wy = eR[0, 1] * cx + eR[1, 1] * cy + eR[2, 1] * cz
            wz = eR[0, 2] * cx + eR[1, 2] * cy + eR[2, 2] * cz
            bx = pts_body[1] * wz - pts_body[2] * wy
            by = pts_body[2] * wx - pts_body[0] * wz
            bz = pts_body[0] * wy - pts_body[1] * wx
            h_x = torch.stack([nx, ny, nz, ax, ay, az, bx, by, bz, wx, wy, wz], dim=1)
        else:
            h_x = torch.stack([nx, ny, nz, ax, ay, az, zero, zero, zero, zero, zero, zero], dim=1)
        return h_x, -pd2, valid, cache

    return obs


def _map_insert_mask(cfg: LIOConfig, pw, mask, nbrs, d2, cnt_ok):
    """Insert-gating of MapIncremental (laser_mapping.cc:525-583): points whose
    nearest map point already covers their map-voxel center are skipped.
    `nbrs/cnt_ok` are the last search's neighbors (Nearest_Points role);
    returns the per-point insert mask over world points pw (3, N)."""
    leaf = cfg.map_leaf
    center = (torch.floor(pw / leaf) + 0.5) * leaf
    n0 = nbrs[:, 0, :]  # nearest neighbor per point (3, N)
    dc = n0 - center
    # nearest point far from the center in EVERY axis -> insert as-is
    far_all = torch.all(torch.abs(dc) > 0.5 * leaf, dim=0)
    dist_pt = torch.sum((pw - center) ** 2, dim=0)
    dist_nb = torch.sum((nbrs - center[:, None, :]) ** 2, dim=0)  # (k, N)
    have = torch.arange(dist_nb.shape[0], device=pw.device)[:, None] < cnt_ok[None, :]
    closer = torch.any(have & (dist_nb < dist_pt[None, :] + 1e-6), dim=0)
    enough = cnt_ok >= cfg.num_match
    need_add = ~(enough & closer)
    return mask & (far_all | need_add | (cnt_ok == 0))


def lio_step(cfg: LIOConfig, s: LIOState, frame: LIOFrame):
    """Process one sensor frame. Returns (new_state, LIOOutput)."""
    dtype, dev = s.P.dtype, s.P.device
    Q = eskf.process_noise_cov(dtype, cfg.gyr_cov, cfg.acc_cov, cfg.b_gyr_cov, cfg.b_acc_cov, device=dev)

    # ---- IMU initialization accumulation (imu_processing.hpp IMUInit) ----
    x, acc_scale = s.x, s.acc_scale
    acc_sum, gyro_sum, init_count = s.acc_sum, s.gyro_sum, s.init_count
    now_init = False
    if not s.initialized:
        m = frame.imu_mask.to(dtype)[:, None]
        acc_sum = acc_sum + torch.sum(frame.imu_acc * m, dim=0)
        gyro_sum = gyro_sum + torch.sum(frame.imu_gyro * m, dim=0)
        init_count = init_count + int(frame.imu_mask.sum())
        lio_step.host_syncs += 1
        now_init = init_count >= cfg.init_imu_frames * 10
        if now_init:
            n = float(max(init_count, 1))
            grav_i, bg_i, scale_i = imu.init_from_measurements(acc_sum / n, gyro_sum / n, cfg.gravity)
            x = x._replace(grav=grav_i, bg=bg_i)
            acc_scale = scale_i
    initialized = s.initialized or now_init

    if s.initialized:
        # forward propagation + pose table
        x_end, P_end, table = imu.propagate(
            x, s.P, Q, frame.imu_acc, frame.imu_gyro, frame.imu_dt, frame.imu_offs,
            frame.imu_mask, acc_scale, s.prev_acc_w, s.prev_gyro,
        )
        # backward per-point motion compensation (lidar frame @ scan end)
        pts_u = imu.undistort(frame.pts, frame.t_offs, frame.pt_mask, table, x_end)
        # scan downsample + compaction to the static survivor budget
        if cfg.scan_budget:
            pts_d, mask_d = ops.voxel_downsample_compact(pts_u, frame.pt_mask, cfg.scan_leaf, cfg.scan_budget)
        else:
            pts_d, mask_d = ops.voxel_downsample(pts_u, frame.pt_mask, cfg.scan_leaf)
        body_norm = torch.sqrt(torch.sum(pts_d * pts_d, dim=0))
        obs = _obs_model(cfg, s.grid, pts_d, body_norm, mask_d)
        upd = eskf.update_iterated(
            x_end, P_end, obs, cfg.laser_point_cov, cfg.max_iterations, cfg.epsi,
            research=cfg.research_on_converge,
        )
        lio_step.host_syncs += upd.host_syncs
        # map insert with downsample gating against the last search's neighbors
        R_wl = upd.x.rot @ upd.x.ext_R
        t_wl = upd.x.rot @ upd.x.ext_t + upd.x.pos
        pw = R_wl @ pts_d + t_wl[:, None]
        _, _, nbrs, d2, cnt = upd.cache
        ins_mask = _map_insert_mask(cfg, pw, mask_d, nbrs, d2, cnt)
        if cfg.insert_budget:
            pw, ins_mask = ops.compact(pw, ins_mask, cfg.insert_budget)
        grid = ops.insert(cfg.grid, s.grid, pw, ins_mask)
        n_eff = torch.sum(mask_d.to(torch.int32))
        # pose-table seed for the next frame: last valid sample's entries
        last = torch.clamp(torch.sum(frame.imu_mask.to(torch.int64)), min=1).reshape(1)
        prev_acc_w = table.acc.index_select(0, last)[0]
        prev_gyro = table.gyro.index_select(0, last)[0]
        x_new, P_new, conv = upd.x, upd.P, upd.converged
    else:
        # first scan (or still initializing): seed the map at the current pose
        R_wl = x.rot @ x.ext_R
        t_wl = x.rot @ x.ext_t + x.pos
        pw = R_wl @ frame.pts + t_wl[:, None]
        grid = ops.insert(cfg.grid, s.grid, pw, frame.pt_mask)
        x_new, P_new = x, s.P
        n_eff = torch.zeros((), dtype=torch.int32, device=dev)
        conv = torch.zeros((), dtype=torch.bool, device=dev)
        prev_acc_w, prev_gyro = s.prev_acc_w, s.prev_gyro

    s_new = LIOState(
        x=x_new,
        P=P_new,
        grid=grid,
        initialized=initialized,
        first_scan=False,
        init_count=init_count,
        acc_sum=acc_sum,
        gyro_sum=gyro_sum,
        acc_scale=acc_scale,
        prev_acc_w=prev_acc_w,
        prev_gyro=prev_gyro,
    )
    out = LIOOutput(
        pos=x_new.pos,
        rot=x_new.rot,
        vel=x_new.vel,
        num_effective=n_eff,
        converged=conv,
        P_diag=torch.diagonal(P_new),
    )
    return s_new, out


lio_step.host_syncs = 0


def reset(cfg: LIOConfig, dtype=torch.float32, device="cuda") -> LIOState:
    """Full re-initialization (reference `jueying_lio/reset` topic handler):
    fresh filter, fresh map, IMU re-init."""
    return create_state(cfg, dtype, device=device)
