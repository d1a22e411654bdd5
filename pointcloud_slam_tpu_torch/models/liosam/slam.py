"""Full LIO-SAM style SLAM: scan-to-map odometry + keyframes + dual-channel
loop closure + pose-graph optimization + map correction (port of
`pointcloud_slam_tpu/models/liosam/slam.py`).

Reference: `src/jueying_slam/src/mapOptmization.cpp` — `laserCloudInfoHandler`
(:356-405) scan-to-map matching against the surrounding-keyframe local map;
`saveKeyFramesAndFactor` (:1779-1884) motion-gated keyframes with odometry,
optional IMU and GPS factors (`addGPSFactor` :1678-1754 gating); two loop
channels — RS: radius search over z-flattened keyposes
(`detectLoopClosureDistance` :843-880) verified by NDT (`performLoopClosure`
:683-731), SC: ScanContext (`performSCLoopClosure` :735-841) verified by
ICP with a Cauchy-robust factor; `correctPoses` (:1886-1917) as a rebuild
of the local maps from the corrected keyframes.

Where the JAX package branches on the device (`lax.cond`: the keyframe
store, GPS, detection, the two verifications, a loop factor, the deferred
sweep, the map rebuild), `slam_step` branches on the host: each predicate is
read once, and predicates known at the same point are read together as one
small tensor. A plain frame reads once (keyframe flag and the frame's
counters, after scan-to-map); a detection adds one read (both channels'
candidates), each verification one (its verdict), a GPS fix one, a deferred
sweep one (whether to rebuild the maps). `slam_step.host_reads` counts
them. Besides these, every `torch.linalg.eigh` / `eigvalsh` reads its info
on the host: 5 per scan-to-map call, 1 per NDT verification. The
per-iteration schedules (scan-to-map rounds, NDT/ICP rounds, PCG) stay
fixed and masked, as in the JAX package, and read nothing.

State is functional: a step returns new tensors and never writes into the
state it was given, so a caller may restart from an earlier state.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ... import ops, register
from ...geom import se3, so3
from ..lio import preintegration as pre
from . import backend as bk
from . import scan2map as s2m
from . import scancontext as sc


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    scan2map: s2m.Scan2MapConfig = dataclasses.field(default_factory=s2m.Scan2MapConfig)
    scancontext: sc.ScanContextConfig = dataclasses.field(default_factory=sc.ScanContextConfig)
    backend: bk.BackendConfig = dataclasses.field(default_factory=lambda: bk.BackendConfig(max_keyframes=512, max_loops=64))
    loop_icp: register.ICPConfig = dataclasses.field(
        default_factory=lambda: register.ICPConfig(solver=register.SolverConfig(max_iterations=15))
    )
    loop_ndt: register.NDTConfig = dataclasses.field(
        default_factory=lambda: register.NDTConfig(solver=register.SolverConfig(max_iterations=15))
    )
    loop_fitness_thresh: float = 0.3   # historyKeyframeFitnessScore
    local_window: int = 16             # keyframes rebuilt into the local map
    # spatial surrounding-keyframe extraction (extractNearby :1153-1181): the
    # `local_window` keyposes nearest the current pose within
    # `surrounding_radius`, the `local_recent` newest always included
    surrounding_radius: float = 50.0   # surroundingKeyframeSearchRadius [m]
    local_recent: int = 6
    n_corner: int = 512                # stored corner points per keyframe
    n_surf: int = 2048                 # stored surf points per keyframe
    loop_grid: ops.GridConfig = dataclasses.field(
        default_factory=lambda: ops.GridConfig(capacity=1 << 14, pts_per_voxel=8, resolution=0.5, nearby=7)
    )
    # loop verification submap: the candidate keyframe +/- this many
    # neighbours merged in the candidate's frame (loopFindNearKeyframes)
    loop_submap_half: int = 4
    # RS loop channel (detectLoopClosureDistance :843-880)
    rs_loop: bool = True
    rs_radius: float = 10.0            # historyKeyframeSearchRadius
    rs_exclude_recent: int = 30        # index-gap guard in addition to the time gate
    rs_time_gate: float = 30.0         # historyKeyframeSearchTimeDiff [s]
    rs_verify: str = "ndt"             # reference verifies RS loops with pclomp NDT
    # sliding-window solve on every keyframe (the iSAM2 update role)
    window_update: bool = True
    window: int = 32
    # deferred loop-event solve: `loop_solve_sweeps` single-GN sweeps run one
    # per frame after a loop event (the reference's loop thread + iSAM2 split)
    deferred_loop_solve: bool = True
    loop_solve_sweeps: int = 0         # 0 -> backend.gn_iterations (x slice factor)
    # drain PCG slice; default off (it destabilizes the closed-loop pipeline,
    # ROADMAP §3 "loop-correction cadence")
    loop_solve_pcg_slice: int = 0
    # skip the rebuild after a sweep whose accumulated node movement is below
    # this [m]; default off (0 = rebuild every sweep)
    map_rebuild_min_delta: float = 0.0
    # fixed-cadence loop detection against the latest keyframe (the 1 Hz
    # loop thread, mapOptmization.cpp:592-605); 0 disables
    loop_detect_every: int = 8
    # frames without detection after an accepted closure
    loop_cooldown: int = 8
    # nominal scan period [s]: the clock (frame_idx * period) when the caller
    # supplies no timestamps
    nominal_scan_period: float = 0.1
    # GPS gating (addGPSFactor :1678-1754)
    gps_cov_thresh: float = 2.0        # gpsCovThreshold
    gps_dist: float = 5.0              # minimum spacing between GPS factors [m]
    use_gps_elevation: bool = False    # useGpsElevation


class SLAMState(NamedTuple):
    graph: bk.PoseGraph
    corner_map: ops.VoxelHashMap
    surf_map: ops.VoxelHashMap
    kf_corner: torch.Tensor       # (KF, 3, Nc)
    kf_corner_mask: torch.Tensor  # (KF, Nc)
    kf_surf: torch.Tensor         # (KF, 3, Ns)
    kf_surf_mask: torch.Tensor    # (KF, Ns)
    sc_descs: torch.Tensor        # (KF, R, S)
    sc_keys: torch.Tensor         # (KF, R)
    pose: se3.Pose                # current odometry pose
    n_loops_found: torch.Tensor
    last_gps: torch.Tensor        # (3,) position of the last added GPS factor
    kf_time: torch.Tensor         # (KF,) keyframe timestamps [s] (RS loop time gate)
    time: torch.Tensor            # () current time [s]
    frame_idx: torch.Tensor       # () int32 frames seen
    opt_sweeps: torch.Tensor      # () int32 remaining deferred full-solve GN sweeps
    loop_closed_kf: torch.Tensor  # () int32 latest keyframe already holding a loop factor
    last_loop_frame: torch.Tensor  # () int32 frame of the last ACCEPTED closure (cooldown)
    map_stale_m: torch.Tensor     # () node movement since the last local-map rebuild [m]


class SLAMOutput(NamedTuple):
    pose: se3.Pose
    is_keyframe: torch.Tensor
    loop_detected: torch.Tensor
    loop_index: torch.Tensor
    degenerate: torch.Tensor
    num_surf_matches: torch.Tensor
    opt_pending: torch.Tensor     # () int32 deferred solve sweeps still queued


def create_state(cfg: SLAMConfig, dtype=torch.float32, device="cuda") -> SLAMState:
    """An empty SLAM state, on the GPU unless `device` says otherwise."""
    KF = cfg.backend.max_keyframes
    R, S = cfg.scancontext.num_ring, cfg.scancontext.num_sector

    def full(shape, v, dt=dtype):
        return torch.full(shape, v, dtype=dt, device=device)

    return SLAMState(
        graph=bk.create(cfg.backend, dtype, device=device),
        corner_map=ops.create(cfg.scan2map.corner_grid, dtype, device=device),
        surf_map=ops.create(cfg.scan2map.surf_grid, dtype, device=device),
        kf_corner=full((KF, 3, cfg.n_corner), 0.0),
        kf_corner_mask=full((KF, cfg.n_corner), False, torch.bool),
        kf_surf=full((KF, 3, cfg.n_surf), 0.0),
        kf_surf_mask=full((KF, cfg.n_surf), False, torch.bool),
        sc_descs=full((KF, R, S), 0.0),
        sc_keys=full((KF, R), 0.0),
        pose=se3.identity(dtype, device=device),
        n_loops_found=full((), 0, torch.int32),
        last_gps=full((3,), 1.0e9),
        kf_time=full((KF,), 0.0),
        time=full((), -1.0),  # -1 sentinel: no timestamps supplied
        frame_idx=full((), 0, torch.int32),
        opt_sweeps=full((), 0, torch.int32),
        loop_closed_kf=full((), -1, torch.int32),
        last_loop_frame=full((), -(1 << 30), torch.int32),
        map_stale_m=full((), 0.0),
    )


def deferred_sweep_plan(cfg: SLAMConfig):
    """(n_sweeps, pcg_iterations_per_sweep) of the deferred loop-event solve:
    with a PCG slice, proportionally more sweeps at the sliced budget; None =
    full budget."""
    slice_ = cfg.loop_solve_pcg_slice
    if 0 < slice_ < cfg.backend.pcg_iterations:
        factor = -(-cfg.backend.pcg_iterations // slice_)  # ceil
        pcg = slice_
    else:
        factor, pcg = 1, None
    n = cfg.loop_solve_sweeps if cfg.loop_solve_sweeps > 0 else cfg.backend.gn_iterations * factor
    return n, pcg


def grow_state(cfg: SLAMConfig, state: SLAMState, max_keyframes: Optional[int] = None,
               max_loops: Optional[int] = None):
    """HOST-side keyframe-store growth (see backend.grow): re-pads the pose
    graph and the per-keyframe feature/SC/time stores to a larger capacity.
    Returns `(new_cfg, new_state)`; existing keyframes are bit-identical."""
    new_bk_cfg, new_graph = bk.grow(cfg.backend, state.graph, max_keyframes, max_loops)
    new_cfg = dataclasses.replace(cfg, backend=new_bk_cfg)
    KF = new_bk_cfg.max_keyframes

    def pad_to(old):
        new = old.new_zeros((KF,) + old.shape[1:])
        new[: old.shape[0]] = old
        return new

    return new_cfg, state._replace(
        graph=new_graph,
        kf_corner=pad_to(state.kf_corner), kf_corner_mask=pad_to(state.kf_corner_mask),
        kf_surf=pad_to(state.kf_surf), kf_surf_mask=pad_to(state.kf_surf_mask),
        sc_descs=pad_to(state.sc_descs), sc_keys=pad_to(state.sc_keys), kf_time=pad_to(state.kf_time),
    )


def needs_growth(cfg: SLAMConfig, state: SLAMState, margin: int = 4) -> bool:
    """HOST-side capacity check (one read of both counters): True when the
    keyframe or loop store is within `margin` of saturation."""
    n, n_loops = torch.stack([state.graph.n, state.graph.n_loops]).tolist()
    return n >= cfg.backend.max_keyframes - margin or n_loops >= cfg.backend.max_loops - margin


def _surrounding_keyframes(cfg: SLAMConfig, graph: bk.PoseGraph, pose_t):
    """The local map's keyframe set (extractNearby, mapOptmization.cpp:1153-1181):
    the `local_window` best scores, ascending, with the `local_recent` newest
    keyframes first (they score d2 - 1.5e38, all equal in f32) and then the
    nearest within `surrounding_radius`. Ties keep the lower index first (a
    stable sort, as JAX's top_k). Returns (idx (W,), act (W,))."""
    KF = cfg.backend.max_keyframes
    W = min(cfg.local_window, KF)
    all_idx = torch.arange(KF, device=pose_t.device)
    act_all = all_idx < graph.n
    d2 = torch.sum((graph.t - pose_t[None, :]) ** 2, dim=1)
    recent = all_idx >= (graph.n - cfg.local_recent)
    in_radius = d2 < cfg.surrounding_radius ** 2
    big = 3.0e38
    score = torch.where(act_all & recent, d2 - big * 0.5, torch.where(act_all & in_radius, d2, big))
    best, idx = torch.sort(score, stable=True)
    return idx[:W], best[:W] < big


def _rebuild_maps(cfg: SLAMConfig, state: SLAMState, graph: bk.PoseGraph, pose_t):
    """Local maps from the surrounding-keyframe set at their (corrected)
    poses: one transform + one insert per feature family."""
    idx, act = _surrounding_keyframes(cfg, graph, pose_t)
    Rk, tk = graph.R[idx], graph.t[idx]

    def gather_tf(clouds, masks):
        world = Rk @ clouds[idx] + tk[:, :, None]            # (W, 3, N)
        m = masks[idx] & act[:, None]
        return world.transpose(0, 1).reshape(3, -1), m.reshape(-1)

    cpts, cmask = gather_tf(state.kf_corner, state.kf_corner_mask)
    spts, smask = gather_tf(state.kf_surf, state.kf_surf_mask)
    dev = pose_t.device
    corner_map = ops.insert(cfg.scan2map.corner_grid, ops.create(cfg.scan2map.corner_grid, cpts.dtype, device=dev),
                            cpts, cmask)
    surf_map = ops.insert(cfg.scan2map.surf_grid, ops.create(cfg.scan2map.surf_grid, spts.dtype, device=dev),
                          spts, smask)
    return corner_map, surf_map


def _rs_detect(cfg: SLAMConfig, graph: bk.PoseGraph, kf_time, now, pose_t):
    """RS loop candidate: nearest OLD keypose within rs_radius on the
    z-flattened keyposes (detectLoopClosureDistance :843-880), gated by the
    30 s time difference plus an index-gap guard. Returns (j, found) as
    device scalars (j = -1 when not found; ties: the lowest index)."""
    KF = cfg.backend.max_keyframes
    idx = torch.arange(KF, device=pose_t.device)
    d2 = torch.sum((graph.t[:, :2] - pose_t[:2][None, :]) ** 2, dim=1)
    time_ok = (now < 0) | ((now - kf_time) > cfg.rs_time_gate)
    eligible = (idx < (graph.n - cfg.rs_exclude_recent)) & time_ok
    best, j = torch.min(torch.where(eligible, d2, 3.0e38), dim=0)
    found = best < cfg.rs_radius ** 2
    return torch.where(found, j, -1).to(torch.int32), found


def _verify_loop(cfg: SLAMConfig, state: SLAMState, j, pose, surf_pts, surf_mask, yaw, method: str):
    """Register the current scan against the candidate's merged submap
    (loopFindNearKeyframes, mapOptmization.cpp:650-651,972): keyframes
    j-half..j+half transformed into j's frame. `j` is a host int or a device
    scalar, `yaw` a device scalar. Returns (rel pose j<-current, fitness,
    converged)."""
    dtype, dev = surf_pts.dtype, surf_pts.device
    KF = cfg.backend.max_keyframes
    half = cfg.loop_submap_half
    g = state.graph
    ks_raw = j + torch.arange(-half, half + 1, device=dev)
    ks = torch.clamp(ks_raw, 0, KF - 1)
    k_act = (ks_raw >= 0) & (ks_raw < g.n)
    jj = ks[half:half + 1]
    Rj, tj = g.R.index_select(0, jj)[0], g.t.index_select(0, jj)[0]
    c = state.kf_surf[ks]                                   # (2h+1, 3, Ns)
    m = state.kf_surf_mask[ks] & k_act[:, None]
    Rk, tk = g.R[ks], g.t[ks]
    # p_j = Rj^T (Rk p + tk - tj): neighbour clouds expressed in j's frame
    Rrel = Rj.T @ Rk
    trel = (tk - tj[None, :]) @ Rj
    tgt = (Rrel @ c + trel[:, :, None]).transpose(0, 1).reshape(3, -1)
    tgt_m = m.reshape(-1)
    # init: current pose in the matched keyframe's frame, the SC yaw as the
    # initial rotation guess
    zero = torch.zeros_like(yaw)
    init = se3.Pose(so3.exp(torch.stack([zero, zero, -yaw])) @ (Rj.T @ pose.R), Rj.T @ (pose.t - tj))
    loop_map = ops.insert(cfg.loop_grid, ops.create(cfg.loop_grid, dtype, device=dev), tgt, tgt_m)
    if method == "ndt":
        gcfg, gmap = register.ndt.build_target(cfg.loop_ndt, tgt, tgt_m, capacity=cfg.loop_grid.capacity)
        res = register.ndt.align(gcfg, gmap, surf_pts, surf_mask, init, cfg=cfg.loop_ndt)
    else:
        res = register.point_to_plane_icp(cfg.loop_grid, loop_map, surf_pts, surf_mask, init, cfg=cfg.loop_icp)
    fitness, _ = register.fitness_score(cfg.loop_grid, loop_map, res.pose.apply(surf_pts), surf_mask, max_range=1.0)
    return res.pose, fitness, res.converged


def _read(t: torch.Tensor) -> list:
    """One device -> host read of a small tensor, counted in slam_step.host_reads."""
    slam_step.host_reads += 1
    return t.tolist()


def _put(store: torch.Tensor, k: int, value) -> torch.Tensor:
    """store.at[k].set(value) without touching `store` (a device copy)."""
    out = store.clone()
    out[k] = value
    return out


def _scalar(v, dtype, device) -> torch.Tensor:
    return torch.full((), v, dtype=dtype, device=device)


def slam_step(
    cfg: SLAMConfig,
    state: SLAMState,
    corner_pts: torch.Tensor,   # (3, Nc) sensor frame
    corner_mask: torch.Tensor,
    surf_pts: torch.Tensor,     # (3, Ns)
    surf_mask: torch.Tensor,
    odom_guess: Optional[se3.Pose] = None,       # e.g. IMU/LIO incremental pose
    pim: Optional[pre.PreintegratedImu] = None,  # IMU preintegration since last keyframe
    vel_guess: Optional[torch.Tensor] = None,    # (3,) velocity estimate for the new node
    gps_pos: Optional[torch.Tensor] = None,      # (3,) GPS position measurement
    gps_cov: Optional[torch.Tensor] = None,      # (3,) GPS covariance diagonal
    gps_valid: Optional[torch.Tensor] = None,    # () bool
    time_sec=None,                               # () scan time [s], small (relative to the run start)
):
    dtype, dev = surf_pts.dtype, surf_pts.device
    i32 = torch.int32
    # clock: caller timestamps when supplied, else frame_idx * nominal period
    if time_sec is None:
        now = state.frame_idx.to(dtype) * cfg.nominal_scan_period
    elif torch.is_tensor(time_sec):
        now = time_sec.to(device=dev, dtype=dtype)
    else:
        now = _scalar(float(time_sec), dtype, dev)
    state = state._replace(time=now)
    init_pose = odom_guess if odom_guess is not None else state.pose

    # ---- scan-to-map odometry (its result unused on the very first frame) ----
    res = s2m.scan_to_map(cfg.scan2map, state.corner_map, state.surf_map,
                          corner_pts, corner_mask, surf_pts, surf_mask, init_pose)
    first = state.graph.n == 0
    pose = se3.Pose(torch.where(first, init_pose.R, res.pose.R), torch.where(first, init_pose.t, res.pose.t))

    # ---- keyframe gating; the frame's one read ----
    is_kf_dev = bk.should_add_keyframe(cfg.backend, state.graph, pose.R, pose.t)
    is_kf, n, frame_idx, loop_closed_kf, last_loop_frame, opt_sweeps = map(int, _read(torch.stack([
        is_kf_dev.to(i32), state.graph.n, state.frame_idx, state.loop_closed_kf, state.last_loop_frame,
        state.opt_sweeps])))
    is_kf = bool(is_kf)

    needs_opt_gps = False
    if is_kf:
        # the keyframe store: node + odometry/IMU/GPS factors + feature/SC
        # stores, the sliding-window solve, the local-map roll-in
        graph = bk.add_keyframe(cfg.backend, state.graph, pose.R, pose.t, vel_new=vel_guess, pim=pim)
        k = n   # is_kf implies n < max_keyframes
        if gps_pos is not None:
            cov = gps_cov if gps_cov is not None else torch.full((3,), 1e-2, dtype=dtype, device=dev)
            ok = (torch.amax(cov[:2]) < cfg.gps_cov_thresh) & (torch.linalg.norm(gps_pos - state.last_gps)
                                                                > cfg.gps_dist)
            if gps_valid is not None:
                ok = ok & gps_valid
            info = 1.0 / torch.clamp(cov, min=1e-4)
            if not cfg.use_gps_elevation:
                info = torch.cat([info[:2], torch.full((1,), 1e-6, dtype=dtype, device=dev)])  # z unconstrained
            needs_opt_gps = bool(_read(ok))
            if needs_opt_gps:
                graph = bk.add_gps(graph, k, gps_pos, info)
                state = state._replace(last_gps=gps_pos.to(dtype))
        desc, key = sc.make_descriptor(cfg.scancontext, surf_pts, surf_mask)
        state = state._replace(
            graph=graph,
            kf_corner=_put(state.kf_corner, k, corner_pts), kf_corner_mask=_put(state.kf_corner_mask, k, corner_mask),
            kf_surf=_put(state.kf_surf, k, surf_pts), kf_surf_mask=_put(state.kf_surf_mask, k, surf_mask),
            sc_descs=_put(state.sc_descs, k, desc), sc_keys=_put(state.sc_keys, k, key),
            kf_time=_put(state.kf_time, k, state.time),
        )
        if cfg.window_update:
            state = state._replace(graph=bk.optimize_window(cfg.backend, state.graph, window=cfg.window))
        # roll the keyframe's features into the local maps at the window-refined pose
        pk = se3.Pose(state.graph.R[k], state.graph.t[k])
        state = state._replace(
            corner_map=ops.insert(cfg.scan2map.corner_grid, state.corner_map, pk.apply(corner_pts), corner_mask),
            surf_map=ops.insert(cfg.scan2map.surf_grid, state.surf_map, pk.apply(surf_pts), surf_mask))
        n += 1

    # on a keyframe the pose is the graph node (window refinement included)
    kf_i = max(n - 1, 0)
    if is_kf:
        pose = se3.Pose(state.graph.R[kf_i], state.graph.t[kf_i])
    state = state._replace(pose=pose)

    # ---- dual-channel loop closure on the LATEST keyframe, at keyframe
    # creation and at a fixed frame cadence (the 1 Hz loop thread) ----
    cadence = (cfg.loop_detect_every > 0 and not is_kf and frame_idx % cfg.loop_detect_every == 0
               and loop_closed_kf != kf_i)
    do_detect = (is_kf or cadence) and n >= 2
    if cfg.loop_cooldown > 0:
        do_detect = do_detect and (frame_idx - last_loop_frame) >= cfg.loop_cooldown

    looped, loop_idx = False, -1
    if do_detect:
        g = state.graph
        k = kf_i
        pose_k = se3.Pose(g.R[k], g.t[k])
        s_pts, s_mask = state.kf_surf[k], state.kf_surf_mask[k]
        cand = sc.detect(cfg.scancontext, state.sc_descs[k], state.sc_keys[k], state.sc_descs, state.sc_keys, g.n)
        if cfg.rs_loop:
            rs_j_dev, rs_found_dev = _rs_detect(cfg, g, state.kf_time, state.time, pose_k.t)
        else:
            rs_j_dev, rs_found_dev = _scalar(-1, i32, dev), _scalar(False, torch.bool, dev)
        sc_found, sc_j, rs_found, rs_j = map(int, _read(torch.stack([
            cand.found.to(i32), cand.index, rs_found_dev.to(i32), rs_j_dev])))

        def verify(state, j, yaw, method, robust):
            pose_rel, fitness, conv = _verify_loop(cfg, state, j, pose_k, s_pts, s_mask, yaw, method)
            good = bool(_read((fitness < cfg.loop_fitness_thresh) & conv))
            if good:
                info = (1.0 / torch.clamp(fitness, min=1e-3)).to(dtype).expand(6)
                state = state._replace(
                    graph=bk.add_loop(cfg.backend, state.graph, j, k, pose_rel.R, pose_rel.t, info, robust=robust),
                    n_loops_found=state.n_loops_found + 1,
                    loop_closed_kf=_scalar(k, i32, dev),
                    last_loop_frame=_scalar(frame_idx, i32, dev))
            return state, good

        sc_added = rs_added = False
        # SC channel: ICP verification, Cauchy-robust factor (:822-835)
        if sc_found:
            state, sc_added = verify(state, sc_j, cand.yaw, "icp", True)
        # RS channel: NDT verification, plain diagonal factor (:683-731);
        # skipped when SC already closed against the same keyframe
        if rs_found and not (sc_found and rs_j == sc_j):
            state, rs_added = verify(state, rs_j, torch.zeros((), dtype=dtype, device=dev), cfg.rs_verify, False)
        looped = sc_added or rs_added
        if looped:
            loop_idx = sc_j if sc_added else rs_j

    # ---- full-graph solve (the correctPoses moment), deferred by default:
    # a loop event queues GN sweeps, one runs per frame, each applying the
    # latest node's correction to the odometry pose and rebuilding the maps ----
    trigger = looped or (needs_opt_gps and not cfg.window_update)

    def solve_and_correct(state, gn_iters, pcg_iters=None):
        g = state.graph
        R_old, t_old = g.R[kf_i], g.t[kf_i]
        g2 = bk.optimize(cfg.backend, g, gn_iterations=gn_iters, pcg_iterations=pcg_iters)
        # left (world-frame) delta of the latest node: pose' = (T_k_new T_k_old^-1) pose
        dR = g2.R[kf_i] @ R_old.T
        dt = g2.t[kf_i] - dR @ t_old
        pose2 = se3.Pose(dR @ state.pose.R, dR @ state.pose.t + dt)
        # rebuild only when the graph moved since the LAST rebuild (max node
        # displacement over all nodes, accumulated over skipped sweeps)
        delta = torch.amax(torch.linalg.norm(g2.t - g.t, dim=-1)) + state.map_stale_m
        if _read(delta > cfg.map_rebuild_min_delta):
            cmap, smap = _rebuild_maps(cfg, state, g2, g2.t[kf_i])
            state = state._replace(corner_map=cmap, surf_map=smap, map_stale_m=torch.zeros_like(delta))
        else:
            state = state._replace(map_stale_m=delta)
        return state._replace(graph=g2, pose=pose2)

    if cfg.deferred_loop_solve:
        n_sweeps, pcg_iters = deferred_sweep_plan(cfg)
        if trigger:
            opt_sweeps = n_sweeps
        if opt_sweeps > 0:
            state = solve_and_correct(state, 1, pcg_iters)
            opt_sweeps -= 1
        state = state._replace(opt_sweeps=_scalar(opt_sweeps, i32, dev))
    elif trigger:
        state = solve_and_correct(state, None)

    state = state._replace(frame_idx=state.frame_idx + 1)
    out = SLAMOutput(
        pose=state.pose,
        is_keyframe=is_kf_dev,
        loop_detected=_scalar(looped, torch.bool, dev),
        loop_index=_scalar(loop_idx, i32, dev),
        degenerate=res.degenerate,
        num_surf_matches=res.num_surf,
        opt_pending=state.opt_sweeps,
    )
    return state, out


slam_step.host_reads = 0
