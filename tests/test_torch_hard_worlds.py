"""The hard worlds on the port: `io.synthetic`'s corridor, doorway and
moving-object generators equal to the JAX package's numpy output, and the
port's `slam_step` on tests/test_hard_worlds.py's three scenarios and
tests/test_slam_async.py's three cases, held to the same gates (each test
below is the JAX one, its device calls the port's on the CPU).
"""

import numpy as np
import pytest
import torch

from pointcloud_slam_tpu.io import synthetic as jsyn
from pointcloud_slam_tpu_torch.io import synthetic
from pointcloud_slam_tpu_torch.models.liosam import slam, scan2map as s2m, backend as bk, scancontext as sc
from pointcloud_slam_tpu_torch.register import NDTConfig, SolverConfig

torch.set_num_threads(2)
DEV = "cpu"

CFG = slam.SLAMConfig(
    backend=bk.BackendConfig(max_keyframes=32, max_loops=4, keyframe_dist_thresh=0.4,
                             gn_iterations=3, pcg_iterations=30),
    n_corner=256,
    n_surf=1024,
    scan2map=s2m.Scan2MapConfig(solver=SolverConfig(max_iterations=8), degeneracy_eig=1.0),
    loop_ndt=NDTConfig(solver=SolverConfig(max_iterations=10)),
    scancontext=sc.ScanContextConfig(dist_threshold=-1.0),  # loops off: odometry stress only
    rs_loop=False,
)
# tests/test_slam_async.py's config: SC off, every closure from the RS channel
ASYNC_CFG = slam.SLAMConfig(
    backend=bk.BackendConfig(max_keyframes=32, max_loops=4, keyframe_dist_thresh=0.4,
                             gn_iterations=3, pcg_iterations=30),
    n_corner=256,
    n_surf=1024,
    scan2map=s2m.Scan2MapConfig(solver=SolverConfig(max_iterations=8), degeneracy_eig=1.0),
    loop_ndt=NDTConfig(solver=SolverConfig(max_iterations=10)),
    scancontext=sc.ScanContextConfig(dist_threshold=-1.0),
    rs_loop=True,
    rs_verify="ndt",
    rs_exclude_recent=3,
    rs_time_gate=8.0,
    loop_detect_every=4,
    nominal_scan_period=0.5,
)


def _f(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def soa(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).T))


def run_seq(scans):
    """scans: list of (corner_pts, corner_mask, surf_pts, surf_mask) numpy."""
    state = slam.create_state(CFG, device=DEV)
    outs = []
    for c, cm, s, sm in scans:
        state, out = slam.slam_step(CFG, state, soa(c), torch.from_numpy(cm), soa(s), torch.from_numpy(sm))
        outs.append(out)
    return state, outs


@pytest.mark.parametrize("name", ["corridor", "corridor_poles", "doorway", "occluded", "moving"])
def test_generators_equal_jax(name):
    R = np.eye(3, dtype=np.float32)
    t = np.array([1.5, 0.2, 1.2], np.float32)
    if name == "corridor":
        a, b = synthetic.make_corridor_world(seed=3), jsyn.make_corridor_world(seed=3)
    elif name == "corridor_poles":
        a, b = synthetic.make_corridor_world(n_poles=4, seed=1), jsyn.make_corridor_world(n_poles=4, seed=1)
    elif name == "doorway":
        a, b = synthetic.make_doorway_world(seed=1), jsyn.make_doorway_world(seed=1)
    elif name == "occluded":
        _, s, doors = synthetic.make_doorway_world(seed=1)
        a = synthetic.take_scan_occluded(s, R, t, 1024, doors, seed=5)
        b = jsyn.take_scan_occluded(s, R, t, 1024, doors, seed=5)
    else:
        a, b = synthetic.moving_object_points(1.5, n=48, seed=7), jsyn.moving_object_points(1.5, n=48, seed=7)
        a, b = (a,), (b,)
    for x, y in zip(a, b):
        if isinstance(x, list):
            assert x == y
        else:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_corridor_degeneracy_guard():
    """Driving down a featureless corridor: the along-corridor direction is
    unobservable. The degeneracy flag must fire inside, the estimate must
    FREEZE x rather than hallucinate motion, the observable directions must
    stay tight, and nothing may go NaN.

    World note: junction_gap separates the wall/floor edges — a mixed edge
    neighborhood is plane-fit-degenerate and yields an arbitrary normal
    whose spurious x component lifts H_xx to ~28 (measured; same artifact
    as the reference's esti_plane), which is indistinguishable from a
    feature-rich world's min eigenvalue (27.5 measured). With the gap the
    corridor's H_xx is honest (~0) and the flag is meaningful."""
    corners_w, surfs_w = synthetic.make_corridor_world(length=40.0, n_poles=0, seed=0)
    R = np.eye(3, dtype=np.float32)
    xs = 1.0 + 0.45 * np.arange(16)              # 1.0 -> 7.75 m down the corridor
    scans, gt = [], []
    for k, x in enumerate(xs):
        t = np.array([x, 0.0, 1.2], np.float32)
        c, cm = synthetic.take_scan(corners_w, R, t, CFG.n_corner, seed=k)
        s, sm = synthetic.take_scan(surfs_w, R, t, CFG.n_surf, seed=100 + k)
        scans.append((c, cm, s, sm))
        gt.append(t)
    state, outs = run_seq(scans)

    degen = [bool(o.degenerate) for o in outs]
    assert any(degen[2:]), f"corridor frames must trip the degeneracy guard: {degen}"
    t_est = np.stack([o.pose.t.numpy() for o in outs])
    assert np.isfinite(t_est).all()
    gt_rel = np.stack(gt) - gt[0]
    # x is unobservable: the projector must freeze it (no hallucinated
    # forward motion), not track the true 6.75 m advance
    assert abs(t_est[-1, 0]) < 0.5 * gt_rel[-1, 0], (
        f"x should freeze in a featureless corridor, est {t_est[-1, 0]} vs gt {gt_rel[-1, 0]}")
    lat_err = np.abs(t_est[:, 1:] - gt_rel[:, 1:]).max()
    assert lat_err < 0.25, f"lateral/vertical drift {lat_err} despite planes in view"
    # and the rotation stays near identity (roll/pitch/yaw all observable)
    R_last = outs[-1].pose.R.numpy()
    assert np.abs(R_last - np.eye(3)).max() < 0.1


def test_doorway_transition_recovers():
    """Crossing a doorway tunnel through a thick wall: the visible world
    collapses to the tunnel interior + two aperture slivers, then room B's
    features take over. The pipeline must stay finite and re-localize
    tightly in room B."""
    corners_w, surfs_w, doors = synthetic.make_doorway_world(seed=1)
    th = doors[1][0]
    R = np.eye(3, dtype=np.float32)
    xs = np.concatenate([
        np.linspace(-3.0, -0.5, 5),          # approach in room A
        np.linspace(-0.1, th + 0.1, 4),      # inside the tunnel
        np.linspace(th + 0.7, th + 3.0, 5),  # into room B
    ])
    # the tunnel frames must be a REAL visibility collapse: probe the world
    # directly (unique visible points, not the padded scan)
    vis_counts = []
    for x in (-3.0, th / 2, th + 3.0):
        _, m = synthetic.take_scan_occluded(
            surfs_w, R, np.array([x, 0.0, 1.2], np.float32), len(surfs_w), doors, seed=0)
        vis_counts.append(int(m.sum()))
    assert vis_counts[1] < 0.5 * min(vis_counts[0], vis_counts[2]), (
        f"tunnel must collapse visibility: {vis_counts}")

    scans, gt = [], []
    for k, x in enumerate(xs):
        t = np.array([x, 0.0, 1.2], np.float32)
        c, cm = synthetic.take_scan_occluded(corners_w, R, t, CFG.n_corner, doors, seed=k)
        s, sm = synthetic.take_scan_occluded(surfs_w, R, t, CFG.n_surf, doors, seed=100 + k)
        scans.append((c, cm, s, sm))
        gt.append(t)
    state, outs = run_seq(scans)
    t_est = np.stack([o.pose.t.numpy() for o in outs])
    assert np.isfinite(t_est).all()
    gt_rel = np.stack(gt) - gt[0]
    final_err = np.linalg.norm(t_est[-1] - gt_rel[-1])
    assert final_err < 0.4, f"failed to re-localize after the doorway: {final_err}"


def test_moving_object_outliers():
    """A pedestrian-sized cluster sweeping through the scene must not drag
    the pose estimate: error with the outliers stays close to the clean
    run's error.

    Calibration note (measured on this config): drag is roughly
    proportional to the outlier fraction — 48/1024 points (4.7%, a
    realistic pedestrian share of a scan) gives 0.135 m after 4 m of
    travel; 120/1024 (12%) gives 0.47 m. The reference has no dynamic
    filter either (the object enters its map exactly the same way); the
    gate here is bounded proportional drag, not immunity."""
    N_OBJ = 48
    corners_w, surfs_w = synthetic.make_feature_world(seed=2)
    R = np.eye(3, dtype=np.float32)
    xs = 0.4 * np.arange(11)

    def build(with_object):
        scans, gt = [], []
        for k, x in enumerate(xs):
            t = np.array([x, 0.0, 1.0], np.float32)
            c, cm = synthetic.take_scan(corners_w, R, t, CFG.n_corner, seed=k)
            s, sm = synthetic.take_scan(surfs_w, R, t, CFG.n_surf, seed=100 + k)
            if with_object:
                obj_w = synthetic.moving_object_points(0.5 * k, n=N_OBJ, seed=7)
                obj_s = (obj_w - t) @ R   # world -> sensor
                s[-N_OBJ:] = obj_s
                sm[-N_OBJ:] = True
            scans.append((c, cm, s, sm))
            gt.append(t)
        return scans, np.stack(gt)

    scans_clean, gt = build(False)
    scans_dirty, _ = build(True)
    _, outs_clean = run_seq(scans_clean)
    _, outs_dirty = run_seq(scans_dirty)
    gt_rel = gt - gt[0]
    err = lambda outs: np.linalg.norm(outs[-1].pose.t.numpy() - gt_rel[-1])
    e_clean, e_dirty = err(outs_clean), err(outs_dirty)
    assert np.isfinite(e_dirty)
    assert e_dirty < max(3.0 * e_clean, 0.2), (
        f"moving object dragged the estimate: clean {e_clean:.3f} vs dirty {e_dirty:.3f}")


def test_pause_closes_loop_and_defers_solve():
    """Out-and-back, then the robot PAUSES at the revisit: inline detections
    during the (fast) return are rejected by the time gate — the index gap
    alone would have closed them (the round-3 false-loop weakness) — and the
    cadence detector closes the loop on a NON-keyframe frame once the gate
    opens, after which the deferred solve drains one GN sweep per frame."""
    cfg = ASYNC_CFG
    corners_w, surfs_w = synthetic.make_feature_world(seed=2)
    state = slam.create_state(cfg, device=DEV)

    xs = [0.0, 0.5, 1.0, 1.5, 2.0, 2.5,          # out   (frames 0-5)
          2.0, 1.5, 1.0, 0.5, 0.02]              # back  (frames 6-10)
    xs += [0.02] * 18                            # pause (frames 11-28)
    t0 = np.array([xs[0], 0.0, 1.0], np.float32)  # SLAM world frame = first sensor pose
    recs = []
    for k, x in enumerate(xs):
        t = np.array([x, 0.0, 1.0], np.float32)
        R = np.eye(3, dtype=np.float32)
        c, cm = synthetic.take_scan(corners_w, R, t, cfg.n_corner, seed=k)
        s, sm = synthetic.take_scan(surfs_w, R, t, cfg.n_surf, seed=100 + k)
        state, out = slam.slam_step(cfg, state, soa(c), torch.from_numpy(cm), soa(s), torch.from_numpy(sm))
        recs.append((bool(out.is_keyframe), bool(out.loop_detected),
                     int(out.opt_pending), float(np.linalg.norm(out.pose.t.numpy() - (t - t0)))))

    loops = [k for k, r in enumerate(recs) if r[1]]
    # exactly one closure, and NOT at a keyframe: the return's inline
    # detections (frames 6-10, now <= 5 s < 8 s gate) must all be rejected
    assert loops, "paused revisit must close a loop once the time gate opens"
    assert all(k > 10 for k in loops), f"loop closed during the return at {loops} — time gate failed"
    k_loop = loops[0]
    assert not recs[k_loop][0], "cadence closure must fire on a non-keyframe frame"
    # cadence: closure frame index is a multiple of loop_detect_every
    assert k_loop % cfg.loop_detect_every == 0
    # one loop factor total; later cadence ticks must not re-close (the
    # loopIndexContainer role of loop_closed_kf)
    assert int(state.graph.n_loops) == 1
    assert int(state.n_loops_found) == 1

    # deferred solve: sweeps queued on the closure frame (one ran inline),
    # then drain one per frame and stay at zero. With the PCG drain slice
    # (loop_solve_pcg_slice) the queue holds proportionally more sweeps of a
    # smaller per-sweep budget — same total Krylov work.
    n_sweeps, _pcg = slam.deferred_sweep_plan(cfg)
    pend = [r[2] for r in recs]
    assert pend[k_loop] == n_sweeps - 1
    for i in range(1, n_sweeps):
        assert pend[k_loop + i] == max(n_sweeps - 1 - i, 0)
    assert pend[-1] == 0
    # the corrected pose stays consistent with the (static) ground truth
    assert recs[-1][3] < 0.3, f"post-correction pose error {recs[-1][3]}"


def test_single_sweep_iteration_matches_full():
    """bk.optimize(g, gn_iterations=1) applied N times == bk.optimize(g) with
    gn_iterations=N (the deferred solve is the same fixed-point iteration,
    just spread over frames)."""
    cfg = bk.BackendConfig(max_keyframes=16, max_loops=4, gn_iterations=3, pcg_iterations=20)
    rng = np.random.default_rng(0)
    g = bk.create(cfg, device=DEV)
    n = 12
    t_true = np.stack([np.arange(n), np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    drift = np.cumsum(rng.normal(0, 0.05, (n, 3)).astype(np.float32), 0)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3))
    KF = cfg.max_keyframes
    pad = lambda a, shape: np.concatenate([a, np.zeros((KF - n, *shape), np.float32)], 0)
    odom_t = np.concatenate([np.zeros((1, 3), np.float32), np.diff(t_true, axis=0)], 0)
    eyeKF = np.broadcast_to(np.eye(3, dtype=np.float32), (KF, 3, 3))
    g = g._replace(
        R=_f(eyeKF), t=_f(pad(t_true + drift, (3,))),
        n=torch.tensor(n, dtype=torch.int32),
        odom_R=_f(eyeKF), odom_t=_f(pad(odom_t, (3,))),
        odom_info=_f(pad(np.full((n, 6), 1e2, np.float32), (6,))),
    )
    g = bk.add_loop(cfg, g, n - 1, 0, torch.eye(3), _f(t_true[0] - t_true[n - 1]),
                    torch.full((6,), 1e3), robust=False)
    full = bk.optimize(cfg, g)
    swept = g
    for _ in range(cfg.gn_iterations):
        swept = bk.optimize(cfg, swept, gn_iterations=1)
    np.testing.assert_allclose(np.asarray(swept.t), np.asarray(full.t), atol=1e-5)
    np.testing.assert_allclose(np.asarray(swept.R), np.asarray(full.R), atol=1e-5)


def test_trust_region_bounds_gn_sweep():
    """An undamped GN sweep on a graph with a violently inconsistent loop
    factor can overshoot unboundedly (observed 1.6e5 m on TPU before the
    clamp); with cfg.max_step each sweep's largest pose move is bounded and
    the iteration stays finite."""
    cfg = bk.BackendConfig(max_keyframes=16, max_loops=4, gn_iterations=1,
                           pcg_iterations=20, max_step=2.0)
    n = 12
    KF = cfg.max_keyframes
    t_line = np.stack([np.arange(n), np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    eyeKF = np.broadcast_to(np.eye(3, dtype=np.float32), (KF, 3, 3))
    pad = lambda a: np.concatenate([a, np.zeros((KF - n, 3), np.float32)], 0)
    odom_t = np.concatenate([np.zeros((1, 3), np.float32), np.diff(t_line, axis=0)], 0)
    g = bk.create(cfg, device=DEV)._replace(
        R=_f(eyeKF), t=_f(pad(t_line)), n=torch.tensor(n, dtype=torch.int32),
        odom_R=_f(eyeKF), odom_t=_f(pad(odom_t)),
        odom_info=_f(np.concatenate(
            [np.full((n, 6), 1e2, np.float32), np.zeros((KF - n, 6), np.float32)], 0)),
    )
    # a loop factor claiming node n-1 sits 500 m from node 0 (vs the true 11)
    g_bad = bk.add_loop(cfg, g, 0, n - 1, torch.eye(3), torch.tensor([500.0, 0.0, 0.0]),
                        torch.full((6,), 1e4), robust=False)
    t0 = np.asarray(g_bad.t[:n])
    stepped = bk.optimize(cfg, g_bad, gn_iterations=1)
    move = np.abs(np.asarray(stepped.t[:n]) - t0)
    assert np.isfinite(np.asarray(stepped.t)).all()
    assert move.max() <= cfg.max_step + 1e-3, f"sweep moved {move.max()} m"
    # and many sweeps remain finite (each bounded, direction preserved)
    many = bk.optimize(cfg, g_bad, gn_iterations=8)
    assert np.isfinite(np.asarray(many.t)).all()
