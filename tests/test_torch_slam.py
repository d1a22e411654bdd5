"""The port's LIO-SAM `slam_step` (`pointcloud_slam_tpu_torch.models.liosam.
slam`) against the JAX package: its parts on a JAX-populated state carried
over by `convert.slam_state_from_numpy` (the way bench.py config 6
populates one), the whole step under tests/test_slam.py's own gates at its
config, and `apps/run_slam_offline_torch.py` on the CPU. Tolerances are
stated at each assertion. The ICP loop verification is held to JAX in
tests/test_torch_loop_verify.py.

Compiling JAX's `slam_step` takes ~2 minutes on the CPU, so the
frame-by-frame comparison with it is marked `heavy` (run with --heavy).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu import register as jreg
from pointcloud_slam_tpu.geom import se3 as jse3
from pointcloud_slam_tpu.models.liosam import backend as jbk
from pointcloud_slam_tpu.models.liosam import scan2map as js2m
from pointcloud_slam_tpu.models.liosam import scancontext as jsc
from pointcloud_slam_tpu.models.liosam import slam as jslam
from pointcloud_slam_tpu_torch import convert, ops as tops, register as treg
from pointcloud_slam_tpu_torch.geom import se3 as tse3
from pointcloud_slam_tpu_torch.io import synthetic as tsyn
from pointcloud_slam_tpu_torch.models.liosam import backend as tbk
from pointcloud_slam_tpu_torch.models.liosam import scan2map as ts2m
from pointcloud_slam_tpu_torch.models.liosam import scancontext as tsc
from pointcloud_slam_tpu_torch.models.liosam import slam as tslam

torch.set_num_threads(2)

PRE = 36          # pre-populated keyframes
KF_DT = 0.5       # their time spacing [s] (bench.py config 6)
KF_ANG = 0.06     # their spacing on the circle [rad]


def _cfg(slam, bk, s2m, sc, reg):
    """tests/test_slam.py's config with the stores cut to 48 keyframes and
    128 / 512 points (one definition for both packages)."""
    return slam.SLAMConfig(
        backend=bk.BackendConfig(max_keyframes=48, max_loops=4, keyframe_dist_thresh=0.4, gn_iterations=3,
                                 pcg_iterations=30),
        n_corner=128, n_surf=512,
        scan2map=s2m.Scan2MapConfig(solver=reg.SolverConfig(max_iterations=8), degeneracy_eig=1.0),
        loop_icp=reg.ICPConfig(solver=reg.SolverConfig(max_iterations=6)),
        scancontext=sc.ScanContextConfig(exclude_recent=3, dist_threshold=0.35),
    )


CFG_J = _cfg(jslam, jbk, js2m, jsc, jreg)
CFG_T = _cfg(tslam, tbk, ts2m, tsc, treg)


def _circle(ang):
    return np.array([6.0 * np.cos(ang) - 6.0, 6.0 * np.sin(ang), 1.0], np.float32)


def _scan(world, t, n_corner, n_surf, seed):
    corners_w, surfs_w = world
    eye = np.eye(3, dtype=np.float32)
    c, cm = tsyn.take_scan(corners_w, eye, t, n_corner, seed=seed)
    s, sm = tsyn.take_scan(surfs_w, eye, t, n_surf, seed=1000 + seed)
    return np.ascontiguousarray(c.T), cm, np.ascontiguousarray(s.T), sm


def _np(tree):
    if isinstance(tree, tuple):
        return type(tree)(*(_np(v) for v in tree))
    return tree.detach().numpy() if torch.is_tensor(tree) else np.asarray(tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _populate():
    """A JAX SLAMState holding PRE keyframes along a circle in the feature
    world (>30 s old: RS-eligible), its descriptors from one batched call and
    its local maps from JAX's own rebuild; and the same state in the port."""
    cfg = CFG_J
    KF = cfg.backend.max_keyframes
    world = tsyn.make_feature_world()
    poses = np.stack([_circle(KF_ANG * i) for i in range(PRE)])
    scans = [_scan(world, poses[i], cfg.n_corner, cfg.n_surf, seed=6000 + i) for i in range(PRE)]
    kf = [np.zeros((KF,) + a.shape, a.dtype) for a in scans[0]]
    for i, sc_i in enumerate(scans):
        for store, a in zip(kf, sc_i):
            store[i] = a
    descs, keys = jax.vmap(lambda p, m: jsc.make_descriptor(cfg.scancontext, p, m))(jnp.asarray(kf[2]),
                                                                                    jnp.asarray(kf[3]))
    t_all = np.zeros((KF, 3), np.float32)
    t_all[:PRE] = poses
    odom_t = np.zeros((KF, 3), np.float32)
    odom_t[1:PRE] = poses[1:] - poses[:-1]
    oinfo = np.zeros((KF, 6), np.float32)
    oinfo[1:PRE] = [1e6] * 3 + [1e4] * 3
    kf_time = np.zeros(KF, np.float32)
    kf_time[:PRE] = np.arange(PRE) * KF_DT
    state = jslam.create_state(cfg)
    g = state.graph._replace(t=jnp.asarray(t_all), n=jnp.asarray(PRE, jnp.int32), odom_t=jnp.asarray(odom_t),
                             odom_info=jnp.asarray(oinfo))
    state = state._replace(
        graph=g, kf_corner=jnp.asarray(kf[0]), kf_corner_mask=jnp.asarray(kf[1]), kf_surf=jnp.asarray(kf[2]),
        kf_surf_mask=jnp.asarray(kf[3]), sc_descs=descs, sc_keys=keys, kf_time=jnp.asarray(kf_time),
        pose=jse3.Pose(state.pose.R, jnp.asarray(poses[-1])),
        frame_idx=jnp.asarray(int(PRE * KF_DT / cfg.nominal_scan_period), jnp.int32))
    cmap, smap = jslam._rebuild_maps(cfg, state, state.graph, state.graph.t[PRE - 1])
    state = _np(state._replace(corner_map=cmap, surf_map=smap))
    return state, convert.slam_state_from_numpy(state, "cpu"), world


@pytest.fixture(scope="module")
def populated():
    return _populate()


def _jax_state(s):
    return jax.tree.map(jnp.asarray, s)


def test_state_round_trip(populated):
    """slam_state_from_numpy and to_numpy: every leaf back bit for bit, in
    the JAX package's dtypes."""
    js, ts, _ = populated
    back = convert.to_numpy(ts)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _jax_selection(cfg, g, pose_t):
    """The selection inside JAX's _rebuild_maps (slam.py:279-291)."""
    KF = cfg.backend.max_keyframes
    W = min(cfg.local_window, KF)
    all_idx = jnp.arange(KF)
    act_all = all_idx < g.n
    d2 = jnp.sum((g.t - pose_t[None, :]) ** 2, axis=1)
    recent = all_idx >= (g.n - cfg.local_recent)
    BIG = jnp.asarray(3.0e38, d2.dtype)
    score = jnp.where(act_all & recent, d2 - BIG * 0.5,
                      jnp.where(act_all & (d2 < cfg.surrounding_radius ** 2), d2, BIG))
    neg_best, idx = jax.lax.top_k(-score, W)
    return np.asarray(idx), np.asarray(-neg_best < BIG)


@pytest.mark.parametrize("at", [10, PRE - 1])
def test_rebuild_maps_matches_jax(populated, at):
    """The surrounding-keyframe set in JAX's order (the local_recent newest
    tie at d2 - 1.5e38 and come first, lowest index first; then the nearest),
    and the rebuilt maps: every k-NN answer (5 neighbours, 1 m) of the
    port's map equal to JAX's map's (d2 at rtol 1e-6, counts equal)."""
    js, ts, world = populated
    jg = _jax_state(js.graph)
    pose_t = js.graph.t[at] + np.float32(0.05)
    idx_j, act_j = _jax_selection(CFG_J, jg, jnp.asarray(pose_t))
    idx_t, act_t = tslam._surrounding_keyframes(CFG_T, ts.graph, _t(pose_t))
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    np.testing.assert_array_equal(act_t.numpy(), act_j)
    assert list(idx_j[:6]) == list(range(PRE - 6, PRE))
    cj, sj = jslam._rebuild_maps(CFG_J, _jax_state(js), jg, jnp.asarray(pose_t))
    ct, st_ = tslam._rebuild_maps(CFG_T, ts, ts.graph, _t(pose_t))
    q = _t(_scan(world, pose_t, 128, 512, seed=5)[2] + pose_t[:, None])     # world points
    for grid_cfg, mt, mj in ((CFG_T.scan2map.corner_grid, ct, cj), (CFG_T.scan2map.surf_grid, st_, sj)):
        _, d2t, nt, _ = tops.knn(grid_cfg, mt, q, k=5, max_range=1.0)
        _, d2j, nj, _ = tops.knn(grid_cfg, convert.grid_from_numpy(_np(mj), "cpu"), q, k=5, max_range=1.0)
        np.testing.assert_array_equal(nt.numpy(), nj.numpy())
        np.testing.assert_allclose(d2t.numpy(), d2j.numpy(), rtol=1e-6)
        assert int(nt.sum()) > 0


@pytest.mark.parametrize("at,now", [(3, 100.0), (3, 10.0), (20, 100.0), (3, -1.0)])
def test_rs_detect_matches_jax(populated, at, now):
    """RS candidates: the same keyframe and verdict (the 30 s time gate, the
    index-gap guard, the radius), with a clock and with the -1 sentinel."""
    js, ts, _ = populated
    pose_t = js.graph.t[at] + np.float32(0.1)
    jj, fj = jslam._rs_detect(CFG_J, _jax_state(js.graph), jnp.asarray(js.kf_time), jnp.asarray(now, jnp.float32),
                              jnp.asarray(pose_t))
    tj, ft = tslam._rs_detect(CFG_T, ts.graph, ts.kf_time, torch.tensor(now), _t(pose_t))
    assert (int(tj), bool(ft)) == (int(jj), bool(fj))
    assert bool(ft) == (now > 30.0 + at * KF_DT or now < 0)


def test_verify_loop_ndt_matches_jax(populated):
    """The RS channel's NDT verification of a revisit scan 0.22 m from
    keyframe 5 against its merged submap (keyframes 1..9), from a guess
    0.15 m and 2 deg off, beside JAX's compiled align (NDT has no plane fit,
    so no jit gap): the relative pose within 1e-4 m / 1e-4, fitness at rtol
    1e-4, the same convergence flag and verdict; within 5 cm of the truth."""
    js, ts, world = populated
    j = 5
    true_t = js.graph.t[j] + np.array([0.2, -0.1, 0.0], np.float32)
    _, _, s, sm = _scan(world, true_t, 128, 512, seed=77)
    guess_t = true_t + np.array([0.1, 0.1, 0.05], np.float32)
    c, sn = np.float32(np.cos(0.035)), np.float32(np.sin(0.035))
    Rg = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]], np.float32)
    pj, fit_j, conv_j = jslam._verify_loop(CFG_J, _jax_state(js), jnp.asarray(j),
                                           jse3.Pose(jnp.asarray(Rg), jnp.asarray(guess_t)), jnp.asarray(s),
                                           jnp.asarray(sm), jnp.zeros(()), "ndt")
    pt, fit_t, conv_t = tslam._verify_loop(CFG_T, ts, j, tse3.Pose(_t(Rg), _t(guess_t)), _t(s), _t(sm),
                                           torch.zeros(()), "ndt")
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=1e-4)
    np.testing.assert_allclose(pt.R.numpy(), np.asarray(pj.R), atol=1e-4)
    np.testing.assert_allclose(float(fit_t), float(fit_j), rtol=1e-4)
    assert bool(conv_t) == bool(conv_j)
    assert (float(fit_t) < CFG_T.loop_fitness_thresh) == (float(fit_j) < CFG_J.loop_fitness_thresh)
    assert np.linalg.norm(pt.t.numpy() - (true_t - js.graph.t[j])) < 0.05


def test_keyframe_gate_and_add_match_jax(populated):
    """should_add_keyframe on both sides of the 0.4 m gate, then add_keyframe
    (node, odometry factor, counters) equal to JAX's at 1e-6."""
    js, ts, _ = populated
    jg = _jax_state(js.graph)
    last = js.graph.t[PRE - 1]
    R = np.eye(3, dtype=np.float32)
    for step in (0.1, 0.5):
        t_new = last + np.array([step, 0.0, 0.0], np.float32)
        a = bool(tbk.should_add_keyframe(CFG_T.backend, ts.graph, _t(R), _t(t_new)))
        assert a == bool(jbk.should_add_keyframe(CFG_J.backend, jg, jnp.asarray(R), jnp.asarray(t_new))) == (step > 0.4)
    gt_ = tbk.add_keyframe(CFG_T.backend, ts.graph, _t(R), _t(last + 0.5))
    gj = jbk.add_keyframe(CFG_J.backend, jg, jnp.asarray(R), jnp.asarray(last + 0.5))
    for f in ("R", "t", "vel", "bg", "ba", "n", "odom_R", "odom_t", "odom_info"):
        np.testing.assert_allclose(_np(getattr(gt_, f)), np.asarray(getattr(gj, f)), atol=1e-6, err_msg=f)
    assert int(gt_.n) == PRE + 1


def test_grow_state_keeps_keyframes_bitwise(populated):
    """grow_state doubles every store; the existing keyframes bit for bit,
    JAX's padded stores equal."""
    js, ts, _ = populated
    cj, sj = jslam.grow_state(CFG_J, _jax_state(js))
    ct, st_ = tslam.grow_state(CFG_T, ts)
    assert ct.backend.max_keyframes == cj.backend.max_keyframes == 96
    for f in ("kf_corner", "kf_corner_mask", "kf_surf", "kf_surf_mask", "sc_descs", "sc_keys", "kf_time"):
        np.testing.assert_array_equal(_np(getattr(st_, f)), np.asarray(getattr(sj, f)), err_msg=f)
    assert not tslam.needs_growth(ct, st_) and tslam.needs_growth(CFG_T, ts, margin=PRE)


# ---- the port's slam_step under tests/test_slam.py's gates, at its config ----

def _test_slam_cfg():
    return tslam.SLAMConfig(
        backend=tbk.BackendConfig(max_keyframes=32, max_loops=4, keyframe_dist_thresh=0.4, gn_iterations=3,
                                  pcg_iterations=30),
        n_corner=256, n_surf=2048,
        scan2map=ts2m.Scan2MapConfig(solver=treg.SolverConfig(max_iterations=8), degeneracy_eig=1.0),
        loop_icp=treg.ICPConfig(solver=treg.SolverConfig(max_iterations=6)),
        scancontext=tsc.ScanContextConfig(exclude_recent=3, dist_threshold=0.35),
    )


def _run(cfg, world, xs):
    """Frames along x at z = 1 (identity attitude), as tests/test_slam.py
    takes them; returns the outputs and the host reads of each frame."""
    corners_w, surfs_w = world
    state = tslam.create_state(cfg, device="cpu")
    outs, reads = [], []
    for k, x in enumerate(xs):
        t = np.array([x, 0.0, 1.0], np.float32)
        c, cm = tsyn.take_scan(corners_w, np.eye(3, dtype=np.float32), t, cfg.n_corner, seed=k)
        s, sm = tsyn.take_scan(surfs_w, np.eye(3, dtype=np.float32), t, cfg.n_surf, seed=100 + k)
        r0 = tslam.slam_step.host_reads
        state, out = tslam.slam_step(cfg, state, _t(c.T), _t(cm), _t(s.T), _t(sm))
        reads.append(tslam.slam_step.host_reads - r0)
        outs.append(out)
    return state, outs, reads


def test_slam_step_odometry_and_keyframes():
    """tests/test_slam.py::test_odometry_and_keyframes: a straight line of 8
    frames 0.7 m apart; drift below 0.3 m (world frame = the first sensor
    pose). A plain keyframe frame reads the device once."""
    cfg = _test_slam_cfg()
    xs = [0.7 * k for k in range(8)]
    state, outs, reads = _run(cfg, tsyn.make_feature_world(), xs)
    err = np.linalg.norm(outs[-1].pose.t.numpy() - np.array([xs[-1], 0.0, 0.0]))
    assert int(state.graph.n) >= 2
    assert err < 0.3, f"odometry drift {err}"
    assert reads[0] == 1 and all(r >= 1 for r in reads)


def test_slam_step_loop_closure_fires_on_revisit():
    """tests/test_slam.py::test_loop_closure_fires_on_revisit: an out-and-back
    path revisiting the start closes at least one verified loop."""
    cfg = _test_slam_cfg()
    xs = [0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 2.0, 1.5, 1.0, 0.5, 0.02]
    state, outs, _ = _run(cfg, tsyn.make_feature_world(seed=2), xs)
    loops = sum(int(o.loop_detected) for o in outs)
    assert loops >= 1, "revisit must trigger at least one verified loop closure"
    assert int(state.n_loops_found) == loops and int(state.graph.n_loops) >= 1


def test_run_slam_offline_torch_app(tmp_path, capsys):
    """apps/run_slam_offline_torch.py --device cpu --synthetic 12: runs to the
    end and writes the TUM trajectory (12 poses), the KITTI poses and a g2o
    graph that loads back with one vertex per keyframe."""
    from apps import run_slam_offline_torch as app
    from pointcloud_slam_tpu_torch.utils import checkpoint as ck

    app.main(["--synthetic", "12", "--device", "cpu", "--out_dir", str(tmp_path)])
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith("frames: 12")
    n_kf = int(line.split("keyframes:")[1].split()[0])
    assert len(open(tmp_path / "traj_tum.txt").read().splitlines()) == 12
    assert len(open(tmp_path / "poses_kitti.txt").read().splitlines()) == n_kf >= 2
    ids, ts, qs, edges = ck.load_pose_graph_g2o(str(tmp_path / "graph.g2o"))
    assert ids == list(range(n_kf)) and len(edges) >= n_kf - 1
    assert np.isfinite(ts).all() and np.allclose(np.linalg.norm(qs, axis=1), 1.0, atol=1e-5)


@pytest.mark.heavy
def test_slam_step_frame_by_frame_matches_jax():
    """The port's slam_step beside JAX's compiled one on the out-and-back
    path of tests/test_slam.py (11 frames, from one empty state): the same
    keyframe decisions and loop closures on the same frames against the same
    keyframes, poses within 1 cm and 0.5 deg of JAX's at every frame. (JAX's
    compiled plane_fit differs from eager ops near the origin, ROADMAP §3:
    the gap is ~1 mm a frame here.)"""
    cfg_t = _test_slam_cfg()
    cfg_j = jslam.SLAMConfig(
        backend=jbk.BackendConfig(max_keyframes=32, max_loops=4, keyframe_dist_thresh=0.4, gn_iterations=3,
                                  pcg_iterations=30),
        n_corner=256, n_surf=2048,
        scan2map=js2m.Scan2MapConfig(solver=jreg.SolverConfig(max_iterations=8), degeneracy_eig=1.0),
        loop_icp=jreg.ICPConfig(solver=jreg.SolverConfig(max_iterations=6)),
        scancontext=jsc.ScanContextConfig(exclude_recent=3, dist_threshold=0.35),
    )
    corners_w, surfs_w = tsyn.make_feature_world(seed=2)
    step = jax.jit(lambda st, c, cm, s, sm: jslam.slam_step(cfg_j, st, c, cm, s, sm))
    sj, st_ = jslam.create_state(cfg_j), tslam.create_state(cfg_t, device="cpu")
    xs = [0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 2.0, 1.5, 1.0, 0.5, 0.02]
    for k, x in enumerate(xs):
        t = np.array([x, 0.0, 1.0], np.float32)
        c, cm = tsyn.take_scan(corners_w, np.eye(3, dtype=np.float32), t, 256, seed=k)
        s, sm = tsyn.take_scan(surfs_w, np.eye(3, dtype=np.float32), t, 2048, seed=100 + k)
        sj, oj = step(sj, jnp.asarray(c.T), jnp.asarray(cm), jnp.asarray(s.T), jnp.asarray(sm))
        st_, ot = tslam.slam_step(cfg_t, st_, _t(c.T), _t(cm), _t(s.T), _t(sm))
        assert bool(ot.is_keyframe) == bool(oj.is_keyframe), k
        assert (bool(ot.loop_detected), int(ot.loop_index)) == (bool(oj.loop_detected), int(oj.loop_index)), k
        assert int(ot.opt_pending) == int(oj.opt_pending), k
        np.testing.assert_allclose(ot.pose.t.numpy(), np.asarray(oj.pose.t), atol=1e-2, err_msg=str(k))
        dR = np.asarray(oj.pose.R).T @ ot.pose.R.numpy()
        assert np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))) < 0.5, k
    assert int(st_.graph.n) == int(sj.graph.n) and int(st_.n_loops_found) == int(sj.n_loops_found) >= 1
