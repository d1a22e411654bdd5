"""The port's pose-graph backend against the port's copy of the independent
f64 oracle (`models/liosam/oracle_backend.py`), as tests/test_backend_oracle.py
holds the JAX backend against the JAX one (same graphs, same chi2 ratios and
pose tolerances); the copy against the JAX oracle on the same graph; and
tests/test_capacity.py's saturation and growth cases on the port's
`backend.grow` and `slam.grow_state`."""

import numpy as np
import pytest
import torch

from pointcloud_slam_tpu.models.liosam import oracle_backend as ob_j
from pointcloud_slam_tpu_torch import register
from pointcloud_slam_tpu_torch.io import synthetic
from pointcloud_slam_tpu_torch.models.liosam import backend as bk
from pointcloud_slam_tpu_torch.models.liosam import oracle_backend as ob
from pointcloud_slam_tpu_torch.models.liosam import scan2map as s2m
from pointcloud_slam_tpu_torch.models.liosam import scancontext as sc
from pointcloud_slam_tpu_torch.models.liosam import slam

torch.set_num_threads(2)
EYE = torch.eye(3)
# The 200-node graphs run in 264 slots where the JAX tests use 256: past the
# backend's direct_n (256) the solve takes one cyclic-reduction level and a
# 132-node dense tail; 256 slots factor one 3,840^2 dense block, ~13 s a
# solve on two CPU threads. The active graph is the same.
KF_200 = 264


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _graph(cfg, n, n_loops, seed=0, robust=True, loop_noise=0.0):
    """tests/test_backend_oracle.py's drifted circle with ring-crossing
    loops, as the port's PoseGraph on the CPU."""
    rng = np.random.default_rng(seed)
    KF, L = cfg.max_keyframes, cfg.max_loops
    ang = np.linspace(0, 2 * np.pi, n)
    t_true = np.stack([10 * np.cos(ang), 10 * np.sin(ang), 0.05 * np.arange(n)], 1).astype(np.float32)
    drift = np.cumsum(rng.normal(0, 0.02, (n, 3)).astype(np.float32), axis=0)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (KF, 3, 3))
    odom_t = np.zeros((KF, 3), np.float32)
    odom_t[1:n] = np.diff(t_true, axis=0)
    odom_info = np.zeros((KF, 6), np.float32)
    odom_info[1:n] = 1e2
    t_est = np.zeros((KF, 3), np.float32)
    t_est[:n] = t_true + drift
    half = n // 2
    li = rng.integers(0, half - 1, n_loops).astype(np.int32)
    lj = (li + half).astype(np.int32)
    lt = (t_true[lj] - t_true[li]).astype(np.float32)
    lt += rng.normal(0, loop_noise, lt.shape).astype(np.float32)
    loop_i = np.zeros(L, np.int32)
    loop_i[:n_loops] = li
    loop_j = np.zeros(L, np.int32)
    loop_j[:n_loops] = lj
    loop_t = np.zeros((L, 3), np.float32)
    loop_t[:n_loops] = lt
    loop_info = np.zeros((L, 6), np.float32)
    loop_info[:n_loops] = 1e3
    g = bk.create(cfg, device="cpu")._replace(
        R=_t(eye.copy()), t=_t(t_est), n=torch.tensor(n, dtype=torch.int32), odom_R=_t(eye.copy()),
        odom_t=_t(odom_t), odom_info=_t(odom_info), loop_i=_t(loop_i), loop_j=_t(loop_j),
        loop_R=_t(np.broadcast_to(np.eye(3, dtype=np.float32), (L, 3, 3)).copy()), loop_t=_t(loop_t),
        loop_info=_t(loop_info), loop_robust=torch.full((L,), robust), n_loops=torch.tensor(n_loops, dtype=torch.int32))
    return g, t_true


def _np64(a, n):
    return a[:n].numpy().astype(np.float64)


class TestOracleSelf:
    def test_oracle_converges_on_noise_free_chain(self):
        g, t_true = _graph(bk.BackendConfig(max_keyframes=64, max_loops=4), 48, 2, robust=False)
        d = ob.extract_pose_slice(g)
        d["t"] = np.asarray(t_true, np.float64)
        assert ob.chi2(d, d["R"], d["t"]) < 1e-6

    def test_oracle_reduces_chi2_monotonically(self):
        g, _ = _graph(bk.BackendConfig(max_keyframes=64, max_loops=4), 48, 2, robust=False)
        _, _, hist = ob.solve(ob.extract_pose_slice(g), iters=15)
        assert hist[-1] < hist[0] * 1e-3
        assert all(b <= a * (1 + 1e-9) for a, b in zip(hist, hist[1:]))

    def test_copy_matches_jax_oracle(self):
        """The port's copy and the JAX module: the same slice, chi2 and solve."""
        g, _ = _graph(bk.BackendConfig(max_keyframes=64, max_loops=4), 48, 2, robust=True, loop_noise=0.03)
        d = ob.extract_pose_slice(g)
        dj = ob_j.extract_pose_slice(type(g)(*(v.numpy() if torch.is_tensor(v) else v for v in g)))
        assert d.keys() == dj.keys()
        for k in d:
            np.testing.assert_array_equal(d[k], dj[k])
        R, t, hist = ob.solve(d, iters=5)
        Rj, tj, hist_j = ob_j.solve(dj, iters=5)
        np.testing.assert_array_equal(t, tj)
        assert hist == hist_j and ob.chi2(d, R, t) == ob_j.chi2(dj, Rj, tj)


class TestSlicedSweeps:
    def test_sliced_drain_matches_contiguous(self):
        cfg = bk.BackendConfig(max_keyframes=KF_200, max_loops=16, gn_iterations=6, pcg_iterations=48)
        g, _ = _graph(cfg, 200, 8, robust=False, loop_noise=0.03)
        full = bk.optimize(cfg, g)
        sliced = g
        for _ in range(6 * 3):
            sliced = bk.optimize(cfg, sliced, gn_iterations=1, pcg_iterations=16)
        d = ob.extract_pose_slice(g)
        chi_full = ob.chi2(d, _np64(full.R, 200), _np64(full.t, 200))
        chi_sliced = ob.chi2(d, _np64(sliced.R, 200), _np64(sliced.t, 200))
        assert chi_sliced <= chi_full * 1.05 + 5e-3, (chi_sliced, chi_full)
        assert float((sliced.t[:200] - full.t[:200]).abs().max()) < 0.05


class TestBackendVsOracle:
    def _compare(self, n, n_loops, robust, cfg, atol_t, rtol_chi2, loop_noise=0.0):
        g, _ = _graph(cfg, n, n_loops, robust=robust, loop_noise=loop_noise)
        d = ob.extract_pose_slice(g)
        R_o, t_o, _ = ob.solve(d, iters=25)
        solved = bk.optimize(cfg, g)
        R_p, t_p = _np64(solved.R, n), _np64(solved.t, n)
        chi_o, chi_p = ob.chi2(d, R_o, t_o), ob.chi2(d, R_p, t_p)
        assert chi_p <= chi_o * (1 + rtol_chi2) + 5e-3, f"PCG underconverged: chi2 {chi_p:.6g} vs oracle {chi_o:.6g}"
        assert float(np.abs(t_p - t_o).max()) < atol_t

    def test_plain_loops_match_oracle(self):
        cfg = bk.BackendConfig(max_keyframes=KF_200, max_loops=16, gn_iterations=6, pcg_iterations=60)
        self._compare(200, 8, robust=False, cfg=cfg, atol_t=0.15, rtol_chi2=0.05, loop_noise=0.03)

    def test_robust_loops_match_oracle(self):
        cfg = bk.BackendConfig(max_keyframes=KF_200, max_loops=16, gn_iterations=8, pcg_iterations=60)
        self._compare(200, 8, robust=True, cfg=cfg, atol_t=0.15, rtol_chi2=0.10)

    def test_outlier_loop_is_downweighted_like_oracle(self):
        cfg = bk.BackendConfig(max_keyframes=128, max_loops=8, gn_iterations=8, pcg_iterations=60)
        g, _ = _graph(cfg, 96, 3, robust=True)
        loop_t = g.loop_t.clone()
        loop_t[0, 0] += 20.0
        g = g._replace(loop_t=loop_t)
        d = ob.extract_pose_slice(g)
        R_o, t_o, _ = ob.solve(d, iters=25)
        solved = bk.optimize(cfg, g)
        R_p, t_p = _np64(solved.R, 96), _np64(solved.t, 96)
        chi_o, chi_p = ob.chi2(d, R_o, t_o), ob.chi2(d, R_p, t_p)
        assert chi_p <= chi_o * 1.02 + 5e-3, (chi_p, chi_o)
        assert float(np.abs(t_p - t_o).max()) < 0.25


# ---- tests/test_capacity.py on the port ----


def _fill_keyframes(cfg, g, xs):
    for x in xs:
        g = bk.add_keyframe(cfg, g, EYE, torch.tensor([x, 0.0, 0.0]))
    return g


class TestBackendSaturation:
    def test_keyframe_saturation_is_noop(self):
        cfg = bk.BackendConfig(max_keyframes=4, max_loops=4)
        g = _fill_keyframes(cfg, bk.create(cfg, device="cpu"), [0.0, 1.0, 2.0, 3.0, 4.0, 5.0])
        assert int(g.n) == 4
        t = g.t.numpy()
        np.testing.assert_allclose(t[:, 0], [0, 1, 2, 3], atol=1e-6)
        np.testing.assert_allclose(g.odom_t.numpy()[1:4, 0], t[1:4, 0] - t[0:3, 0], atol=1e-6)
        np.testing.assert_allclose(bk.optimize(cfg, g).t.numpy(), t, atol=1e-4)

    def test_should_add_keyframe_gates_on_capacity(self):
        cfg = bk.BackendConfig(max_keyframes=4, max_loops=4, keyframe_dist_thresh=0.1)
        g = _fill_keyframes(cfg, bk.create(cfg, device="cpu"), [0.0, 1.0, 2.0])
        far = torch.tensor([10.0, 0.0, 0.0])
        assert bool(bk.should_add_keyframe(cfg, g, EYE, far))
        g = _fill_keyframes(cfg, g, [3.0])
        assert int(g.n) == 4 and not bool(bk.should_add_keyframe(cfg, g, EYE, far))

    def test_loop_saturation_is_noop(self):
        cfg = bk.BackendConfig(max_keyframes=8, max_loops=2)
        g = _fill_keyframes(cfg, bk.create(cfg, device="cpu"), [0.0, 1.0, 2.0, 3.0])
        info = torch.full((6,), 100.0)
        g = bk.add_loop(cfg, g, 0, 2, EYE, torch.tensor([2.0, 0, 0]), info)
        g = bk.add_loop(cfg, g, 1, 3, EYE, torch.tensor([2.0, 0, 0]), info)
        assert int(g.n_loops) == 2
        before = [a.clone() for a in (g.loop_i, g.loop_j, g.loop_t, g.loop_info)]
        g = bk.add_loop(cfg, g, 0, 3, EYE, torch.tensor([99.0, 0, 0]), info)
        assert int(g.n_loops) == 2
        for a, b in zip(before, (g.loop_i, g.loop_j, g.loop_t, g.loop_info)):
            assert torch.equal(a, b)


class TestGrow:
    def _noisy_graph(self, cfg, n=8, seed=0):
        rng = np.random.default_rng(seed)
        g = bk.create(cfg, device="cpu")
        for k in range(n):
            g = bk.add_keyframe(cfg, g, EYE, torch.tensor([k, 0.1 * rng.standard_normal(), 0.0], dtype=torch.float32))
        return bk.add_loop(cfg, g, 0, n - 1, EYE, torch.tensor([float(n - 1), 0, 0]), torch.full((6,), 50.0),
                           robust=False)

    def test_grow_preserves_solution(self):
        cfg = bk.BackendConfig(max_keyframes=8, max_loops=2, gn_iterations=4, pcg_iterations=40)
        g = self._noisy_graph(cfg)
        cfg2, g2 = bk.grow(cfg, g)
        assert cfg2.max_keyframes == 16 and cfg2.max_loops == 4
        np.testing.assert_allclose(bk.optimize(cfg, g).t.numpy()[:8], bk.optimize(cfg2, g2).t.numpy()[:8], atol=1e-3)
        np.testing.assert_allclose(g2.R.numpy()[12], np.eye(3), atol=0)

    def test_grow_then_continue_adding(self):
        cfg = bk.BackendConfig(max_keyframes=4, max_loops=2)
        g = _fill_keyframes(cfg, bk.create(cfg, device="cpu"), [0.0, 1.0, 2.0, 3.0])
        assert int(g.n) == 4
        cfg, g = bk.grow(cfg, g)
        g = _fill_keyframes(cfg, g, [4.0, 5.0])
        assert int(g.n) == 6
        t = g.t.numpy()
        np.testing.assert_allclose(t[:6, 0], [0, 1, 2, 3, 4, 5], atol=1e-6)
        np.testing.assert_allclose(g.odom_t.numpy()[1:6, 0], t[1:6, 0] - t[0:5, 0], atol=1e-6)

    def test_grow_rejects_shrink(self):
        cfg = bk.BackendConfig(max_keyframes=8, max_loops=2)
        with pytest.raises(ValueError):
            bk.grow(cfg, bk.create(cfg, device="cpu"), max_keyframes=4)


def test_slam_freeze_then_grow_resumes():
    """slam_step freezes safely at capacity; grow_state resumes mapping."""
    cfg = slam.SLAMConfig(
        backend=bk.BackendConfig(max_keyframes=6, max_loops=2, keyframe_dist_thresh=0.4, gn_iterations=2,
                                 pcg_iterations=16),
        n_corner=256, n_surf=2048,
        scan2map=s2m.Scan2MapConfig(solver=register.SolverConfig(max_iterations=6), degeneracy_eig=1.0),
        loop_icp=register.ICPConfig(solver=register.SolverConfig(max_iterations=4)),
        scancontext=sc.ScanContextConfig(exclude_recent=3, dist_threshold=0.35, num_candidates=4),
    )
    corners_w, surfs_w = synthetic.make_feature_world()
    state = slam.create_state(cfg, device="cpu")

    def run(cfg, state, xs, k0):
        for k, x in enumerate(xs):
            t = np.array([x, 0.0, 1.0], np.float32)
            R = np.eye(3, dtype=np.float32)
            c, cm = synthetic.take_scan(corners_w, R, t, cfg.n_corner, seed=k0 + k)
            s, sm = synthetic.take_scan(surfs_w, R, t, cfg.n_surf, seed=100 + k0 + k)
            state, out = slam.slam_step(cfg, state, _t(c.T.copy()), _t(cm), _t(s.T.copy()), _t(sm))
        return state, out

    state, out = run(cfg, state, [0.5 * k for k in range(9)], 0)
    assert int(state.graph.n) == 6
    t = state.graph.t.numpy()[:6]
    np.testing.assert_allclose(state.graph.odom_t.numpy()[1:6, 0], t[1:6, 0] - t[0:5, 0], atol=0.15)
    assert slam.needs_growth(cfg, state)
    cfg, state = slam.grow_state(cfg, state)
    assert cfg.backend.max_keyframes == 12 and cfg.backend.max_loops == 4
    state, out = run(cfg, state, [4.5, 5.0, 5.5], 20)
    assert int(state.graph.n) >= 8
    assert abs(float(out.pose.t[0]) - 5.5) < 0.5
