"""Tests of the port's hand-written CUDA kernels on the card (marker `cuda`).

They skip on a machine without a CUDA device. This file imports torch and
the port only, so on a machine without JAX it runs with the repo's
conftest.py left out:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from pointcloud_slam_tpu_torch.ops import bf_knn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7, 8, 9, 16, 20, 21, 32])
@pytest.mark.parametrize("n,m", [(1, 5), (100, 5000), (300, 700), (1500, 2049), (700, 9001)])
def test_bf_knn_kernel_matches_plain(cuda, k, n, m):
    """Ragged sizes (no tile multiples), k > M included, every instance and
    the k between them, fewer queries than one block (1, 100), ranges that
    are empty or shorter than k (M = 5) and shapes the plan splits further
    (S > 4 from M = 2049 on): d2 at rtol 1e-5 / atol 1e-6 (FMA
    vs separate multiply-add), index sets equal away from near-ties, rows
    ascending, launches counted."""
    g = np.random.default_rng(k * 1000 + n)
    q = torch.from_numpy(g.uniform(-5, 5, size=(3, n)).astype(np.float32)).to(cuda)
    db = torch.from_numpy(g.uniform(-5, 5, size=(3, m)).astype(np.float32)).to(cuda)
    before = bf_knn.knn.launches
    d2, idx = bf_knn.knn(q, db, k=k)
    torch.cuda.synchronize()
    assert bf_knn.knn.launches == before + 1
    assert d2.shape == (k, n) and idx.shape == (k, n) and idx.dtype == torch.int32
    pd2, pidx = bf_knn.knn_plain(q, db, k=k + 1)
    torch.testing.assert_close(d2, pd2[:k], rtol=1e-5, atol=1e-6)
    assert bool((d2[1:] >= d2[:-1]).all())
    if m > k:
        clear = (pd2[k] - pd2[k - 1]) > 1e-6 * pd2[k]
        same = (torch.sort(idx, 0).values == torch.sort(pidx[:k], 0).values).all(0)
        assert bool(same[clear].all())
    else:  # fewer database points than k: the tail is -1 / 3e38
        assert bool((idx[m:] == -1).all()) and bool((d2[m:] > 1e38).all())


def test_bf_knn_plan_splits_these_shapes():
    """The shapes above that are meant to split beyond a block's four ranges
    do, and a short database does not."""
    assert bf_knn.plan(1500, 2049, 8)[1] > 4 and bf_knn.plan(700, 9001, 20)[1] > 4
    assert bf_knn.plan(100, 5000, 1)[1] > 4
    assert bf_knn.plan(300, 700, 8)[1] == 4 and bf_knn.plan(1, 5, 8)[1] == 4


@pytest.mark.parametrize("splits", [4, 8, 12, 16])
@pytest.mark.parametrize("k", [1, 8, 20])
def test_bf_knn_kernel_every_plan_matches_plain(cuda, k, splits):
    """Both passes at every number of ranges, integer coordinates so that
    distances tie in masses: d2 and indices equal to the plain version
    exactly (every product and sum is exact), whatever the split."""
    instance = bf_knn.plan(777, 3001, k)[0]
    g = np.random.default_rng(k + 10 * splits)
    q = torch.from_numpy(g.integers(-6, 6, size=(3, 777)).astype(np.float32)).to(cuda)
    db = torch.from_numpy(g.integers(-6, 6, size=(3, 3001)).astype(np.float32)).to(cuda)
    d2, idx = bf_knn.run_plan(q, db, k, instance, splits)
    torch.cuda.synchronize()
    pd2, pidx = bf_knn.knn_plain(q, db, k=k)
    assert torch.equal(d2, pd2) and torch.equal(idx, pidx)


@pytest.mark.parametrize("case", ["approaching", "identical", "far_queries"])
@pytest.mark.parametrize("k", [1, 8, 20])
def test_bf_knn_kernel_hard_orders(cuda, case, k):
    """Orders that stress the queues and the bounds the ranges share: a
    database sorted so that every point beats the ones before it, a database
    of one repeated point (indices 0..k-1 must come out), and queries that
    pad_cloud moved far away. Integer coordinates: equal to the plain
    version exactly."""
    g = np.random.default_rng(k)
    db = g.integers(-40, 40, size=(3, 5000)).astype(np.float32)
    q = g.integers(-2, 3, size=(3, 500)).astype(np.float32)
    if case == "approaching":
        db = db[:, np.argsort(-(db ** 2).sum(0), kind="stable")]
    elif case == "identical":
        db[:] = 7.0
    else:
        q[:, ::3] = 1.0e17
        db[:, ::5] = 1.0e17
    q, db = torch.from_numpy(q).to(cuda), torch.from_numpy(np.ascontiguousarray(db)).to(cuda)
    d2, idx = bf_knn.knn(q, db, k=k)
    torch.cuda.synchronize()
    pd2, pidx = bf_knn.knn_plain(q, db, k=k)
    if case == "far_queries":      # (1e17 - x)^2 rounds differently with and without FMA
        torch.testing.assert_close(d2, pd2, rtol=1e-5, atol=1e-6)
        near = q[0] < 1e16
        assert torch.equal(idx[:, near], pidx[:, near])
    else:
        assert torch.equal(d2, pd2) and torch.equal(idx, pidx)
    if case == "identical":
        assert idx[:, 0].tolist() == list(range(k))


def test_bf_knn_kernel_ties_and_masking(cuda):
    db = torch.tensor([[1.0, -1.0, 0.0, 1.0], [0, 0, 2, 0], [0, 0, 0, 0]], device=cuda)
    d2, idx = bf_knn.knn(torch.zeros(3, 1, device=cuda), db, k=5)
    assert idx[:, 0].tolist() == [0, 1, 3, 2, -1]
    pts = torch.rand(3, 600, device=cuda)
    mask = torch.arange(600, device=cuda) < 300
    far = bf_knn.pad_cloud(pts, mask, 1)
    _, idx = bf_knn.knn(far[:, :300].contiguous(), far, k=8)
    assert int(idx.max()) < 300


def test_kernels_ties_across_splits(cuda):
    """Copies of a point in three different database splits are at distance 0
    of each other: K1 lists them in index order, K2 returns the first."""
    g = np.random.default_rng(5)
    db = torch.from_numpy(g.uniform(-5, 5, size=(3, 9000)).astype(np.float32)).to(cuda)
    first = torch.arange(50, device=cuda) * 3
    mid, last = 4500 + first, 8999 - first
    db[:, mid] = db[:, first]
    db[:, last] = db[:, first]
    q = db[:, :700].contiguous()
    for k in (1, 8):
        splits = bf_knn.plan(700, 9000, k)[1]
        chunk = -(-9000 // splits)
        ranges = [at // chunk for at in (first, mid, last)]
        assert int(ranges[0].max()) < int(ranges[1].min()) and int(ranges[1].max()) < int(ranges[2].min())
    d2, idx = bf_knn.knn(q, db, k=8)
    nd2, nidx = bf_knn.nearest_neighbor(q, db)
    torch.cuda.synchronize()
    want = torch.stack([first, mid, last]).to(torch.int32)
    assert bool((idx[:3, first] == want).all()) and bool((d2[:3, first] == 0).all())
    assert bool((nidx[first] == want[0]).all()) and bool((nd2[first] == 0).all())
    pd2, pidx = bf_knn.knn_plain(q, db, k=8)
    assert torch.equal(idx[:, first], pidx[:, first])


def test_bf_knn_wrapper_rejects(cuda):
    q = torch.rand(3, 10, device=cuda)
    with pytest.raises(ValueError, match=str(bf_knn.MAX_K)):
        bf_knn.knn(q, q, k=bf_knn.MAX_K + 1)         # above the card's limit
    with pytest.raises(ValueError):
        bf_knn.knn(q, q, k=0)
    d2, idx = bf_knn.knn(q, q, k=7)                   # no instance of its own: runs the next one up
    pd2, pidx = bf_knn.knn_plain(q, q, k=7)
    torch.testing.assert_close(d2, pd2, rtol=1e-5, atol=1e-6)
    assert torch.equal(idx, pidx)
    with pytest.raises(ValueError):
        bf_knn.knn(q.double(), q.double(), k=8)      # dtype
    with pytest.raises(ValueError):
        bf_knn.knn(q.T.contiguous().T, q, k=8)       # not contiguous
    with pytest.raises(ValueError):
        bf_knn.knn(q, q.cpu(), k=8)                  # devices differ


@pytest.mark.parametrize("n,m", [(1, 5), (100, 5000), (300, 700), (1500, 2049), (700, 9001)])
def test_nearest_neighbor_kernel_matches_plain(cuda, n, m):
    """K2 at ragged sizes, split (M >= 2049) and unsplit: d2 at rtol 1e-5 / atol 1e-6 (FMA against separate
    multiply-add), indices equal away from near-ties, launches counted
    separately from K1's."""
    g = np.random.default_rng(n + m)
    q = torch.from_numpy(g.uniform(-5, 5, size=(3, n)).astype(np.float32)).to(cuda)
    db = torch.from_numpy(g.uniform(-5, 5, size=(3, m)).astype(np.float32)).to(cuda)
    before, k1_before = bf_knn.nearest_neighbor.launches, bf_knn.knn.launches
    d2, idx = bf_knn.nearest_neighbor(q, db)
    torch.cuda.synchronize()
    assert bf_knn.nearest_neighbor.launches == before + 1 and bf_knn.knn.launches == k1_before
    assert d2.shape == (n,) and idx.shape == (n,) and idx.dtype == torch.int32
    pd2, pidx = bf_knn.nearest_neighbor_plain(q, db)
    torch.testing.assert_close(d2, pd2, rtol=1e-5, atol=1e-6)
    d2k, _ = bf_knn.knn_plain(q, db, k=2)
    clear = (d2k[1] - d2k[0]) > 1e-6 * d2k[1]
    assert bool((idx == pidx)[clear].all())


def test_nearest_neighbor_kernel_ties_and_masking(cuda):
    """Exact ties keep the lower index (strict < over tiles in index order);
    points moved away by pad_cloud are never chosen."""
    db = torch.tensor([[1.0, -1.0, 0.0, 1.0], [0, 0, 2, 0], [0, 0, 0, 0]], device=cuda)
    d2, idx = bf_knn.nearest_neighbor(torch.zeros(3, 3, device=cuda), db)
    assert idx.tolist() == [0, 0, 0] and d2.tolist() == [1.0, 1.0, 1.0]
    # a duplicate point in a later 1024-point tile loses to the earlier one
    far = torch.full((3, 3000), 50.0, device=cuda)
    far[:, 10] = 1.0
    far[:, 2500] = 1.0
    _, idx = bf_knn.nearest_neighbor(torch.zeros(3, 1, device=cuda), far)
    assert idx.tolist() == [10]
    pts = torch.rand(3, 600, device=cuda)
    mask = torch.arange(600, device=cuda) < 300
    _, idx = bf_knn.nearest_neighbor(pts[:, 300:].contiguous(), bf_knn.pad_cloud(pts, mask, 1))
    assert int(idx.max()) < 300


def test_nearest_neighbor_wrapper_rejects(cuda):
    q = torch.rand(3, 10, device=cuda)
    with pytest.raises(ValueError):
        bf_knn.nearest_neighbor(q.double(), q.double())         # dtype
    with pytest.raises(ValueError):
        bf_knn.nearest_neighbor(q.T.contiguous().T, q)           # not contiguous
    with pytest.raises(ValueError):
        bf_knn.nearest_neighbor(q, q.cpu())                      # devices differ
    with pytest.raises(ValueError):
        bf_knn.nearest_neighbor(torch.rand(4, 10, device=cuda), q)  # not (3, n)


# ---- the SLAM slice on the card against the port on the CPU ----

def _to(tree, dev):
    """A NamedTuple of tensors (nested) on another device."""
    if isinstance(tree, tuple):
        return type(tree)(*(_to(v, dev) for v in tree))
    return tree.to(dev) if torch.is_tensor(tree) else tree


def test_ndt_align_on_card_matches_cpu(cuda):
    """NDT P2D and D2D on the same target (built on the CPU, copied): the card's
    pose within 1e-5 m / 1e-5 of the CPU's (voxel keys by the same float32
    reciprocal on both devices; 3.9e-7 m apart on an H100), the same
    iterations."""
    from pointcloud_slam_tpu_torch import register
    from pointcloud_slam_tpu_torch.io import synthetic

    world = synthetic.make_room_cloud(6000, seed=0)
    R, t = synthetic.random_pose(seed=1, rot_scale=0.04, trans_scale=0.3)
    src = torch.from_numpy(np.ascontiguousarray(((world - t) @ R).astype(np.float32).T))
    cfg = register.NDTConfig(resolution=1.0)
    gc, g = register.ndt.build_target(cfg, torch.from_numpy(np.ascontiguousarray(world.T)), capacity=1 << 14)
    sm, sc, sv, _ = register.ndt.voxelize_source(cfg, src)
    for name, fn in (("p2d", lambda g_, d: register.ndt.align(gc, g_, src.to(d), cfg=cfg)),
                     ("d2d", lambda g_, d: register.ndt.align_d2d(gc, g_, sm.to(d), sc.to(d), sv.to(d), cfg=cfg))):
        rc, rg = fn(g, "cpu"), fn(_to(g, cuda), cuda)
        np.testing.assert_allclose(rg.pose.t.cpu().numpy(), rc.pose.t.numpy(), atol=1e-5, err_msg=name)
        np.testing.assert_allclose(rg.pose.R.cpu().numpy(), rc.pose.R.numpy(), atol=1e-5, err_msg=name)
        assert int(rg.iterations) == int(rc.iterations), name
        assert np.linalg.norm(rg.pose.t.cpu().numpy() - t) < 0.15


def test_backend_optimize_on_card_matches_cpu(cuda):
    """Full and window GN solves of a 48-node graph (odometry with drift, IMU
    factors on 10 slots, a loop, a GPS prior) on the card and on the CPU:
    positions within 1e-3 m, rotations within 1e-3 (index_add_ on the card
    sums with atomics, in no fixed order; cuSOLVER against LAPACK)."""
    from pointcloud_slam_tpu_torch.geom import so3
    from pointcloud_slam_tpu_torch.models.lio import preintegration as pre
    from pointcloud_slam_tpu_torch.models.liosam import backend as bk

    cfg = bk.BackendConfig(max_keyframes=64, max_loops=4, gn_iterations=3, pcg_iterations=24)
    g = bk.create(cfg, device="cpu")
    rng = np.random.default_rng(0)
    M = 20
    acc = torch.from_numpy((rng.normal(0, 0.5, (M, 3)) + [0, 0, 9.81]).astype(np.float32))
    gyro = torch.from_numpy(rng.normal(0, 0.3, (M, 3)).astype(np.float32))
    pim = pre.preintegrate(acc, gyro, torch.full((M,), 0.005), torch.ones(M, dtype=torch.bool),
                           torch.full((3,), 0.01), torch.zeros(3))
    R, tpos = torch.eye(3), torch.zeros(3)
    step = so3.exp(torch.tensor([0.0, 0.0, 2 * np.pi / 48 + 0.004]))
    for k in range(48):
        if k:
            tpos = tpos + R @ torch.tensor([0.5, 0.0, 0.0])
            R = R @ step
        g = bk.add_keyframe(cfg, g, R, tpos, pim=pim if 5 <= k < 15 else None)
    g = bk.add_loop(cfg, g, 47, 0, torch.eye(3), torch.tensor([0.3, -0.2, 0.0]), torch.full((6,), 1e3),
                    robust=False)
    g = bk.add_gps(g, 20, g.t[20] + 0.1, torch.tensor([1e2, 1e2, 1e-6]))
    for name, fn in (("optimize", lambda g_: bk.optimize(cfg, g_)),
                     ("window", lambda g_: bk.optimize_window(cfg, g_, window=16))):
        oc, og = fn(g), fn(_to(g, cuda))
        np.testing.assert_allclose(og.t.cpu().numpy(), oc.t.numpy(), atol=1e-3, err_msg=name)
        np.testing.assert_allclose(og.R.cpu().numpy(), oc.R.numpy(), atol=1e-3, err_msg=name)
        assert bool(torch.isfinite(og.t).all()), name


@pytest.mark.parametrize("stride,span", [(80, 512), (320, 2048)], ids=["as_written", "scaled"])
def test_backend_chain_at_4096_keyframes_on_card(cuda, stride, span):
    """chip_smoke.py phase 14's backend graph on the card: the dry run's
    drifting circle at 4,096 keyframes, 24 loops laid out as the dry run
    writes them (they tie only the first 2,352 nodes) or scaled with the
    node count. Stage by stage: the right-hand side, the diagonal and
    sub-diagonal blocks, every cyclic-reduction level, the dense tail's
    Cholesky factor (positive diagonal) and a chain solve are finite, and
    optimize (3 GN x 24 PCG) lowers the largest position error."""
    from pointcloud_slam_tpu_torch.io import synthetic
    from pointcloud_slam_tpu_torch.models.liosam import backend as bk

    cfg = bk.BackendConfig(max_keyframes=4096, max_loops=64, keyframe_dist_thresh=0.3, gn_iterations=3,
                           pcg_iterations=24)
    g, t_true, t_noisy = synthetic.drifting_circle_graph(cfg, 24, stride, span, device=cuda)
    KF = cfg.max_keyframes
    idx = torch.arange(KF, device=cuda)
    active = idx < g.n
    imu_next = torch.cat([g.imu_mask[1:], torch.zeros(1, dtype=torch.bool, device=cuda)])
    prior_diag, gpsw = bk._priors(cfg, idx == 0, active, active & (g.imu_mask | imu_next),
                                  g.prior_info * g.prior_mask[:, None])
    fi, fj, Ji, Jj, e, info, B = bk._graph_terms(cfg, g)
    b = bk._rhs(KF, fi, fj, Ji, Jj, e, info, g.R, g.t, g.prior_pos, gpsw)
    D = bk._precond_blocks(KF, torch.float32, fi, fj, Ji, Jj, info, prior_diag)
    levels, tail = bk.chain_factor(D, B)
    finite = lambda x: bool(torch.isfinite(x).all())
    assert finite(b) and finite(D) and finite(B)
    assert all(finite(lv[k]) for lv in levels for k in ("A", "C", "Do_inv"))
    chol, d, n_tail = tail
    assert n_tail == 256 and finite(chol) and finite(d) and bool((torch.diagonal(chol) > 0).all())
    assert finite(bk.chain_solve(levels, tail, b))
    out = bk.optimize(cfg, g)
    err0 = np.linalg.norm(t_noisy - t_true, axis=1).max()
    err1 = np.linalg.norm(out.t.cpu().numpy() - t_true, axis=1).max()
    assert np.isfinite(err1) and err1 < err0, (err0, err1)


def test_slam_step_on_card_matches_cpu(cuda):
    """tests/test_slam.py's out-and-back path (11 frames) through slam_step on
    the card and on the CPU: the same keyframe and loop decisions and the
    same host reads on every frame, poses within 1 cm; on the card no frame
    after the first synchronizes more than its counted reads, the `eigh` of
    scan-to-map (one a search round and the final `eigvalsh`) and an NDT
    verification's `eigvalsh`. (The first frame also copies the cached
    stencil tables to the card.)"""
    import warnings

    from pointcloud_slam_tpu_torch import register
    from pointcloud_slam_tpu_torch.io import synthetic
    from pointcloud_slam_tpu_torch.models.liosam import backend as bk
    from pointcloud_slam_tpu_torch.models.liosam import scan2map as s2m
    from pointcloud_slam_tpu_torch.models.liosam import scancontext as sc
    from pointcloud_slam_tpu_torch.models.liosam import slam

    cfg = slam.SLAMConfig(
        backend=bk.BackendConfig(max_keyframes=32, max_loops=4, keyframe_dist_thresh=0.4, gn_iterations=3,
                                 pcg_iterations=30),
        n_corner=256, n_surf=2048,
        scan2map=s2m.Scan2MapConfig(solver=register.SolverConfig(max_iterations=8), degeneracy_eig=1.0),
        loop_icp=register.ICPConfig(solver=register.SolverConfig(max_iterations=6)),
        scancontext=sc.ScanContextConfig(exclude_recent=3, dist_threshold=0.35))
    warm = min(cfg.scan2map.warmup_searches, cfg.scan2map.solver.max_iterations)
    n_eigh = warm + -(-(cfg.scan2map.solver.max_iterations - warm) // cfg.scan2map.search_every) + 1
    corners_w, surfs_w = synthetic.make_feature_world(seed=2)
    states = {d: slam.create_state(cfg, device=d) for d in ("cpu", cuda)}
    loops = 0
    for k, x in enumerate([0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 2.0, 1.5, 1.0, 0.5, 0.02]):
        t = np.array([x, 0.0, 1.0], np.float32)
        c, cm = synthetic.take_scan(corners_w, np.eye(3, dtype=np.float32), t, 256, seed=k)
        s, sm = synthetic.take_scan(surfs_w, np.eye(3, dtype=np.float32), t, 2048, seed=100 + k)
        outs, reads = {}, {}
        for d in states:
            args = [torch.from_numpy(np.ascontiguousarray(a.T) if a.ndim == 2 else a).to(d) for a in (c, cm, s, sm)]
            r0 = slam.slam_step.host_reads
            on_card = torch.device(d).type == "cuda"
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if on_card:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    states[d], outs[d] = slam.slam_step(cfg, states[d], *args)
                finally:
                    if on_card:
                        torch.cuda.set_sync_debug_mode("default")
            reads[d] = slam.slam_step.host_reads - r0
            if on_card and k > 0:
                syncs = sum("synchroniz" in str(w.message) for w in caught)
                assert syncs <= reads[d] + n_eigh + 1, (k, syncs, reads[d], n_eigh)
        oc, og = outs["cpu"], outs[cuda]
        assert reads["cpu"] == reads[cuda], k
        assert bool(og.is_keyframe) == bool(oc.is_keyframe) and int(og.loop_index) == int(oc.loop_index), k
        np.testing.assert_allclose(og.pose.t.cpu().numpy(), oc.pose.t.numpy(), atol=1e-2, err_msg=str(k))
        loops += int(og.loop_detected)
    assert loops >= 1


# ---- prior-map localization on the card against the port on the CPU ----

def _count_syncs(fn):
    """fn() under the CUDA sync debugger: (its result, synchronizing ops
    seen). The first switch to "warn" in a process warns once by itself:
    count a warm-up call first."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def test_localization_on_card_matches_cpu(cuda):
    """localize_loam at bench config 8's shape (feature world, 512 corner and
    2048 surface points, 6 GN iterations) and localize_ndt on the 6,000-point
    room (2,000 points), each on maps built on the CPU and copied: the same
    loss and degeneracy flags; NDT's pose within 1e-3 m / 1e-3 of the CPU's
    and its fitness within 1e-3 relative; LOAM's within 5 mm / 5e-3 and 2 %
    (its plane-fit flags follow the summation order, ROADMAP §3: 1.4 mm
    apart on an H100); a LOAM frame with its relocalize synchronizes exactly
    5 times (scan-to-map's `eigh`s), an NDT frame once (its `eigvalsh`)."""
    from pointcloud_slam_tpu_torch import ops, register
    from pointcloud_slam_tpu_torch.geom import se3
    from pointcloud_slam_tpu_torch.io import synthetic
    from pointcloud_slam_tpu_torch.models.liosam import scan2map as s2m
    from pointcloud_slam_tpu_torch.models.localization import pipeline as loc

    def close(rc, rg, name, atol, fitness_rtol):
        dt = float(np.abs(rg.pose.t.cpu().numpy() - rc.pose.t.numpy()).max())
        dR = float(np.abs(rg.pose.R.cpu().numpy() - rc.pose.R.numpy()).max())
        df = abs(float(rg.fitness) / float(rc.fitness) - 1)
        assert dt <= atol and dR <= atol and df <= fitness_rtol, (name, dt, dR, df)
        assert bool(rg.lost) == bool(rc.lost) and bool(rg.degenerate) == bool(rc.degenerate), name

    cfg = loc.LocalizationConfig(scan2map=s2m.Scan2MapConfig(solver=register.SolverConfig(max_iterations=6),
                                                             degeneracy_eig=1.0))
    corners_w, surfs_w = synthetic.make_feature_world(seed=3)
    maps = []
    for cloud, g in ((corners_w, cfg.scan2map.corner_grid), (surfs_w, cfg.scan2map.surf_grid)):
        pts = torch.from_numpy(np.ascontiguousarray(cloud.T.astype(np.float32)))
        maps.append(ops.insert(g, ops.create(g, device="cpu"), pts, torch.ones(pts.shape[1], dtype=torch.bool)))
    t = np.array([0.4, 0.3, 1.0], np.float32)
    c, cm = synthetic.take_scan(corners_w, np.eye(3, dtype=np.float32), t, 512, seed=1)
    s, sm = synthetic.take_scan(surfs_w, np.eye(3, dtype=np.float32), t, 2048, seed=101)
    args = [torch.from_numpy(np.ascontiguousarray(a.T) if a.ndim == 2 else a) for a in (c, cm, s, sm)]
    init = se3.Pose(torch.eye(3), torch.from_numpy(t + np.array([0.05, -0.04, 0.02], np.float32)))
    rc = loc.localize_loam(cfg, None, *maps, *args, init)
    gmaps, gargs, ginit = [_to(m, cuda) for m in maps], [a.to(cuda) for a in args], _to(init, cuda)
    _count_syncs(lambda: loc.localize_loam(cfg, None, *gmaps, *gargs, ginit))   # warm-up

    def frame():
        r = loc.localize_loam(cfg, None, *gmaps, *gargs, ginit)
        loc.relocalize(r, ginit)
        return r

    rg, syncs = _count_syncs(frame)
    close(rc, rg, "loam", 5e-3, 2e-2)
    assert syncs == 5, syncs

    world = synthetic.make_room_cloud(6000, seed=0)
    R, tt = synthetic.random_pose(seed=1, rot_scale=0.03, trans_scale=0.2)
    scan = torch.from_numpy(np.ascontiguousarray(((world[:2000] - tt) @ R).astype(np.float32).T))
    w = torch.from_numpy(np.ascontiguousarray(world.T))
    ncfg = loc.LocalizationConfig(method="ndt")
    ngc, nmap = register.ndt.build_target(ncfg.ndt, w, baked=True)
    pgc, pmap = register.build_target_map(w, grid_cfg=ops.GridConfig(capacity=1 << 14, pts_per_voxel=8,
                                                                       resolution=1.0, nearby=7))
    mask = torch.ones(scan.shape[1], dtype=torch.bool)
    rc = loc.localize_ndt(ncfg, ngc, nmap, pgc, pmap, scan, mask, se3.identity())
    gargs = (ngc, _to(nmap, cuda), pgc, _to(pmap, cuda), scan.to(cuda), mask.to(cuda), se3.identity(device=cuda))
    _count_syncs(lambda: loc.localize_ndt(ncfg, *gargs))
    rg, syncs = _count_syncs(lambda: loc.localize_ndt(ncfg, *gargs))
    close(rc, rg, "ndt", 1e-3, 1e-3)
    np.testing.assert_allclose(float(rg.max_eigen), float(rc.max_eigen), rtol=1e-3)
    assert syncs == 1, syncs


def test_lio_update_on_card_matches_cpu(cuda):
    """The LIO's iterated update (its 23x23 algebra in float64) on the same
    prior on both devices, one spanning eight decades as P does after a few
    frames (rotation 3e-8 against an accelerometer bias of 1), with
    point-to-plane rows of a room: the card's state within 1e-5 (m, rad,
    m/s^2) of the CPU's, P within 1e-5 relative, and with cached
    correspondences no host read."""
    from pointcloud_slam_tpu_torch.models.lio import eskf, imu, state as st

    rng = np.random.default_rng(0)
    n = 3000
    normals = np.array([[0, 0, 1], [1, 0, 0], [1, 0, 0], [0, 1, 0], [0, 1, 0], [0, 0, 1], [0, 1, 0]], np.float32)
    offsets = np.array([0, -6, 6, -6, 6, -3, 0], np.float32)
    k = rng.integers(0, 7, n)
    pw = rng.uniform(-6, 6, size=(3, n)).astype(np.float32)
    pw[2] = rng.uniform(0, 3, n)
    for i in range(7):
        pw[int(np.argmax(normals[i])), k == i] = -offsets[i]
    var = np.r_[[2e-6] * 3, [3e-8] * 3, [1e-5] * 6, [3e-3] * 3, [2e-5] * 3, [1.0] * 3, [1e-5] * 2]
    x = st.identity(torch.float32, device="cpu")._replace(pos=torch.tensor([0.3, -0.2, 1.5]),
                                                          vel=torch.tensor([0.5, 0.3, 0.0]))
    dt = torch.full((20,), 0.005)
    x, P, _ = imu.propagate(x, torch.diag(torch.tensor(var, dtype=torch.float32)), eskf.process_noise_cov(),
                            torch.from_numpy(rng.normal(size=(20, 3)).astype(np.float32)) + torch.tensor([0, 0, 9.809]),
                            torch.from_numpy(rng.normal(scale=0.3, size=(20, 3)).astype(np.float32)), dt,
                            torch.cumsum(dt, 0), torch.ones(20, dtype=torch.bool), torch.ones(()), torch.zeros(3),
                            torch.zeros(3))

    def update(dev):
        nrm = torch.from_numpy(normals[k].T.copy()).to(dev)
        off = torch.from_numpy(offsets[k]).to(dev)
        pb = torch.from_numpy(pw).to(dev) - torch.tensor([0.3, -0.2, 1.5], device=dev)[:, None]

        def obs(x, do_search, cache):
            p_imu = x.ext_R @ pb + x.ext_t[:, None]
            q = x.rot @ p_imu + x.pos[:, None]
            h = -(nrm[0] * q[0] + nrm[1] * q[1] + nrm[2] * q[2] + off)
            c = x.rot.T @ nrm
            a = torch.stack([p_imu[1] * c[2] - p_imu[2] * c[1], p_imu[2] * c[0] - p_imu[0] * c[2],
                             p_imu[0] * c[1] - p_imu[1] * c[0]])
            z = torch.zeros_like(h)
            return torch.stack([nrm[0], nrm[1], nrm[2], a[0], a[1], a[2], z, z, z, z, z, z], 1), h, h.abs() < 1.0, cache

        xd, Pd = st.NavState(*(v.to(dev) for v in x)), P.to(dev)
        return lambda: eskf.update_iterated(xd, Pd, obs, 0.001, 4, 0.001, research=False)

    uc = update("cpu")()
    upd = update(cuda)
    _count_syncs(upd)                                         # warm-up
    ug, syncs = _count_syncs(upd)
    dx = st.boxminus(st.NavState(*(v.cpu() for v in ug.x)), uc.x)
    assert float(dx.abs().max()) < 1e-5, dx
    scale = torch.sqrt(torch.outer(torch.diagonal(uc.P), torch.diagonal(uc.P)))
    assert float(((ug.P.cpu() - uc.P) / scale).abs().max()) < 1e-5
    assert ug.P.dtype == torch.float32 and ug.host_syncs == 0 and syncs == 0, syncs


def _map_cloud(n, seed, span):
    g = np.random.default_rng(seed)
    pts = g.uniform(-span, span, (3, n)).astype(np.float32)
    pts[2] = g.uniform(-0.5, 2.0, n)
    return pts, g.uniform(size=n) < 0.9


def test_insert_scan_on_card_matches_cpu(cuda):
    """The 2-D occupancy update (insert_cloud: cloud_to_scan + insert_scan)
    at the default 1,024^2 grid and 720 beams, three scans from three poses:
    log-odds within 1e-5 but for edge cells (the card's cos / sin may move a
    beam's last free cell), at most 0.1 % of the observed cells; no host read."""
    from pointcloud_slam_tpu_torch.maps import occupancy as occ

    cfg = occ.OccupancyConfig()
    clouds = [_map_cloud(20_000, 10 + k, 15.0) for k in range(3)]
    inputs = {dev: [(torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev)) for p, m in clouds]
              for dev in ("cpu", cuda)}

    def build(dev):
        grid = occ.create(cfg, device=dev)
        for k, (pts, mask) in enumerate(inputs[dev]):
            xy = np.array([0.4 * k - 0.3, 0.25 * k + 0.1], np.float32)
            grid = occ.insert_cloud(cfg, grid, pts, mask, xy, 0.3)
        return grid.logodds

    lc = build("cpu").numpy()
    _count_syncs(lambda: build(cuda))                         # warm-up
    lg, syncs = _count_syncs(lambda: build(cuda))
    lg = lg.cpu().numpy()
    edge = np.abs(lg - lc) > 1e-5
    observed = (lc != 0) | (lg != 0)
    assert observed.sum() > 1000 and edge.sum() <= 1e-3 * observed.sum(), (int(edge.sum()), int(observed.sum()))
    assert syncs == 0, syncs


@pytest.mark.parametrize("capacity, n_points", [(1 << 20, 40), (1 << 20, 1500), (1 << 8, 400)])
def test_insert_cloud_3d_on_card_matches_cpu(cuda, capacity, n_points):
    """The 3-D hash occupancy on the card and on the CPU: the same winner
    for every slot (the last valid writer of a batch), so the same maps slot
    for slot and by voxel, from a collision-free map to a 256-slot one that
    every batch fights over; every slot's fingerprint is its own
    coordinates'; the collision counts equal; no host read."""
    from pointcloud_slam_tpu_torch.maps import tiled
    from pointcloud_slam_tpu_torch.ops.voxel_grid import _fingerprint

    cfg = tiled.VoxelOccConfig(capacity=capacity, n_free_steps=16)
    clouds = [_map_cloud(n_points, 20 + k, 6.0) for k in range(3)]
    inputs = {dev: [(torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev)) for p, m in clouds]
              for dev in ("cpu", cuda)}

    def build(dev):
        m = tiled.create_3d(cfg, device=dev)
        col = torch.zeros((), dtype=torch.int64, device=dev)
        for k, (pts, mask) in enumerate(inputs[dev]):
            m = tiled.insert_cloud_3d(cfg, m, pts, mask, (0.3 * k, -0.2, 0.9), col)
        return m, col

    mc, cc = build("cpu")
    _count_syncs(lambda: build(cuda))                         # warm-up
    (mg, cg), syncs = _count_syncs(lambda: build(cuda))
    assert syncs == 0, syncs
    assert int(cg) == int(cc) and (int(cc) == 0) == (capacity == 1 << 20 and n_points == 40), int(cc)
    assert torch.equal(mg.fp.cpu(), mc.fp) and torch.equal(mg.keys.cpu(), mc.keys)
    torch.testing.assert_close(mg.logodds.cpu(), mc.logodds, rtol=0, atol=1e-5)
    filled = mg.fp != 0
    assert bool((_fingerprint(mg.keys[0], mg.keys[1], mg.keys[2])[filled] == mg.fp[filled]).all())


def test_timer_adds_no_sync(cuda):
    """Timer.evaluate on the card records CUDA events and waits for nothing;
    mean resolves them after one synchronize."""
    from pointcloud_slam_tpu_torch.utils.timer import Timer

    a = torch.randn(2048, 2048, device=cuda)
    Timer.reset()
    _count_syncs(lambda: Timer.evaluate(lambda: a @ a, "warm"))   # warm-up
    _, syncs = _count_syncs(lambda: [Timer.evaluate(lambda: a @ a, "matmul") for _ in range(5)])
    assert syncs == 0, syncs
    assert Timer.mean("matmul") > 0
    Timer.reset()


@pytest.mark.parametrize("n", [20_000, 1 << 18])
def test_voxel_downsample_on_card_matches_cpu(cuda, n):
    """The centroid voxel filter at a LIO frame's and at the maps app's chunk
    size: the same voxels in the same order, and centroids equal to the bit
    (voxel keys by the float32 reciprocal of the leaf on both devices; sums
    in sorted order on both); no host read."""
    from pointcloud_slam_tpu_torch import ops

    g = np.random.default_rng(n)
    pts = g.uniform(-15, 15, (3, n)).astype(np.float32)
    pts[:, : n // 4] = np.round(pts[:, : n // 4] / 0.2) * 0.2        # a quarter on voxel bounds
    mask = g.uniform(size=n) < 0.9
    outs = {}
    for dev in ("cpu", cuda):
        p, m = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
        _count_syncs(lambda: ops.voxel_downsample(p, m, 0.2))          # warm-up
        (out, om), syncs = _count_syncs(lambda: ops.voxel_downsample(p, m, 0.2))
        outs[dev] = (out.cpu(), om.cpu(), syncs)
    (oc, mc, _), (og, mg, syncs) = outs["cpu"], outs[cuda]
    assert torch.equal(mg, mc) and int(mc.sum()) > 1000
    assert torch.equal(og[:, mg], oc[:, mc])
    assert syncs == 0, syncs


def _bound_points(res, n_extra=0, seed=0):
    """Points on voxel bounds k * res and one float32 ulp either side (the
    neighbours of 0 at +-1e-6 m), the rows permuted; plus n_extra uniform ones."""
    ks = np.arange(-60, 61)
    b = (ks * np.float32(res)).astype(np.float32)
    up, dn = np.nextafter(b, np.float32(np.inf)), np.nextafter(b, np.float32(-np.inf))
    up[ks == 0], dn[ks == 0] = 1e-6, -1e-6
    x = np.concatenate([b, up, dn]).astype(np.float32)
    pts = np.stack([x, x[::-1], np.roll(x, 7)])
    extra = np.random.default_rng(seed).uniform(-12, 12, (3, n_extra)).astype(np.float32)
    return np.ascontiguousarray(np.concatenate([pts, extra], axis=1))


@pytest.mark.parametrize("res", [0.2, 0.3, 0.4, 0.5, 1.0, 2.0])
def test_voxel_keys_on_card_match_cpu(cuda, res):
    """Voxel keys of bound points equal on the card and on the CPU: standalone,
    the voxels `insert` files them under (one winner a slot can differ, the
    set of voxels cannot), and the voxel `knn` looks each one up in (a
    one-voxel stencil over a map of voxel centres, built on both devices)."""
    from pointcloud_slam_tpu_torch import ops

    pts = torch.from_numpy(_bound_points(res, 2000, seed=int(res * 10)))
    n = pts.shape[1]
    assert torch.equal(ops.point_to_voxel(pts.to(cuda), res).cpu(), ops.point_to_voxel(pts, res))
    cfg = ops.GridConfig(capacity=1 << 14, pts_per_voxel=4, resolution=res, nearby=1, claim_rounds=4)
    keys = {}
    for dev in ("cpu", cuda):
        g = ops.insert(cfg, ops.create(cfg, device=dev), pts.to(dev), torch.ones(n, dtype=torch.bool, device=dev))
        keys[str(dev)] = {tuple(c) for c in g.keys[:, g.occupied].cpu().numpy().T}
    assert keys["cpu"] == keys[str(cuda)]
    cells = np.unique(np.floor(pts.numpy() * (np.float32(1) / np.float32(res))).astype(np.int64), axis=1)
    centres = torch.from_numpy(((cells + 0.5) * res).astype(np.float32))
    mcfg = ops.GridConfig(capacity=1 << 15, pts_per_voxel=2, resolution=res, nearby=1, claim_rounds=4)
    found = {}
    for dev in ("cpu", cuda):
        m = ops.insert(mcfg, ops.create(mcfg, device=dev), centres.to(dev),
                       torch.ones(centres.shape[1], dtype=torch.bool, device=dev))
        nb, _, cnt, _ = ops.knn(mcfg, m, pts.to(dev), k=1, max_range=10.0 * res)
        found[str(dev)] = (nb.cpu(), cnt.cpu())
    assert bool((found["cpu"][1] == 1).all())
    assert torch.equal(found["cpu"][0], found[str(cuda)][0]) and torch.equal(found["cpu"][1], found[str(cuda)][1])


def test_gaussian_and_ndt_keys_on_card_match_cpu(cuda):
    """The Gaussian voxel map of bound points (the NDT / VGICP target) and the
    NDT source voxelization: the same voxels with the same point counts on
    the card and on the CPU."""
    from pointcloud_slam_tpu_torch import ops, register
    from pointcloud_slam_tpu_torch.io import synthetic
    from pointcloud_slam_tpu_torch.ops import gaussian_grid as gg

    pts = torch.from_numpy(_bound_points(0.3, 20000, seed=3))
    # NDT's source voxels need >= 6 points: a 20,000-point room and bound points at 1 m
    room = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [synthetic.make_room_cloud(20000, seed=0).T, _bound_points(1.0)], axis=1).astype(np.float32)))
    # room for every voxel: a claim that finds no slot drops its points, and
    # which of two racing voxels wins differs between the devices (ROADMAP §3)
    cfg = ops.GridConfig(capacity=1 << 18, resolution=0.3, nearby=7)
    by_voxel, ndt = {}, {}
    for dev in ("cpu", cuda):
        g = gg.accumulate(cfg, gg.create(cfg, device=dev), pts.to(dev),
                          torch.ones(pts.shape[1], dtype=torch.bool, device=dev))
        occ = g.occupied.cpu()
        by_voxel[str(dev)] = dict(zip(map(tuple, g.keys[:, occ].cpu().numpy().T), g.count[occ].cpu().numpy()))
        mean, _, valid, count = register.ndt.voxelize_source(register.NDTConfig(resolution=1.0), room.to(dev),
                                                             capacity=1 << 18)
        ndt[str(dev)] = (mean[:, valid].cpu().numpy().T, count[valid].cpu().numpy())
    assert by_voxel["cpu"] == by_voxel[str(cuda)] and len(by_voxel["cpu"]) > 1000
    (mc, cc), (mg, cg) = ndt["cpu"], ndt[str(cuda)]
    assert len(mc) == len(mg) > 100
    # pair each card voxel with the CPU voxel of the nearest mean: the same
    # voxel (1e-5 m: the sums' order differs) with the same point count
    d = np.linalg.norm(mg[:, None, :] - mc[None, :, :], axis=2)
    near = np.argmin(d, axis=1)
    assert d[np.arange(len(mg)), near].max() < 1e-5 and np.array_equal(cg, cc[near])
    assert len(np.unique(near)) == len(mg)


def test_phc_merge_on_card_matches_cpu(cuda):
    """PHC keys, merge masks and centroids (both output modes) and the curve
    sort: the card's equal to the CPU's bit for bit, bound points included."""
    from pointcloud_slam_tpu_torch.ops import phc

    pts = torch.from_numpy(_bound_points(0.4, 20000, seed=4))
    mask = torch.from_numpy(np.random.default_rng(4).random(pts.shape[1]) < 0.9)
    pg, mg = pts.to(cuda), mask.to(cuda)
    for a, b in zip(phc._phc_key(pg, mg, 0.4, 2), phc._phc_key(pts, mask, 0.4, 2)):
        assert torch.equal(a.cpu(), b)
    for curve in (False, True):
        (og, omg), (oc, omc) = phc.phc_merge(pg, mg, 0.4, 2, curve_output=curve), phc.phc_merge(pts, mask, 0.4, 2,
                                                                                              curve_output=curve)
        assert torch.equal(omg.cpu(), omc) and torch.equal(og.cpu()[:, omc], oc[:, omc]), curve
    for a, b in zip(phc.phc_sort(pg, mg, 0.4, 2), phc.phc_sort(pts, mask, 0.4, 2)):
        assert torch.equal(a.cpu(), b)


def _four_calls(inp, dev, mesh=None):
    """tests/test_torch_parallel.py's ICP, LIO update, scan-to-map and
    1,024-keyframe backend on `dev`: sharded over `mesh` (inputs broadcast
    from rank 0), or the single-device functions without one. Host outputs."""
    import test_torch_parallel as tp

    from pointcloud_slam_tpu_torch import convert, parallel, register
    from pointcloud_slam_tpu_torch.geom import se3
    from pointcloud_slam_tpu_torch.models import lio
    from pointcloud_slam_tpu_torch.models.liosam import backend as bk
    from pointcloud_slam_tpu_torch.models.liosam import scan2map as s2m
    from pointcloud_slam_tpu_torch.parallel import mesh as pmesh

    rep = pmesh.replicate if mesh is not None else (lambda tree: tree)
    maps = {k: rep(convert.grid_from_numpy(v, dev)) for k, v in inp["maps"].items()}
    src = rep(torch.from_numpy(inp["icp"]["src"]).to(dev))
    B = src.shape[0]
    icp_cfg = register.ICPConfig()
    lcfg = tp._lio_cfg()
    s0 = lio.create_state(lcfg, device=dev)
    x0, P0 = rep((s0.x, s0.P))
    pts = rep(torch.from_numpy(inp["lio"]["pts"]).to(dev))
    ones = torch.ones(pts.shape[1], dtype=torch.bool, device=dev)
    s2 = {k: rep(torch.from_numpy(np.asarray(v)).to(dev)) for k, v in inp["s2m"].items()}
    init = se3.Pose(torch.eye(3, device=dev), s2["t"])
    cfg_big, g_big, _, _ = tp._big_graph(dev)
    g_big = rep(g_big)
    if mesh is None:
        pose, conv, iters = register.batched_point_to_plane_icp(tp.GRID, maps["icp"], src, cfg=icp_cfg)
        obs = tp.lp._obs_model(lcfg, maps["lio"], pts, torch.sqrt(torch.sum(pts * pts, dim=0)), ones)
        u = tp.eskf.update_iterated(x0, P0, obs, lcfg.laser_point_cov, lcfg.max_iterations, lcfg.epsi)
        x, P, l_iters = u.x, u.P, u.iterations
        res = s2m.scan_to_map(s2m.Scan2MapConfig(), maps["corner"], maps["surf"], s2["c"], s2["cm"], s2["s"],
                              s2["sm"], init)
        g = bk.optimize(cfg_big, g_big)
    else:
        pose, conv, iters = parallel.sharded_point_to_plane_icp(
            mesh, tp.GRID, maps["icp"], src, torch.ones((B, src.shape[2]), dtype=torch.bool, device=dev),
            se3.identity(batch=(B,), device=dev), cfg=icp_cfg)
        x, P, l_iters, _ = parallel.sharded_lio_update(mesh, lcfg, maps["lio"], x0, P0, pts, ones)
        res = parallel.sharded_scan_to_map(mesh, s2m.Scan2MapConfig(), maps["corner"], maps["surf"], s2["c"],
                                           s2["cm"], s2["s"], s2["sm"], init)
        g = parallel.sharded_optimize(mesh, cfg_big, g_big)
    out = dict(icp=(pose.R, pose.t, conv, iters), lio=(x.pos, x.rot, P, l_iters),
               s2m=(res.pose.R, res.pose.t, res.num_corner, res.num_surf, res.degenerate), backend=(g.R, g.t))
    return {k: tuple(t.cpu() for t in v) for k, v in out.items()}


def _two_ranks_on_card(inp):
    from pointcloud_slam_tpu_torch import parallel

    mesh = parallel.make_mesh(device_type="cuda")
    return tuple(mesh.shape), _four_calls(inp, torch.device("cuda", torch.cuda.current_device()), mesh)


def test_sharded_paths_on_two_ranks_sharing_the_card(cuda):
    """Two ranks share the card over gloo (mesh (1, 2)) and run the four
    sharded functions of tests/test_torch_parallel.py on its inputs: both
    ranks bit for bit equal, each result within tests/test_parallel.py's
    tolerances of the single-device function on the card (1e-2 ICP, 1e-5
    LIO, 1e-4 scan-to-map, 5e-4 backend), iterations, counts and flags
    equal."""
    import test_torch_parallel as tp

    from pointcloud_slam_tpu_torch import parallel

    icp, lio_in, s2 = tp._icp_inputs(), tp._lio_inputs(), tp._s2m_inputs()
    s2cfg = tp.s2m.Scan2MapConfig()
    inp = dict(icp=icp, lio=lio_in, s2m=s2, maps={
        "icp": tp._port_map(icp["world"], tp.GRID), "lio": tp._port_map(lio_in["world"], tp.GRID),
        "corner": tp._port_map(s2["cmap_pts"], s2cfg.corner_grid, s2["cmap_mask"]),
        "surf": tp._port_map(s2["smap_pts"], s2cfg.surf_grid, s2["smap_mask"])})
    ranks = parallel.launch(_two_ranks_on_card, 2, device="cuda", backend="gloo", args=(inp,), timeout=300)
    single = _four_calls(inp, cuda)
    assert all(shape == (1, 2) for shape, _ in ranks)
    tol = dict(icp=1e-2, lio=1e-5, s2m=1e-4, backend=5e-4)
    for name, ref in single.items():
        for a, b in zip(ranks[0][1][name], ranks[1][1][name]):
            assert torch.equal(a, b), name
        for a, b in zip(ranks[0][1][name], ref):
            if a.is_floating_point():
                torch.testing.assert_close(a, b, rtol=0, atol=tol[name], msg=name)
            else:
                assert torch.equal(a, b), name
