"""Parity of the port's LIO-SAM modules (`pointcloud_slam_tpu_torch.models.
liosam`: projection, features, ScanContext, the pose-graph backend) and of
IMU preintegration (`models.lio.preintegration`) with the JAX package, on
the same numpy inputs. Tolerances are stated at each assertion. Scan-to-map
is in tests/test_torch_scan2map.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu.geom import so3 as jso3
from pointcloud_slam_tpu.models.lio import preintegration as jpre
from pointcloud_slam_tpu.models.liosam import backend as jbk
from pointcloud_slam_tpu.models.liosam import features as jfeat
from pointcloud_slam_tpu.models.liosam import projection as jproj
from pointcloud_slam_tpu.models.liosam import scancontext as jsc
from pointcloud_slam_tpu_torch import convert
from pointcloud_slam_tpu_torch.io import synthetic as tsyn
from pointcloud_slam_tpu_torch.models.lio import preintegration as tpre
from pointcloud_slam_tpu_torch.models.liosam import backend as tbk
from pointcloud_slam_tpu_torch.models.liosam import features as tfeat
from pointcloud_slam_tpu_torch.models.liosam import projection as tproj
from pointcloud_slam_tpu_torch.models.liosam import scancontext as tsc

torch.set_num_threads(2)

# JAX's residual_stats is not jitted; op by op its vmapped jacfwd costs ~15 s
_jax_stats = jax.jit(jbk.residual_stats, static_argnums=0)


def _np(tree):
    """A NamedTuple (nested) of arrays/tensors as numpy leaves."""
    if isinstance(tree, tuple):
        return type(tree)(*(_np(v) for v in tree))
    return tree.detach().numpy() if torch.is_tensor(tree) else np.asarray(tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ring_scan(n_scan=16, horizon=360, seed=0):
    """tests/test_liosam.py::make_ring_scan: a spinning-lidar scan of a 10 m
    square room, rows = elevation rings; (3, N)."""
    rng = np.random.default_rng(seed)
    elev = np.radians(-15.0 + 30.0 * np.arange(n_scan) / (n_scan - 1))[:, None]
    az = -np.pi + 2 * np.pi * (np.arange(horizon) + 0.5) / horizon
    d = np.stack(np.broadcast_arrays(np.cos(elev) * np.cos(az), np.cos(elev) * np.sin(az), np.sin(elev)), -1)
    d = d.reshape(-1, 3)
    t = np.minimum(5.0 / np.maximum(np.abs(d[:, 0]), 1e-6), 5.0 / np.maximum(np.abs(d[:, 1]), 1e-6))
    p = d * t[:, None]
    p = p[np.abs(p[:, 2]) < 2.5]
    return np.ascontiguousarray((p + rng.normal(scale=0.003, size=p.shape)).astype(np.float32).T)


def test_project_and_extract_match_jax():
    """Range image and LOAM features: validity, edge and surface masks equal;
    coordinates exact where valid (the same scatter-min winner), ranges at
    rtol 1e-6 (sqrt of a 3-term sum: an ulp apart on ~9 % of cells),
    curvature within 1e-4 m^2 (the square of an 11-term sum of ~5 m ranges
    that cancels to ~1e-2 m, summed in another order)."""
    pts = _ring_scan()
    mask = np.arange(pts.shape[1]) >= 300          # the first 300 points masked out
    pcfg_j, pcfg_t = jproj.ProjectionConfig(n_scan=16, horizon=360), tproj.ProjectionConfig(n_scan=16, horizon=360)
    ij = jproj.project(pcfg_j, jnp.asarray(pts), jnp.asarray(mask))
    it = tproj.project(pcfg_t, _t(pts), _t(mask))
    v = np.asarray(ij.valid)
    np.testing.assert_array_equal(it.valid.numpy(), v)
    assert v.mean() > 0.5
    np.testing.assert_allclose(it.rng.numpy()[v], np.asarray(ij.rng)[v], rtol=1e-6)
    for f in ("x", "y", "z"):
        np.testing.assert_array_equal(getattr(it, f).numpy()[v], np.asarray(getattr(ij, f))[v])
    np.testing.assert_array_equal(it.col.numpy(), np.asarray(ij.col))
    np.testing.assert_array_equal(it.row.numpy(), np.asarray(ij.row))
    fj = jfeat.extract(jfeat.FeatureConfig(), ij)
    ft = tfeat.extract(tfeat.FeatureConfig(), it)
    np.testing.assert_array_equal(ft.edge_mask.numpy(), np.asarray(fj.edge_mask))
    np.testing.assert_array_equal(ft.surf_mask.numpy(), np.asarray(fj.surf_mask))
    assert 0 < int(ft.edge_mask.sum()) < int(ft.surf_mask.sum())
    np.testing.assert_allclose(ft.curvature.numpy(), np.asarray(fj.curvature), rtol=1e-5, atol=1e-4)
    cj, mj = jfeat.gather_features(ij, fj.surf_mask)
    ct, mt = tfeat.gather_features(it, ft.surf_mask)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(ct.numpy()[:, mt.numpy()], np.asarray(cj)[:, np.asarray(mj)])


def test_features_keep_lowest_column_among_equal_curvatures():
    """Pins the tie order of the per-sector selection: with more equal
    curvatures above the threshold than `max_edge_per_sector`, the lowest
    columns win, as JAX's top_k picks them."""
    S, H = 2, 120
    rng = np.full((S, H), 5.0, np.float32)
    rng[:, 2::4] = 9.0          # equal spikes: every spike has the same curvature
    img_t = tproj.RangeImage(_t(rng), *(torch.zeros(S, H) for _ in range(3)), torch.ones(S, H, dtype=torch.bool),
                             torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
    img_j = jproj.RangeImage(jnp.asarray(rng), *(jnp.zeros((S, H)) for _ in range(3)), jnp.ones((S, H), bool),
                             jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32))
    cfg_t = tfeat.FeatureConfig(max_edge_per_sector=2, parallel_frac=10.0, occlusion_jump=100.0)
    cfg_j = jfeat.FeatureConfig(max_edge_per_sector=2, parallel_frac=10.0, occlusion_jump=100.0)
    et = tfeat.extract(cfg_t, img_t).edge_mask.numpy()
    np.testing.assert_array_equal(et, np.asarray(jfeat.extract(cfg_j, img_j).edge_mask))
    assert et.sum() > 0


def _room_desc_store(cfg_j, cfg_t, dup=0):
    """A keyframe descriptor store of 12 rooms (slot 3 = the query room
    rotated by 0.8 rad), from both packages. With `dup`, slots 4..4+dup hold
    the same rotated room again (equal keys and distances)."""
    q = tsyn.make_room_cloud(3000, seed=0)
    Rz = np.asarray(jso3.exp(jnp.asarray([0, 0, 0.8], jnp.float32)))
    clouds = [tsyn.make_room_cloud(3000, seed=5 + i) + np.array([30.0 * (i + 1), 0, 0], np.float32) for i in range(12)]
    clouds[3] = q @ Rz
    for i in range(4, 4 + dup):
        clouds[i] = clouds[3]
    pts = np.stack([np.ascontiguousarray(c.T) for c in clouds]).astype(np.float32)
    m = np.ones(pts.shape[::2], bool)
    m[:, ::13] = False
    dj, kj = jax.vmap(lambda p, mm: jsc.make_descriptor(cfg_j, p, mm))(jnp.asarray(pts), jnp.asarray(m))
    dt, kt = tsc.make_descriptor(cfg_t, _t(pts), _t(m))
    qj = jsc.make_descriptor(cfg_j, jnp.asarray(np.ascontiguousarray(q.T)), jnp.ones(3000, bool))
    qt = tsc.make_descriptor(cfg_t, _t(np.ascontiguousarray(q.T)), torch.ones(3000, dtype=torch.bool))
    return (dj, kj, qj), (dt, kt, qt)


@pytest.mark.parametrize("dup", [0, 4])
def test_scancontext_matches_jax(dup):
    """Batched descriptors (a 13th of the points masked) equal JAX's vmapped
    ones to 1e-6; detect finds the rotated revisit with the same index,
    distance (1e-5) and yaw. With four duplicates of the revisit the key
    distances and shift distances tie: the lowest index wins, as JAX's top_k
    and argmin pick."""
    cfg_j, cfg_t = jsc.ScanContextConfig(exclude_recent=2), tsc.ScanContextConfig(exclude_recent=2)
    (dj, kj, qj), (dt, kt, qt) = _room_desc_store(cfg_j, cfg_t, dup)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-6)
    np.testing.assert_allclose(qt[0].numpy(), np.asarray(qj[0]), atol=1e-6)
    rj = jsc.detect(cfg_j, qj[0], qj[1], dj, kj, jnp.asarray(12))
    rt = tsc.detect(cfg_t, qt[0], qt[1], dt, kt, torch.tensor(12))
    assert bool(rt.found) and bool(rj.found)
    assert int(rt.index) == int(rj.index) == 3
    np.testing.assert_allclose(float(rt.distance), float(rj.distance), atol=1e-5)
    assert float(rt.yaw) == float(rj.yaw)
    none_t = tsc.detect(cfg_t, qt[0], qt[1], dt[:0].new_zeros((16, 20, 60)), kt.new_zeros((16, 20)), torch.tensor(8))
    assert not bool(none_t.found) and int(none_t.index) == -1


def _imu(rng, M=30):
    acc = (rng.normal(0, 0.5, (M, 3)) + [0, 0, 9.81]).astype(np.float32)
    gyro = rng.normal(0, 0.3, (M, 3)).astype(np.float32)
    dt = np.full(M, 0.005, np.float32)
    mask = rng.uniform(size=M) < 0.85
    return acc, gyro, dt, mask


def test_preintegrate_and_residual_match_jax():
    """Preintegrated deltas and bias Jacobians over 30 samples (15 % masked)
    at atol 1e-5; the 9-dim residual, batched over 6 factors in the port and
    vmapped in JAX, at atol 1e-4 (inputs O(1), residual O(1e-1))."""
    rng = np.random.default_rng(3)
    acc, gyro, dt, mask = _imu(rng)
    bg0 = np.array([0.01, -0.02, 0.005], np.float32)
    ba0 = np.array([0.05, 0.0, -0.03], np.float32)
    pj = jpre.preintegrate(*(jnp.asarray(a) for a in (acc, gyro, dt, mask, bg0, ba0)))
    pt = tpre.preintegrate(*(_t(a) for a in (acc, gyro, dt, mask, bg0, ba0)))
    for f in pj._fields:
        np.testing.assert_allclose(getattr(pt, f).numpy(), np.asarray(getattr(pj, f)), atol=1e-5, err_msg=f)
    F = 6
    pim_b = jax.tree.map(lambda a: np.broadcast_to(np.asarray(a), (F,) + a.shape).copy(), pj)
    R = np.stack([np.asarray(jso3.exp(jnp.asarray(rng.normal(0, 0.2, 3), jnp.float32))) for _ in range(2 * F)])
    vec = rng.normal(0, 0.3, (7, F, 3)).astype(np.float32)
    grav = np.array([0, 0, -9.81], np.float32)
    args = (R[:F], vec[0], vec[1], R[F:], vec[2], vec[3], vec[4], vec[5])
    ej = jax.vmap(jpre.residual, in_axes=(0,) * 9 + (None,))(jax.tree.map(jnp.asarray, pim_b),
                                                            *(jnp.asarray(a) for a in args), jnp.asarray(grav))
    et = tpre.residual(tpre.PreintegratedImu(*(_t(a) for a in pim_b)), *(_t(a) for a in args), _t(grav))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-4)
    assert bool(tpre.failure_detection(_t(vec[0, 0] * 100), _t(bg0), _t(ba0)))
    assert bool(tpre.failure_detection(_t(vec[0, 0]), _t(bg0), _t(ba0))) == bool(
        jpre.failure_detection(jnp.asarray(vec[0, 0]), jnp.asarray(bg0), jnp.asarray(ba0)))


def _graph_jax(cfg, n=24, drift=0.004, imu_slots=(), gps=None, loops=()):
    """A JAX pose graph: odometry around a circle with yaw drift, IMU factors
    on `imu_slots` (the same preintegrated samples, biased, so their
    residuals are not zero), GPS priors and loop factors (i, j, robust) with
    the true relative pose."""
    rng = np.random.default_rng(1)
    gt_R, gt_t = [np.eye(3, dtype=np.float32)], [np.zeros(3, np.float32)]
    step = np.asarray(jso3.exp(jnp.asarray([0, 0, 2 * np.pi / n], jnp.float32)))
    noise = np.asarray(jso3.exp(jnp.asarray([0, 0, drift], jnp.float32)))
    for k in range(1, n):
        gt_R.append((gt_R[-1] @ step).astype(np.float32))
        gt_t.append((gt_t[-1] + gt_R[-2] @ np.array([0.5, 0, 0], np.float32)).astype(np.float32))
    acc, gyro, dt, mask = _imu(rng, M=20)
    pim = jpre.preintegrate(*(jnp.asarray(a) for a in (acc, gyro, dt, mask)), jnp.full(3, 0.01), jnp.zeros(3))
    g = jbk.create(cfg)
    est_R, est_t = gt_R[0], gt_t[0]
    for k in range(n):
        if k:
            relR = gt_R[k - 1].T @ gt_R[k]
            est_t = est_t + est_R @ (gt_R[k - 1].T @ (gt_t[k] - gt_t[k - 1]))
            est_R = (est_R @ relR @ noise).astype(np.float32)
        g = jbk.add_keyframe(cfg, g, jnp.asarray(est_R), jnp.asarray(est_t.astype(np.float32)),
                             vel_new=jnp.asarray(rng.normal(0, 0.1, 3), jnp.float32),
                             pim=pim if k in imu_slots else None)
    if gps is not None:
        for k in gps:
            g = jbk.add_gps(g, jnp.asarray(k), jnp.asarray(gt_t[k] + 0.05), jnp.asarray([1e2, 1e2, 1e-6], jnp.float32))
    for (i, j, robust) in loops:
        relR = gt_R[i].T @ gt_R[j]
        relt = gt_R[i].T @ (gt_t[j] - gt_t[i])
        g = jbk.add_loop(cfg, g, jnp.asarray(i), jnp.asarray(j), jnp.asarray(relR), jnp.asarray(relt),
                         jnp.full(6, 1e3 if not robust else 2.0, jnp.float32), robust=robust)
    return g


@pytest.fixture(scope="module")
def graph_pair():
    """(cfg_j, cfg_t, JAX graph, the port's graph) with IMU factors on slots
    1..9, GPS on two nodes, a plain loop and a robust one."""
    kw = dict(max_keyframes=32, max_loops=4, gn_iterations=3, pcg_iterations=30)
    cfg_j, cfg_t = jbk.BackendConfig(**kw), tbk.BackendConfig(**kw)
    gj = _graph_jax(cfg_j, imu_slots=range(1, 10), gps=(5, 12), loops=((23, 0, False), (20, 2, True)))
    return cfg_j, cfg_t, gj, convert.pose_graph_from_numpy(_np(gj), "cpu")


def test_graph_terms_match_jax(graph_pair):
    """Every factor family's rows, the IMU ones included (forward-mode
    autodiff on both sides): indices equal, Jacobians at atol 1e-4 of their
    O(1-10) entries, residuals at 1e-5, information and the chain's
    sub-diagonal blocks at rtol 1e-4 (products of 1e6 information with
    O(1) Jacobians, summed in another order)."""
    cfg_j, cfg_t, gj, gt = graph_pair
    outj = jax.jit(jbk._graph_terms, static_argnums=0)(cfg_j, gj)
    outt = tbk._graph_terms(cfg_t, gt)
    names = ("fi", "fj", "Ji", "Jj", "e", "info", "B")
    for name, a, b in zip(names, outt, outj):
        a, b = a.numpy(), np.asarray(b)
        if name in ("fi", "fj"):
            np.testing.assert_array_equal(a, b)
        elif name in ("info", "B"):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=1e-4 if name[0] == "J" else 1e-5, err_msg=name)
    KF = cfg_t.max_keyframes
    imu_rows = slice(KF + cfg_t.max_loops, 2 * KF + cfg_t.max_loops)
    Ji9 = outt[2][imu_rows].numpy()[1:10]
    assert np.abs(Ji9).max() > 1.0 and np.isfinite(Ji9).all()      # the 9x15 IMU blocks are live


def _chain(n, B=15, seed=0):
    rng = np.random.default_rng(seed)
    L = rng.normal(0, 0.3, (n, B, B))
    L[0] = 0.0
    D = np.stack([(lambda A: A @ A.T + 4.0 * np.eye(B))(rng.normal(0, 1.0, (B, B))) for _ in range(n)])
    return D.astype(np.float32), L.astype(np.float32)


@pytest.mark.parametrize("n,direct_n", [(1, 256), (13, 256), (40, 4), (37, 3)])
def test_chain_solve_matches_dense_and_jax(n, direct_n):
    """Cyclic reduction (levels down to `direct_n`, then the dense Cholesky
    tail) against a float64 dense solve (1e-4 of the solution's scale: f32
    with Jacobi-scaled blocks), and at n = 37 against JAX's chain_solve
    (1e-4)."""
    D, L = _chain(n, seed=n)
    B = D.shape[-1]
    M = np.zeros((n * B, n * B))
    for i in range(n):
        M[i * B:(i + 1) * B, i * B:(i + 1) * B] = D[i]
        if i:
            M[i * B:(i + 1) * B, (i - 1) * B:i * B] = L[i]
            M[(i - 1) * B:i * B, i * B:(i + 1) * B] = L[i].T
    r = np.random.default_rng(100 + n).normal(0, 1, (n, B)).astype(np.float32)
    x_ref = np.linalg.solve(M, r.reshape(-1).astype(np.float64)).reshape(n, B)
    levels, tail = tbk.chain_factor(_t(D), _t(L), direct_n=direct_n)
    x = tbk.chain_solve(levels, tail, _t(r)).numpy()
    assert len(levels) == {1: 0, 13: 0, 40: 4, 37: 4}[n]
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=1e-4 * np.abs(x_ref).max())
    if n == 37:   # JAX's own solve (Newton-Schulz block inverses), compiled once
        xj = jax.jit(lambda D, L, r: jbk.chain_solve(*jbk.chain_factor(D, L, direct_n=3), r))(
            jnp.asarray(D), jnp.asarray(L), jnp.asarray(r))
        np.testing.assert_allclose(x, np.asarray(xj), rtol=0, atol=1e-4 * np.abs(x_ref).max())


def test_optimize_on_a_partly_tied_4096_keyframe_circle():
    """The dry run's drifting circle (__graft_entry__.py:116-133) at 4,096
    keyframes with its loops as written (stride 80, span 512: they tie only
    the first 2,352 nodes), at chip_smoke.py's 3 GN x 24 PCG: the error
    falls. The untied chain leaves the reduction's dense tail with tiny
    eigenvalues: with a float32 chain preconditioner the error grows here,
    and on the GPU its tail factor was NaN, so the chain runs in float64."""
    cfg = tbk.BackendConfig(max_keyframes=4096, max_loops=64, keyframe_dist_thresh=0.3, gn_iterations=3,
                            pcg_iterations=24)
    g, t_true, t_noisy = tsyn.drifting_circle_graph(cfg, 24, 80, 512, device="cpu")
    out = tbk.optimize(cfg, g)
    err0 = np.linalg.norm(t_noisy - t_true, axis=1).max()
    err1 = np.linalg.norm(out.t.numpy() - t_true, axis=1).max()
    assert np.isfinite(err1) and err1 < err0, (err0, err1)


def _graph_close(gt, gj, n, tol_t, tol_R):
    np.testing.assert_allclose(gt.t.numpy()[:n], np.asarray(gj.t)[:n], atol=tol_t)
    np.testing.assert_allclose(gt.R.numpy()[:n], np.asarray(gj.R)[:n], atol=tol_R)


def test_optimize_matches_jax(graph_pair):
    """Full GN + chain-preconditioned PCG on the graph with IMU, GPS, a plain
    and a robust loop: node positions within 1e-3 m and rotations within
    1e-3 of JAX's (the port inverts the chain blocks by Cholesky where JAX
    runs Newton-Schulz, and sums factors in another order); the whitened
    chi2 after the solve within 1 % of JAX's and below the chi2 before."""
    cfg_j, cfg_t, gj, gt = graph_pair
    oj = jbk.optimize(cfg_j, gj)
    ot = tbk.optimize(cfg_t, gt)
    n = int(gt.n)
    _graph_close(ot, oj, n, 1e-3, 1e-3)
    np.testing.assert_allclose(ot.vel.numpy()[:n], np.asarray(oj.vel)[:n], atol=1e-3)
    c_t, c_j = float(tbk.residual_stats(cfg_t, ot)[0]), float(_jax_stats(cfg_j, oj)[0])
    assert abs(c_t / c_j - 1.0) < 0.01, (c_t, c_j)
    c0 = float(tbk.residual_stats(cfg_t, gt)[0])
    np.testing.assert_allclose(c0, float(_jax_stats(cfg_j, gj)[0]), rtol=1e-4)
    assert c_t < c0


def test_optimize_window_matches_jax(graph_pair):
    """The sliding-window solve (16 of 24 nodes; the in-window robust loop
    20 -> 2 is outside the window, so only odometry/IMU/GPS and the anchor
    act): window nodes within 1e-3 m / 1e-3 of JAX's, older nodes bit for
    bit unchanged."""
    cfg_j, cfg_t, gj, gt = graph_pair
    oj = jbk.optimize_window(cfg_j, gj, window=16)
    ot = tbk.optimize_window(cfg_t, gt, window=16)
    n = int(gt.n)
    _graph_close(ot, oj, n, 1e-3, 1e-3)
    np.testing.assert_array_equal(ot.t.numpy()[: n - 16], gt.t.numpy()[: n - 16])
    assert np.abs(ot.t.numpy()[n - 16:n] - gt.t.numpy()[n - 16:n]).max() > 1e-4   # the window moved


def test_grow_keeps_existing_slots_bitwise(graph_pair):
    """backend.grow: every existing slot of every field bit for bit, padded
    slots equal to JAX's padded graph."""
    cfg_j, cfg_t, gj, gt = graph_pair
    cj2, g2j = jbk.grow(cfg_j, gj)
    ct2, g2t = tbk.grow(cfg_t, gt)
    assert ct2.max_keyframes == cj2.max_keyframes == 64 and ct2.max_loops == cj2.max_loops == 8
    leaves_t = _flat(_np(g2t))
    leaves_old = _flat(_np(gt))
    for (name, a), (_, old), b in zip(leaves_t, leaves_old, (v for _, v in _flat(_np(g2j)))):
        assert a.dtype == old.dtype, name
        np.testing.assert_array_equal(a[tuple(slice(0, s) for s in old.shape)], old, err_msg=name)
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)


def _flat(tree, prefix=""):
    out = []
    for f, v in zip(tree._fields, tree):
        if isinstance(v, tuple):
            out += _flat(v, prefix + f + ".")
        else:
            out.append((prefix + f, v))
    return out
