"""Parity of the port's solver and point-to-plane ICP
(`pointcloud_slam_tpu_torch.register.solver`, `.icp`) and of K2's plain
version with the JAX package, on the same numpy inputs.

Pose tolerances: 1e-3 m and 0.05 deg against JAX on the same target (a JAX
map carried over by `convert`), unless a test says otherwise. The two sides
sum the normal equations in another order.

The ICP tests hold the port to JAX evaluated eagerly (`jax.disable_jit()`),
at 1e-4 m / 0.01 deg, and to JAX's jit-compiled solve at 5e-3 m / 0.1 deg.
The reason: `plane_fit` solves A n = -1 by adjugates (the reference's
esti_plane), which is ill-conditioned for planes near the origin, and
XLA's compiled CPU code evaluates it differently from JAX's own eager ops:
on the 4,000-point pair ~250 of ~2,300 validity flags flip between JAX
jit and JAX eager, and the jitted first GN step lands 5 mm from the eager
one. The port computes what eager JAX computes.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu import ops as jops, register as jreg
from pointcloud_slam_tpu.geom import se3 as jse3
from pointcloud_slam_tpu.io import synthetic as jsyn
from pointcloud_slam_tpu.ops import pallas as jpallas
from pointcloud_slam_tpu.register import solver as jsolver
from pointcloud_slam_tpu_torch import convert, ops as tops, register as treg
from pointcloud_slam_tpu_torch.geom import se3 as tse3
from pointcloud_slam_tpu_torch.io import synthetic as tsyn
from pointcloud_slam_tpu_torch.ops import bf_knn
from pointcloud_slam_tpu_torch.register import solver as tsolver

torch.set_num_threads(2)

GRID = dict(capacity=1 << 15, pts_per_voxel=8, resolution=0.5, nearby=7)   # tests/test_icp.py, K 16 -> 8
GRID_BAKED = dict(capacity=1 << 16, pts_per_voxel=16, resolution=0.5, nearby=7, baked=True)
# the default ICPConfig converges within 4 iterations on these pairs; 8 keeps
# the op-by-op JAX runs short (later iterations are frozen by the done mask)
ICP_T = treg.ICPConfig(solver=treg.SolverConfig(max_iterations=8))
ICP_J = jreg.ICPConfig(solver=jreg.SolverConfig(max_iterations=8))


def _pair(seed=0, n=4000, rot=0.05, trans=0.3):
    """tests/test_icp.py::setup_pair: src = R^T (world - t)."""
    world = tsyn.make_room_cloud(n, seed=seed)
    R, t = tsyn.random_pose(seed=seed + 1, rot_scale=rot, trans_scale=trans)
    return np.ascontiguousarray(world.T), np.ascontiguousarray(((world - t) @ R).astype(np.float32).T), R, t


def _pose_close(pt, pj, tol_m=1e-3, tol_deg=0.05):
    """Translation and rotation-angle differences (the angle from the skew
    part of R_j^T R_t, accurate at small angles) within the tolerances."""
    Rt, Rj = np.asarray(pt.R, np.float64), np.asarray(pj.R, np.float64)
    dt = np.linalg.norm(np.asarray(pt.t) - np.asarray(pj.t), axis=-1).max()
    A = np.swapaxes(Rj, -1, -2) @ Rt
    s = 0.5 * np.stack([A[..., 2, 1] - A[..., 1, 2], A[..., 0, 2] - A[..., 2, 0], A[..., 1, 0] - A[..., 0, 1]], -1)
    deg = np.degrees(np.arcsin(np.clip(np.linalg.norm(s, axis=-1), 0, 1))).max()
    assert dt <= tol_m and deg <= tol_deg, (dt, deg)


def _eager(fn, *args, **kw):
    """A JAX function evaluated op by op (see the module docstring)."""
    with jax.disable_jit():
        return fn(*args, **kw)


def test_random_pose_matches_jax():
    for seed in range(5):
        for a, b in zip(tsyn.random_pose(seed, 0.3, 1.0), jsyn.random_pose(seed, 0.3, 1.0)):
            np.testing.assert_array_equal(a, b)


# ---- solver ----

def _spd(rng, batch, cond=1e3):
    """Random SPD (batch, 6, 6) matrices with eigenvalues in [1, cond]."""
    Q, _ = np.linalg.qr(rng.normal(size=(batch, 6, 6)))
    w = np.exp(rng.uniform(0, np.log(cond), size=(batch, 6)))
    return ((Q * w[:, None, :]) @ np.swapaxes(Q, 1, 2)).astype(np.float32)


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_solve_step_spd(rng, lam):
    """(H + lam I) d = -b on random SPD H, batched on the port's side against
    the JAX unrolled Cholesky per matrix: rtol 1e-4 (condition <= 1e3, f32)."""
    H, b = _spd(rng, 16), rng.normal(size=(16, 6)).astype(np.float32)
    dt = tsolver._solve_step(torch.from_numpy(H), torch.from_numpy(b), lam).numpy()
    dj = np.stack([np.asarray(jsolver._solve_step(jnp.asarray(h), jnp.asarray(v), jnp.float32(lam)))
                   for h, v in zip(H, b)])
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dt, np.linalg.solve(H + (lam + 1e-6) * np.eye(6), -b[..., None])[..., 0],
                               rtol=1e-4, atol=1e-6)


def test_solve_step_zero_H():
    """No correspondences: H = b = 0 gives d = 0 exactly (the ridge), a frozen pose."""
    z6, z66 = torch.zeros(6), torch.zeros(6, 6)
    assert torch.equal(tsolver._solve_step(z66, z6, 0.0), z6)
    assert np.array_equal(np.asarray(jsolver._solve_step(jnp.zeros((6, 6)), jnp.zeros(6), jnp.float32(0))), np.zeros(6))


def test_degeneracy_projection(rng):
    """A nearly rank-deficient H (eigenvalues 1e-2 ... 9, threshold 0.05): the
    two weak eigendirections are projected out of the update, as in JAX (P at
    atol 1e-5). The projected step agrees with JAX's and with a float64 solve
    at atol 5e-3: the f32 solve before the projection carries errors of
    cond * eps * |x| (cond 900, |x| ~ 1e2) into every component."""
    Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    H = ((Q * np.array([1e-2, 2e-2, 2.0, 3.0, 5.0, 9.0])) @ Q.T).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    degt, Pt = tsolver.degeneracy_projection(torch.from_numpy(H), 0.05)
    degj, Pj = jsolver.degeneracy_projection(jnp.asarray(H), 0.05)
    assert bool(degt) and bool(degj)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), atol=1e-5)
    np.testing.assert_allclose(Pt.numpy(), Q[:, 2:] @ Q[:, 2:].T, atol=1e-5)
    dt = tsolver._solve_step(torch.from_numpy(H), torch.from_numpy(b), 0.0, (degt, Pt)).numpy()
    dj = np.asarray(jsolver._solve_step(jnp.asarray(H), jnp.asarray(b), jnp.float32(0), (degj, Pj)))
    d64 = Q[:, 2:] @ Q[:, 2:].T @ np.linalg.solve(H.astype(np.float64) + 1e-6 * np.eye(6), -b)
    np.testing.assert_allclose(dt, dj, atol=5e-3)
    np.testing.assert_allclose(dt, d64, atol=5e-3)
    assert abs(Q[:, 0] @ dt) < 1e-5 and abs(Q[:, 1] @ dt) < 1e-5
    assert tsolver.inline_projection(torch.from_numpy(H), 0.0) is None


def _p2p_linearize(xp, src, dst):
    """Point-to-point residuals r = R src + t - dst with fixed correspondences,
    written once for both frameworks (xp is jnp or torch)."""
    def lin(pose):
        pw = pose.R @ src + pose.t[:, None]
        r = pw - dst
        px, py, pz = pw[0], pw[1], pw[2]
        z, o = xp.zeros_like(px), xp.ones_like(px)
        J = xp.stack([xp.stack([z, pz, -py, o, z, z]), xp.stack([-pz, z, px, z, o, z]),
                      xp.stack([py, -px, z, z, z, o])])
        return xp.einsum("ain,ajn->ij", J, J), xp.einsum("ain,an->i", J, r), xp.sum(r * r)
    return lin


@pytest.mark.parametrize("method", ["gauss_newton", "levenberg_marquardt"])
def test_solvers_close_point_to_point(rng, method):
    """GN and LM close a point-to-point problem from identity on both sides:
    same iteration count and convergence flag, poses within 1e-5 m / 1e-4 deg
    of each other and of the truth."""
    src = rng.uniform(-5, 5, size=(3, 500)).astype(np.float32)
    R, t = tsyn.random_pose(seed=3, rot_scale=0.3, trans_scale=1.0)
    dst = (R @ src + t[:, None]).astype(np.float32)
    cfg_t, cfg_j = tsolver.SolverConfig(max_iterations=12), jsolver.SolverConfig(max_iterations=12)
    rt = getattr(tsolver, method)(_p2p_linearize(torch, torch.from_numpy(src), torch.from_numpy(dst)),
                                  tse3.identity(device="cpu"), cfg_t)
    rj = getattr(jsolver, method)(_p2p_linearize(jnp, jnp.asarray(src), jnp.asarray(dst)), jse3.identity(), cfg_j)
    assert int(rt.iterations) == int(rj.iterations) and bool(rt.converged) == bool(rj.converged)
    _pose_close(rt.pose, rj.pose, 1e-5, 1e-4)
    np.testing.assert_allclose(rt.pose.t.numpy(), t, atol=1e-5)
    np.testing.assert_allclose(float(rt.final_error), float(rj.final_error), atol=1e-6)


# ---- point-to-plane ICP ----

@pytest.fixture(scope="module")
def icp_maps():
    """JAX maps of the test_icp pair (unbaked and baked) and their port copies."""
    world, src, R, t = _pair()
    out = dict(world=world, src=src, R=R, t=t)
    for name, kw in (("unbaked", GRID), ("baked", GRID_BAKED)):
        jcfg, jg = jreg.build_target_map(jnp.asarray(world), grid_cfg=jops.GridConfig(**kw))
        out[name] = (jcfg, jg, tops.GridConfig(**kw), convert.grid_from_numpy(jax.tree.map(np.asarray, jg), device="cpu"))
    return out


@pytest.mark.parametrize("kind", ["unbaked", "baked"])
def test_point_to_plane_icp_matches_jax(icp_maps, kind):
    """Single-frame ICP on the same (carried) map, against eager JAX: pose
    within 1e-4 m / 0.01 deg, same iterations and inliers, final error at
    rtol 1e-3; on the baked map also against jitted JAX, within 5e-3 m /
    0.1 deg (module docstring). The JAX package reroutes baked single frames through its
    batched solver (a libtpu workaround); the port solves them directly."""
    jcfg, jg, tcfg, tg = icp_maps[kind]
    src = jnp.asarray(icp_maps["src"])
    re = _eager(jreg.point_to_plane_icp, jcfg, jg, src, cfg=ICP_J)
    rt = treg.point_to_plane_icp(tcfg, tg, torch.from_numpy(icp_maps["src"]), cfg=ICP_T)
    _pose_close(rt.pose, re.pose, 1e-4, 0.01)
    assert bool(rt.converged) and bool(re.converged) and int(rt.iterations) == int(re.iterations)
    assert int(rt.num_inliers) == int(re.num_inliers) > 0.5 * icp_maps["src"].shape[1]
    np.testing.assert_allclose(float(rt.final_error), float(re.final_error), rtol=1e-3)
    if kind == "baked":  # (compiling JAX's unrolled unbaked search would take ~30 s)
        _pose_close(rt.pose, jreg.point_to_plane_icp(jcfg, jg, src, cfg=ICP_J).pose, 5e-3, 0.1)
    np.testing.assert_allclose(rt.pose.t.numpy(), icp_maps["t"], atol=0.05)


def test_batched_icp_matches_jax(icp_maps):
    """B = 3 frames with their own offsets and a shared schedule on the baked
    map (config 1's solver, cut from 30 to 12 iterations: 3 searches, no
    early exit): per-frame poses
    within 1e-4 m / 0.01 deg of eager JAX's batched solve, iterations and
    inliers equal, H at rtol 1e-3; within 5e-3 m / 0.1 deg of jitted JAX."""
    jcfg, jg, tcfg, tg = icp_maps["baked"]
    world = icp_maps["world"].T
    srcs, gts = [], []
    for f in range(3):
        R, t = tsyn.random_pose(seed=100 + f, rot_scale=0.05, trans_scale=0.3)
        srcs.append(((world - t) @ R).astype(np.float32).T)
        gts.append(t)
    srcs = np.stack(srcs)
    cfg_t = treg.ICPConfig(search_every=4, warmup_searches=0,
                           solver=treg.SolverConfig(max_iterations=12, rotation_epsilon=0.0, translation_epsilon=0.0))
    cfg_j = jreg.ICPConfig(search_every=4, warmup_searches=0,
                           solver=jreg.SolverConfig(max_iterations=12, rotation_epsilon=0.0, translation_epsilon=0.0))
    pj, dj, ij, (ej, nj, Hj) = _eager(jreg.batched_point_to_plane_icp, jcfg, jg, jnp.asarray(srcs), cfg=cfg_j,
                                      return_stats=True)
    pt, dt, it, (et, nt, Ht) = treg.batched_point_to_plane_icp(tcfg, tg, torch.from_numpy(srcs), cfg=cfg_t,
                                                               return_stats=True)
    _pose_close(pt, pj, 1e-4, 0.01)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-3, atol=1e-4 * float(np.abs(Hj).max()))
    _pose_close(pt, jreg.batched_point_to_plane_icp(jcfg, jg, jnp.asarray(srcs), cfg=cfg_j)[0], 5e-3, 0.1)
    assert np.linalg.norm(pt.t.numpy() - np.stack(gts), axis=1).max() < 0.05
    # the single-frame solver on frame 1 lands on the batched pose
    r1 = treg.point_to_plane_icp(tcfg, tg, torch.from_numpy(srcs[1]), cfg=cfg_t)
    np.testing.assert_allclose(r1.pose.t.numpy(), pt.t[1].numpy(), atol=1e-4)


def test_icp_on_own_map_matches_jax():
    """The slice as a whole: each side builds its own map from the same
    numpy cloud and aligns the same frame. At this load (< 2 % of capacity,
    4 claim rounds) no insert race is left unresolved, so the maps answer
    alike: poses within 1e-4 m / 0.01 deg of eager JAX."""
    world, src, R, t = _pair(seed=3)
    jcfg, jg = jreg.build_target_map(jnp.asarray(world), grid_cfg=jops.GridConfig(**GRID))
    tcfg, tg = treg.build_target_map(torch.from_numpy(world), grid_cfg=tops.GridConfig(**GRID))
    re = _eager(jreg.point_to_plane_icp, jcfg, jg, jnp.asarray(src), cfg=ICP_J)
    rt = treg.point_to_plane_icp(tcfg, tg, torch.from_numpy(src), cfg=ICP_T)
    _pose_close(rt.pose, re.pose, 1e-4, 0.01)
    np.testing.assert_allclose(rt.pose.t.numpy(), t, atol=0.05)


def test_fitness_score_and_linearize_match_jax(icp_maps):
    """fitness_score on aligned and offset clouds (score at rtol 1e-5, matched
    counts equal), and one search + linearization at the true pose against
    eager JAX (inliers equal, H and b at rtol 1e-4 of their largest entry)."""
    jcfg, jg, tcfg, tg = icp_maps["unbaked"]
    src = icp_maps["src"]
    from pointcloud_slam_tpu.register import icp as jicp
    from pointcloud_slam_tpu_torch.register import icp as ticp

    R, t = icp_maps["R"], icp_maps["t"]
    mask = np.ones(src.shape[1], bool)
    lj = _eager(jicp._linearize, ICP_J, jcfg, jg, jnp.asarray(src), jnp.asarray(mask),
                jse3.Pose(jnp.asarray(R), jnp.asarray(t)))
    lt = ticp._linearize(ICP_T, tcfg, tg, torch.from_numpy(src), torch.from_numpy(mask),
                         tse3.Pose(torch.from_numpy(R), torch.from_numpy(t)))
    assert int(lt[3]) == int(lj[3]) > 0.5 * src.shape[1]
    for a, b in zip(lt[:2], lj[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4 * float(np.abs(b).max()))
    aligned = (icp_maps["R"] @ src + icp_maps["t"][:, None]).astype(np.float32)
    for pts in (aligned, (src + np.array([[0.3], [0.2], [0.1]])).astype(np.float32)):
        mask = np.arange(pts.shape[1]) % 7 != 0
        sj, nj = jreg.fitness_score(jcfg, jg, jnp.asarray(pts), jnp.asarray(mask))
        st, nt = treg.fitness_score(tcfg, tg, torch.from_numpy(pts), torch.from_numpy(mask))
        assert int(nt) == int(nj)
        np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)


def test_insert_return_indices(rng):
    """insert(return_indices=True): the map holds each kept point at its
    returned flat index, -1 marks the points dropped by a full voxel block,
    and as many are kept as on the JAX side."""
    cfg_kw = dict(capacity=1 << 12, pts_per_voxel=4, resolution=0.5, nearby=7)
    pts = rng.uniform(-3, 3, size=(3, 900)).astype(np.float32)
    pts[:, :40] = pts[:, :1] + rng.uniform(0, 0.05, size=(3, 40))   # one crowded voxel
    mask = rng.uniform(size=900) < 0.9
    tcfg = tops.GridConfig(**cfg_kw)
    g, idx = tops.insert(tcfg, tops.create(tcfg, device="cpu"), torch.from_numpy(pts), torch.from_numpy(mask),
                         return_indices=True)
    idx = idx.numpy()
    kept = idx >= 0
    _, per_voxel = np.unique(np.floor(pts[:, mask] / 0.5), axis=1, return_counts=True)
    assert not kept[~mask].any() and (~kept[mask]).sum() == np.maximum(per_voxel - 4, 0).sum() > 0
    flat = g.pts.reshape(3, -1).numpy()
    np.testing.assert_array_equal(flat[:, idx[kept]], pts[:, kept])
    assert len(np.unique(idx[kept])) == kept.sum()
    jcfg = jops.GridConfig(**cfg_kw)
    _, jidx = jops.insert(jcfg, jops.create(jcfg), jnp.asarray(pts), jnp.asarray(mask), return_indices=True)
    assert int((np.asarray(jidx) >= 0).sum()) == int(kept.sum())
    with pytest.raises(ValueError):
        tops.insert(tops.GridConfig(**GRID_BAKED), tops.create(tops.GridConfig(**GRID_BAKED), device="cpu"),
                    torch.from_numpy(pts), torch.from_numpy(mask), return_indices=True)


# ---- K2's plain version ----

def test_nearest_neighbor_matches_pallas(rng):
    """K2's CPU path against JAX's interpreted `nearest_neighbor`, padded to
    tile multiples as tests/test_pallas.py does: d2 at rtol 1e-3 (JAX expands
    |q|^2+|p|^2-2q.p, the port takes the direct difference), indices equal
    wherever the nearest neighbour is clear of a near-tie."""
    db = rng.uniform(-5, 5, size=(3, 1000)).astype(np.float32)
    q = rng.uniform(-5, 5, size=(3, 250)).astype(np.float32)
    mask = np.ones(1000, bool)
    mask[::9] = False
    dbp = np.asarray(jpallas.pad_cloud(jnp.asarray(db), jnp.asarray(mask), 512))
    qp = np.asarray(jpallas.pad_cloud(jnp.asarray(q), jnp.ones(250, bool), 256))
    dj, ij = jpallas.nearest_neighbor(jnp.asarray(qp), jnp.asarray(dbp), bq=256, bm=512)
    dbt = bf_knn.pad_cloud(torch.from_numpy(db), torch.from_numpy(mask), 512)
    np.testing.assert_array_equal(dbt.numpy(), dbp)
    dt, it = bf_knn.nearest_neighbor(torch.from_numpy(q), dbt)
    assert dt.shape == (250,) and it.dtype == torch.int32
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj)[:250], rtol=1e-3, atol=1e-4)
    d2k, _ = bf_knn.knn_plain(torch.from_numpy(q), dbt, k=2)
    clear = (d2k[1] - d2k[0]).numpy() > 1e-3 * d2k[1].numpy()
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(it.numpy()[clear], np.asarray(ij)[:250][clear])
    assert mask[it.numpy()].all()


def test_nearest_neighbor_ties_and_ragged():
    """Lower index first on exact ties; ragged sizes need no padding; an
    empty database gives 3e38 / -1."""
    db = torch.tensor([[1.0, -1.0, 0.0, 1.0], [0, 0, 2, 0], [0, 0, 0, 0]])
    d2, idx = bf_knn.nearest_neighbor(torch.zeros(3, 2), db)
    assert idx.tolist() == [0, 0] and d2.tolist() == [1.0, 1.0]
    g = np.random.default_rng(5)
    q, db = (torch.from_numpy(g.uniform(-1, 1, size=(3, n)).astype(np.float32)) for n in (1537, 2049))
    d2, idx = bf_knn.nearest_neighbor(q, db)
    pd2, pidx = bf_knn.knn_plain(q, db, k=1)
    assert torch.equal(d2, pd2[0]) and torch.equal(idx, pidx[0])
    d2, idx = bf_knn.nearest_neighbor(q, torch.zeros(3, 0))
    assert bool((idx == -1).all()) and bool((d2 > 1e38).all())
