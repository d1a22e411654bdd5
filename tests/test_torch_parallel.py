"""The port's sharded paths (`pointcloud_slam_tpu_torch.parallel`) on a
4-rank gloo group on the CPU, mesh (2, 2), against the port's and the JAX
package's single-device functions on tests/test_parallel.py's inputs.

One module fixture spawns the group once (`parallel.launch`, one thread a
rank) and runs all four sharded functions on it; the tests read every
rank's outputs. Tolerances:
  * against the port's single-device functions, tests/test_parallel.py's
    own: 1e-2 for ICP; 1e-5 for the LIO state and P with equal iterations;
    1e-4 for scan-to-map with equal counts and degeneracy flag; 2e-4 / 5e-4
    for the backend;
  * against JAX's single-device functions, the existing parity tests':
    compiled ICP 5e-3 m / 0.1 deg (test_torch_register.py); the compiled
    LIO update 1 cm with equal iterations (test_torch_lio.py's step
    parity; rotation 1e-2, P 1e-5); the backend 1e-3
    (test_torch_liosam.py); scan-to-map only behind --heavy (below);
  * every rank's outputs bit for bit equal.
Behind --heavy: the LIO update and scan-to-map against JAX evaluated op by
op, as the port computes them (test_torch_lio.py's 1e-4 / 1e-5 and
test_torch_scan2map.py's 1e-3; ~25 s and ~40 s of JAX primitive
compilation), and the port's 8-rank group against JAX's own sharded
functions on the 8-device mesh (minutes of compilation).

The rank programs are module functions (a spawned rank imports this module
to find them), so JAX is imported only inside the functions that use it.
"""

import concurrent.futures
import os
import tempfile
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pointcloud_slam_tpu_torch import convert, ops, parallel, register
from pointcloud_slam_tpu_torch.geom import se3
from pointcloud_slam_tpu_torch.io import synthetic
from pointcloud_slam_tpu_torch.models import lio
from pointcloud_slam_tpu_torch.models.lio import eskf
from pointcloud_slam_tpu_torch.models.lio import pipeline as lp
from pointcloud_slam_tpu_torch.models.liosam import backend as bk
from pointcloud_slam_tpu_torch.models.liosam import scan2map as s2m
from pointcloud_slam_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(2)

GRID_KW = dict(capacity=1 << 13, pts_per_voxel=16, resolution=0.5, nearby=7)   # tests/test_parallel.py
GRID = ops.GridConfig(**GRID_KW)
WORLD = 4
B_ICP = 4
KF_SMALL, KF_BIG = 64, 1024


def _soa(x):
    return np.ascontiguousarray(np.asarray(x, np.float32).T)


# ---- inputs: tests/test_parallel.py's, from the same seeds ----

def _icp_inputs():
    world = synthetic.make_room_cloud(2048, seed=0)
    srcs, ts = [], []
    for b in range(B_ICP):
        R, t = synthetic.random_pose(seed=10 + b, rot_scale=0.05, trans_scale=0.2)
        srcs.append((world - t) @ R)
        ts.append(t)
    return dict(world=_soa(world), src=np.stack(srcs).transpose(0, 2, 1).astype(np.float32), t=np.stack(ts))


def _lio_inputs():
    world = synthetic.make_room_cloud(4096, seed=0)
    sel = np.random.default_rng(3).choice(len(world), 1024, replace=False)
    return dict(world=_soa(world), pts=_soa(world[sel] - np.array([0.1, -0.05, 0.02])))


def _s2m_inputs():
    corners_w, surfs_w = synthetic.make_feature_world(seed=4)
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.5, 0.2, 1.0], np.float32)
    c, cm = synthetic.take_scan(corners_w, R, t, 1024, seed=1)
    s, sm = synthetic.take_scan(surfs_w, R, t, 8192, seed=2)
    t2 = t + np.array([0.15, -0.1, 0.03], np.float32)
    c2, cm2 = synthetic.take_scan(corners_w, R, t2, 256, seed=3)
    s2_, sm2 = synthetic.take_scan(surfs_w, R, t2, 1024, seed=4)
    return dict(cmap_pts=_soa(c + t), cmap_mask=np.asarray(cm), smap_pts=_soa(s + t), smap_mask=np.asarray(sm),
                c=_soa(c2), cm=np.asarray(cm2), s=_soa(s2_), sm=np.asarray(sm2), t=t, t2=t2)


def _small_graph_jax():
    """test_parallel.py's 64-keyframe graph (40 noisy keyframes, one robust
    loop), built by the JAX package."""
    import jax.numpy as jnp
    from pointcloud_slam_tpu.models.liosam import backend as jbk

    cfg = jbk.BackendConfig(max_keyframes=KF_SMALL, max_loops=8, gn_iterations=4, pcg_iterations=40)
    rng = np.random.default_rng(0)
    g = jbk.create(cfg)
    t_true = np.cumsum(rng.normal(0, 0.5, (40, 3)).astype(np.float32), axis=0)
    for k in range(40):
        noise = rng.normal(0, 0.02, 3).astype(np.float32)
        g = jbk.add_keyframe(cfg, g, jnp.eye(3), jnp.asarray(t_true[k] + noise))
    g = jbk.add_loop(cfg, g, jnp.asarray(2), jnp.asarray(30), jnp.eye(3),
                     jnp.asarray(t_true[30] - t_true[2]), jnp.full((6,), 1e3), robust=True)
    return cfg, g


def _big_graph(device="cpu"):
    """test_parallel.py's 1,024-keyframe drifting circle with 16 loops."""
    cfg = bk.BackendConfig(max_keyframes=KF_BIG, max_loops=32, gn_iterations=3, pcg_iterations=40)
    return (cfg, *synthetic.drifting_circle_graph(cfg, 16, 30, 512, radius=30.0, climb=0.1, rng=1, device=device))


def _port_map(pts, grid_cfg, mask=None):
    """The port's map of `pts` (3, N) on the CPU, as a namespace of numpy
    arrays (a rank unpickles it without importing JAX)."""
    m = torch.ones(pts.shape[1], dtype=torch.bool) if mask is None else torch.from_numpy(np.asarray(mask))
    g = ops.insert(grid_cfg, ops.create(grid_cfg, device="cpu"), torch.from_numpy(pts), m)
    return types.SimpleNamespace(**{f: getattr(g, f).numpy() for f in g._fields})


def _np_tree(tree):
    """A JAX NamedTuple as a namespace of numpy arrays."""
    if isinstance(tree, tuple):
        return types.SimpleNamespace(**{f: _np_tree(getattr(tree, f)) for f in tree._fields})
    return np.asarray(tree)


def _jax_map(m):
    """A map of `_port_map` as the JAX package's VoxelHashMap (the port holds
    the uint32 fingerprints as int64)."""
    import jax.numpy as jnp
    from pointcloud_slam_tpu import ops as jops

    return jops.VoxelHashMap(**{f: jnp.asarray(getattr(m, f).astype(np.uint32) if f == "fp" else getattr(m, f))
                                for f in jops.VoxelHashMap._fields})


def _build_inputs():
    """Every input as numpy, the maps built by the port; the small graph is
    built by the JAX package and carried into the port by `convert`."""
    icp, lio_in, s2 = _icp_inputs(), _lio_inputs(), _s2m_inputs()
    s2cfg = s2m.Scan2MapConfig()
    maps = {"icp": _port_map(icp["world"], GRID), "lio": _port_map(lio_in["world"], GRID),
            "corner": _port_map(s2["cmap_pts"], s2cfg.corner_grid, s2["cmap_mask"]),
            "surf": _port_map(s2["smap_pts"], s2cfg.surf_grid, s2["smap_mask"])}
    cfg_small, g_small = _small_graph_jax()
    return dict(icp=icp, lio=lio_in, s2m=s2, maps=maps, graph_small=_np_tree(g_small)), (cfg_small, g_small)


# ---- what every rank runs, and the same on one device ----

def _port_inputs(inp, device="cpu"):
    maps = {k: convert.grid_from_numpy(v, device) for k, v in inp["maps"].items()}
    g_small = convert.pose_graph_from_numpy(inp["graph_small"], device)
    return maps, g_small


def _icp_cfg():
    return register.ICPConfig()


def _lio_cfg():
    return lio.LIOConfig(grid=GRID, init_imu_frames=1)


def _small_cfg():
    return bk.BackendConfig(max_keyframes=KF_SMALL, max_loops=8, gn_iterations=4, pcg_iterations=40)


def run_sharded(inp, device="cpu"):
    """The four sharded functions on this rank, every replicated input
    broadcast from rank 0. Returns their outputs and the all-reduce count."""
    mesh = parallel.make_mesh(device_type=device)
    maps, g_small = _port_inputs(inp, device)
    maps = {k: pmesh.replicate(m) for k, m in maps.items()}
    g_small = pmesh.replicate(g_small)
    pmesh.all_reduce_sum.calls = 0
    out = {"mesh": tuple(mesh.shape), "rank": dist.get_rank()}

    src = torch.from_numpy(inp["icp"]["src"]).to(device)
    mask = torch.ones(src.shape[0], src.shape[2], dtype=torch.bool, device=device)
    pose, conv, iters = parallel.sharded_point_to_plane_icp(
        mesh, GRID, maps["icp"], src, mask, se3.identity(batch=(B_ICP,), device=device), cfg=_icp_cfg())
    out["icp"] = (pose.R, pose.t, conv, iters)

    cfg = _lio_cfg()
    s0 = lio.create_state(cfg, device=device)
    x0, P0 = pmesh.replicate((s0.x, s0.P))
    pts = torch.from_numpy(inp["lio"]["pts"]).to(device)
    x, P, l_iters, l_conv = parallel.sharded_lio_update(mesh, cfg, maps["lio"], x0, P0, pts,
                                                        torch.ones(pts.shape[1], dtype=torch.bool, device=device))
    out["lio"] = (tuple(x), P, l_iters, l_conv)

    s2 = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in inp["s2m"].items()}
    init = se3.Pose(torch.eye(3, device=device), s2["t"])
    res = parallel.sharded_scan_to_map(mesh, s2m.Scan2MapConfig(), maps["corner"], maps["surf"], s2["c"], s2["cm"],
                                       s2["s"], s2["sm"], init)
    out["s2m"] = (res.pose.R, res.pose.t, res.num_corner, res.num_surf, res.degenerate, res.iterations)

    small = parallel.sharded_optimize(mesh, _small_cfg(), g_small)
    cfg_big, g_big, _, _ = _big_graph(device)
    g_big = pmesh.replicate(g_big)
    big = parallel.sharded_optimize(mesh, cfg_big, g_big)
    out["backend"] = (small.R, small.t, big.R, big.t)
    out["all_reduces"] = pmesh.all_reduce_sum.calls
    try:    # JAX requires the sharded axes to divide; so does the port
        parallel.sharded_lio_update(mesh, cfg, maps["lio"], x0, P0, pts[:, :1023], torch.ones(1023, dtype=torch.bool))
        out["ragged"] = "ran"
    except ValueError as e:
        out["ragged"] = str(e)
    return out


def _lio_single(inp, maps):
    cfg = _lio_cfg()
    s0 = lio.create_state(cfg, device="cpu")
    pts = torch.from_numpy(inp["lio"]["pts"])
    obs = lp._obs_model(cfg, maps["lio"], pts, torch.sqrt(torch.sum(pts * pts, dim=0)),
                        torch.ones(pts.shape[1], dtype=torch.bool))
    return eskf.update_iterated(s0.x, s0.P, obs, cfg.laser_point_cov, cfg.max_iterations, cfg.epsi)


def _single(inp):
    """The port's single-device functions on the same inputs."""
    maps, g_small = _port_inputs(inp)
    src = torch.from_numpy(inp["icp"]["src"])
    icp = [register.point_to_plane_icp(GRID, maps["icp"], src[b], cfg=_icp_cfg()) for b in range(B_ICP)]
    s2 = {k: torch.from_numpy(np.asarray(v)) for k, v in inp["s2m"].items()}
    s2r = s2m.scan_to_map(s2m.Scan2MapConfig(), maps["corner"], maps["surf"], s2["c"], s2["cm"], s2["s"], s2["sm"],
                          se3.Pose(torch.eye(3), s2["t"]))
    cfg_big, g_big, t_true, t_noisy = _big_graph()
    return dict(icp=icp, lio=_lio_single(inp, maps), s2m=s2r, small=bk.optimize(_small_cfg(), g_small),
                big=bk.optimize(cfg_big, g_big), t_true=t_true, t_noisy=t_noisy)


@pytest.fixture(scope="module")
def launched():
    """(inputs, every rank's outputs, JAX's small graph, the port's
    single-device results); the single-device references run in this
    process while the ranks run."""
    inp, jgraph = _build_inputs()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(parallel.launch, run_sharded, WORLD, device="cpu", args=(inp,), timeout=300)
        single = _single(inp)
        outs = ranks.result()
    return inp, outs, jgraph, single


@pytest.fixture(scope="module")
def runs(launched):
    return launched[:3]


@pytest.fixture(scope="module")
def single(launched):
    return launched[3]


# ---- the mesh ----

@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shape_matches_jax(n):
    """The (dp, sp) rule of JAX's make_mesh on the conftest's 8 CPU devices."""
    from pointcloud_slam_tpu import parallel as jparallel

    assert pmesh.mesh_shape(n) == tuple(jparallel.make_mesh(n).devices.shape)


def test_ranks_hold_a_2x2_mesh_and_equal_outputs(runs):
    """Every rank saw mesh (2, 2), and every output is bit for bit equal
    across ranks (the replicated work follows only reduced sums)."""
    _, outs, _ = runs
    assert [o["rank"] for o in outs] == list(range(WORLD))
    assert all(o["mesh"] == (2, 2) for o in outs)

    def flat(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        return [t for v in tree for t in flat(v)]

    for key in ("icp", "lio", "s2m", "backend"):
        for o in outs[1:]:
            for a, b in zip(flat(outs[0][key]), flat(o[key])):
                assert torch.equal(a, b), key
    assert len({o["all_reduces"] for o in outs}) == 1
    assert all("does not divide" in o["ragged"] for o in outs)


def test_launch_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank"):
        parallel.launch(_fail_on_rank_1, 2, device="cpu", timeout=120)


def _fail_on_rank_1():
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    return dist.get_rank()


def test_world_of_one_in_process():
    """A world-size-1 gloo group in this process, mesh (1, 1): the sharded ICP
    is the batched single-device solve, bit for bit."""
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(d, "s"), 1), rank=0, world_size=1)
        try:
            mesh = parallel.make_mesh(device_type="cpu")
            assert tuple(mesh.shape) == (1, 1)
            world = synthetic.make_room_cloud(1024, seed=5)
            _, grid = register.build_target_map(torch.from_numpy(_soa(world)), grid_cfg=GRID)
            R, t = synthetic.random_pose(seed=7, rot_scale=0.05, trans_scale=0.2)
            src = torch.from_numpy(_soa((world - t) @ R))
            cfg = register.ICPConfig(solver=register.SolverConfig(max_iterations=8))
            pose, conv, iters = parallel.sharded_point_to_plane_icp(
                mesh, GRID, grid, src[None], torch.ones(1, src.shape[1], dtype=torch.bool),
                se3.identity(batch=(1,)), cfg=cfg)
            ref = register.batched_point_to_plane_icp(GRID, grid, src[None], cfg=cfg)
            assert torch.equal(pose.t, ref[0].t) and torch.equal(pose.R, ref[0].R)
            assert torch.equal(iters, ref[2]) and torch.equal(conv, ref[1])
        finally:
            dist.destroy_process_group()


# ---- against the port's single-device functions (test_parallel.py's tolerances) ----

def test_sharded_icp_matches_single_device(runs, single):
    inp, outs, _ = runs
    R, t, conv, iters = outs[0]["icp"]
    for b, ref in enumerate(single["icp"]):
        np.testing.assert_allclose(t[b].numpy(), ref.pose.t.numpy(), atol=1e-2)
        np.testing.assert_allclose(R[b].numpy(), ref.pose.R.numpy(), atol=1e-2)
        np.testing.assert_allclose(t[b].numpy(), inp["icp"]["t"][b], atol=5e-2)
    assert bool(conv.all())


def test_sharded_lio_update_matches_single_device(runs, single):
    x, P, iters, conv = runs[1][0]["lio"]
    ref = single["lio"]
    np.testing.assert_allclose(x[0].numpy(), ref.x.pos.numpy(), atol=1e-5)
    np.testing.assert_allclose(x[1].numpy(), ref.x.rot.numpy(), atol=1e-5)
    np.testing.assert_allclose(P.numpy(), ref.P.numpy(), atol=1e-5)
    assert int(iters) == int(ref.iterations) and bool(conv) == bool(ref.converged)


def test_sharded_scan_to_map_matches_single_device(runs, single):
    inp, outs, _ = runs
    R, t, nc, ns, degenerate, _ = outs[0]["s2m"]
    ref = single["s2m"]
    np.testing.assert_allclose(t.numpy(), ref.pose.t.numpy(), atol=1e-4)
    np.testing.assert_allclose(R.numpy(), ref.pose.R.numpy(), atol=1e-4)
    assert int(nc) == int(ref.num_corner) and int(ns) == int(ref.num_surf)
    assert bool(degenerate) == bool(ref.degenerate)
    np.testing.assert_allclose(t.numpy(), inp["s2m"]["t2"], atol=5e-2)


def test_sharded_backend_matches_single_device(runs, single):
    Rs, ts, Rb, tb = runs[1][0]["backend"]
    np.testing.assert_allclose(ts.numpy(), single["small"].t.numpy(), atol=2e-4)
    np.testing.assert_allclose(Rs.numpy(), single["small"].R.numpy(), atol=2e-4)
    np.testing.assert_allclose(tb.numpy(), single["big"].t.numpy(), atol=5e-4)
    np.testing.assert_allclose(Rb.numpy(), single["big"].R.numpy(), atol=5e-4)
    err0 = np.linalg.norm(single["t_noisy"] - single["t_true"], axis=1).max()
    err1 = np.linalg.norm(tb.numpy() - single["t_true"], axis=1).max()
    assert err1 < 0.85 * err0, (err0, err1)


# ---- against JAX's single-device functions (the parity tests' tolerances) ----

def _pose_close(R_t, t_t, R_j, t_j, tol_m, tol_deg):
    """test_torch_register.py's measure: translation and rotation angle."""
    Rt, Rj = np.asarray(R_t, np.float64), np.asarray(R_j, np.float64)
    dt = np.linalg.norm(np.asarray(t_t) - np.asarray(t_j), axis=-1).max()
    A = np.swapaxes(Rj, -1, -2) @ Rt
    s = 0.5 * np.stack([A[..., 2, 1] - A[..., 1, 2], A[..., 0, 2] - A[..., 2, 0], A[..., 1, 0] - A[..., 0, 1]], -1)
    deg = np.degrees(np.arcsin(np.clip(np.linalg.norm(s, axis=-1), 0, 1))).max()
    assert dt <= tol_m and deg <= tol_deg, (dt, deg)


def test_sharded_icp_matches_jax(runs):
    """Against JAX's jit-compiled batched solve: 5e-3 m / 0.1 deg
    (test_torch_register.py's tolerance for compiled JAX, whose plane fits
    flip validity flags against eager evaluation)."""
    import jax.numpy as jnp
    from pointcloud_slam_tpu import ops as jops, register as jreg

    inp, outs, _ = runs
    pj, dj, _ = jreg.batched_point_to_plane_icp(jops.GridConfig(**GRID_KW), _jax_map(inp["maps"]["icp"]),
                                                 jnp.asarray(inp["icp"]["src"]))
    R, t, conv, _ = outs[0]["icp"]
    _pose_close(R, t, pj.R, pj.t, 5e-3, 0.1)
    assert bool(np.asarray(dj).all()) and bool(conv.all())


def _jax_lio(inp, eager):
    import jax
    import jax.numpy as jnp
    from pointcloud_slam_tpu import ops as jops
    from pointcloud_slam_tpu.models import lio as jlio
    from pointcloud_slam_tpu.models.lio import eskf as jeskf
    from pointcloud_slam_tpu.models.lio import pipeline as jlp

    cfg = jlio.LIOConfig(grid=jops.GridConfig(**GRID_KW), init_imu_frames=1)
    pts, grid = jnp.asarray(inp["lio"]["pts"]), _jax_map(inp["maps"]["lio"])
    s0 = jlio.create_state(cfg)

    def run():
        obs = jlp._obs_model(cfg, grid, pts, jnp.sqrt(jnp.sum(pts * pts, axis=0)), jnp.ones(pts.shape[1], bool))
        return jeskf.update_iterated(s0.x, s0.P, obs, cfg.laser_point_cov, cfg.max_iterations, cfg.epsi)

    if not eager:
        return run()
    with jax.disable_jit():
        return run()


def test_sharded_lio_update_matches_jax(runs):
    """Against JAX's update over its observation model, compiled: positions
    within 1 cm and the same iterations (test_torch_lio.py's step parity
    with compiled JAX), the rotation within the same 1e-2 and P within
    test_torch_lio.py's 1e-5. Compiled JAX's plane fits flip validity flags
    against its own eager ops: on this frame it lands 3.4 mm / 1.5e-3 from
    the port and 3.8 mm from eager JAX, which the port computes (the heavy
    case holds the port to eager JAX at 1e-4)."""
    inp, outs, _ = runs
    ref = _jax_lio(inp, eager=False)
    x, P, iters, conv = outs[0]["lio"]
    np.testing.assert_allclose(x[0].numpy(), np.asarray(ref.x.pos), atol=1e-2)
    np.testing.assert_allclose(x[1].numpy(), np.asarray(ref.x.rot), atol=1e-2)
    np.testing.assert_allclose(P.numpy(), np.asarray(ref.P), atol=1e-5)
    assert int(iters) == int(ref.iterations) and bool(conv) == bool(ref.converged)


@pytest.mark.heavy
def test_sharded_lio_update_matches_eager_jax(runs):
    """Against JAX evaluated op by op (~25 s of JAX primitive compilation):
    the state within 1e-4 and P within 1e-5, the same iterations
    (test_torch_lio.py:195-216)."""
    inp, outs, _ = runs
    ref = _jax_lio(inp, eager=True)
    x, P, iters, _ = outs[0]["lio"]
    np.testing.assert_allclose(x[0].numpy(), np.asarray(ref.x.pos), atol=1e-4)
    np.testing.assert_allclose(x[1].numpy(), np.asarray(ref.x.rot), atol=1e-4)
    np.testing.assert_allclose(P.numpy(), np.asarray(ref.P), atol=1e-5)
    assert int(iters) == int(ref.iterations)


@pytest.mark.heavy
def test_sharded_scan_to_map_matches_eager_jax(runs):
    """Against JAX's scan_to_map evaluated op by op (~40 s of JAX primitive
    compilation; compiled, ~80 s): test_torch_scan2map.py's tolerances."""
    import jax
    import jax.numpy as jnp
    from pointcloud_slam_tpu.geom import se3 as jse3
    from pointcloud_slam_tpu.models.liosam import scan2map as js2m

    inp, outs, _ = runs
    s2 = inp["s2m"]
    with jax.disable_jit():
        ref = js2m.scan_to_map(js2m.Scan2MapConfig(), _jax_map(inp["maps"]["corner"]), _jax_map(inp["maps"]["surf"]),
                               jnp.asarray(s2["c"]), jnp.asarray(s2["cm"]), jnp.asarray(s2["s"]),
                               jnp.asarray(s2["sm"]), jse3.Pose(jnp.eye(3), jnp.asarray(s2["t"])))
    R, t, nc, ns, degenerate, _ = outs[0]["s2m"]
    np.testing.assert_allclose(t.numpy(), np.asarray(ref.pose.t), atol=1e-3)
    np.testing.assert_allclose(R.numpy(), np.asarray(ref.pose.R), atol=1e-3)
    assert abs(int(ns) - int(ref.num_surf)) <= 0.002 * int(ref.num_surf)
    assert abs(int(nc) - int(ref.num_corner)) <= 0.002 * int(ref.num_corner) + 1
    assert bool(degenerate) == bool(ref.degenerate)


def test_sharded_backend_matches_jax(runs):
    """Against JAX's optimize on the same graph: 1e-3 (test_torch_liosam.py)."""
    from pointcloud_slam_tpu.models.liosam import backend as jbk

    _, outs, (cfg_j, g_j) = runs
    ref = jbk.optimize(cfg_j, g_j)
    Rs, ts, _, _ = outs[0]["backend"]
    n = int(g_j.n)
    np.testing.assert_allclose(ts.numpy()[:n], np.asarray(ref.t)[:n], atol=1e-3)
    np.testing.assert_allclose(Rs.numpy()[:n], np.asarray(ref.R)[:n], atol=1e-3)


# ---- the hooks ----

@pytest.mark.parametrize("shards", [1, 3, 4])
def test_graph_terms_summed_over_slot_shards(runs, shards):
    """`_graph_terms` over slot shards (the last one running past the tables:
    inert), scattered and summed, equals the unsharded terms; rows past the
    tables carry zero information."""
    cfg, g = _small_cfg(), _port_inputs(runs[0])[1]
    KF, L = cfg.max_keyframes, g.loop_i.shape[0]
    fi, fj, Ji, Jj, e, info, B = bk._graph_terms(cfg, g)
    prior = torch.zeros(KF, bk.D)
    b_ref = bk._rhs(KF, fi, fj, Ji, Jj, e, info, g.R, g.t, g.prior_pos, prior)
    D_ref = bk._precond_blocks(KF, torch.float32, fi, fj, Ji, Jj, info, prior)
    v = torch.from_numpy(np.random.default_rng(0).normal(size=(KF, bk.D)).astype(np.float32))
    hv_ref = bk._hv(fi, fj, Ji, Jj, info, prior, v)
    kc, lc = -(-KF // shards), -(-L // shards)
    acc = [torch.zeros_like(B), torch.zeros_like(b_ref), torch.zeros_like(D_ref), torch.zeros_like(hv_ref)]
    for r in range(shards):
        ks, ls = r * kc + torch.arange(kc), r * lc + torch.arange(lc)
        fi, fj, Ji, Jj, e, info, Bp = bk._graph_terms(cfg, g, ks, ls)
        past = torch.cat([ks >= KF, ls >= L, ks >= KF, ks >= KF])
        assert bool((info[past] == 0).all())
        acc[0] += Bp
        acc[1] += bk._rhs(KF, fi, fj, Ji, Jj, e, info, g.R, g.t, g.prior_pos, prior)
        acc[2] += bk._precond_blocks(KF, torch.float32, fi, fj, Ji, Jj, info, prior) - 1e-6 * torch.eye(bk.D)
        acc[3] += bk._hv(fi, fj, Ji, Jj, info, prior, v)
    acc[2] += 1e-6 * torch.eye(bk.D)
    for name, a, ref in zip(("B", "b", "blocks", "hv"), acc, (B, b_ref, D_ref, hv_ref)):
        np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=1e-5, atol=1e-3, err_msg=name)


def test_hooks_default_unchanged(runs):
    """reduce=None / no slots compute what the identity reduce does, bit for
    bit: the ICP loop, the ESKF update, scan-to-map and the backend."""
    inp = runs[0]
    maps, g_small = _port_inputs(inp)
    ident = lambda ts: ts
    src = torch.from_numpy(inp["icp"]["src"][:2])
    cfg = register.ICPConfig(solver=register.SolverConfig(max_iterations=4))
    a = register.batched_point_to_plane_icp(GRID, maps["icp"], src, cfg=cfg)
    flat_mask = torch.ones(src.shape[0] * src.shape[2], dtype=torch.bool)
    search = lambda pose: register.icp.correspondences(cfg, GRID, maps["icp"], register.icp._flat(pose.apply(src)),
                                                       flat_mask)
    b = register.icp.icp_loop(cfg, src, se3.identity(batch=(2,)), search, reduce=ident)
    assert torch.equal(a[0].t, b[0].t) and torch.equal(a[0].R, b[0].R) and torch.equal(a[2], b[2])

    u0 = _lio_single(inp, maps)
    cfg_l = _lio_cfg()
    s0 = lio.create_state(cfg_l, device="cpu")
    pts = torch.from_numpy(inp["lio"]["pts"])
    obs = lp._obs_model(cfg_l, maps["lio"], pts, torch.sqrt(torch.sum(pts * pts, dim=0)),
                        torch.ones(pts.shape[1], dtype=torch.bool))
    u1 = eskf.update_iterated(s0.x, s0.P, obs, cfg_l.laser_point_cov, cfg_l.max_iterations, cfg_l.epsi,
                              reduce=ident)
    assert torch.equal(u0.P, u1.P) and all(torch.equal(p, q) for p, q in zip(u0.x, u1.x))

    cfg_b = _small_cfg()
    o0 = bk.optimize(cfg_b, g_small)
    KF, L = cfg_b.max_keyframes, g_small.loop_i.shape[0]
    o1 = bk._gauss_newton(cfg_b, g_small, cfg_b.gn_iterations, cfg_b.pcg_iterations, torch.arange(KF),
                          torch.arange(L), ident)
    assert torch.equal(o0.t, o1.t) and torch.equal(o0.R, o1.R)


@pytest.mark.heavy
def test_eight_ranks_match_jax_sharded():
    """The port's 8-rank group (mesh (2, 4)) against JAX's sharded functions
    on the conftest's 8-device mesh (~7 min of JAX compilation), at the
    compiled-JAX tolerances above (5e-3 m / 0.1 deg ICP, 1 cm LIO and
    scan-to-map) and the backend's 1e-3."""
    import jax.numpy as jnp
    from pointcloud_slam_tpu import ops as jops, parallel as jparallel
    from pointcloud_slam_tpu.geom import se3 as jse3
    from pointcloud_slam_tpu.models import lio as jlio
    from pointcloud_slam_tpu.models.liosam import scan2map as js2m

    inp, (cfg_j, g_j) = _build_inputs()
    outs = parallel.launch(run_sharded, 8, device="cpu", args=(inp,), timeout=900)
    assert all(o["mesh"] == (2, 4) for o in outs)
    mesh = jparallel.make_mesh(8)
    grid_cfg = jops.GridConfig(**GRID_KW)
    src = jnp.asarray(inp["icp"]["src"])
    pose, _, _ = jparallel.sharded_point_to_plane_icp(mesh, grid_cfg, _jax_map(inp["maps"]["icp"]), src,
                                                      jnp.ones((src.shape[0], src.shape[2]), bool),
                                                      jse3.identity(batch=(B_ICP,)))
    R, t, _, _ = outs[0]["icp"]
    _pose_close(R, t, pose.R, pose.t, 5e-3, 0.1)

    cfg = jlio.LIOConfig(grid=grid_cfg, init_imu_frames=1)
    s0, pts = jlio.create_state(cfg), jnp.asarray(inp["lio"]["pts"])
    xj, _, itj, _ = jparallel.sharded_lio_update(mesh, cfg, _jax_map(inp["maps"]["lio"]), s0.x, s0.P, pts,
                                                 jnp.ones(pts.shape[1], bool))
    x, _, iters, _ = outs[0]["lio"]
    np.testing.assert_allclose(x[0].numpy(), np.asarray(xj.pos), atol=1e-2)
    assert int(iters) == int(itj)

    s2 = inp["s2m"]
    rj = jparallel.sharded_scan_to_map(mesh, js2m.Scan2MapConfig(), _jax_map(inp["maps"]["corner"]),
                                       _jax_map(inp["maps"]["surf"]), jnp.asarray(s2["c"]), jnp.asarray(s2["cm"]),
                                       jnp.asarray(s2["s"]), jnp.asarray(s2["sm"]),
                                       jse3.Pose(jnp.eye(3), jnp.asarray(s2["t"])))
    R, t, _, _, degenerate, _ = outs[0]["s2m"]
    _pose_close(R, t, rj.pose.R, rj.pose.t, 1e-2, 0.1)
    assert bool(degenerate) == bool(rj.degenerate)

    gj = jparallel.sharded_optimize(mesh, cfg_j, g_j)
    Rs, ts, _, _ = outs[0]["backend"]
    n = int(g_j.n)
    np.testing.assert_allclose(ts.numpy()[:n], np.asarray(gj.t)[:n], atol=1e-3)
    np.testing.assert_allclose(Rs.numpy()[:n], np.asarray(gj.R)[:n], atol=1e-3)
