"""Parity of the port's PHC ops (`pointcloud_slam_tpu_torch.ops.phc`) and
LIO's PHC node mode with the JAX package's, on the same numpy inputs.

Hilbert indices and their inverse are equal bit for bit for every order from
1 to 10; `phc_merge` (both output modes) and `phc_sort` give the same columns
as JAX, and centroids equal to 1e-6 m (the segment sums run in the same
order; one float32 ulp at these coordinates is < 5e-7 m). The cases of
tests/test_phc.py run on the port. Frame by frame against jitted JAX is
behind --heavy.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu import ops as jops
from pointcloud_slam_tpu.io import synthetic as jsyn
from pointcloud_slam_tpu.models import lio as jlio
from pointcloud_slam_tpu.ops import phc as jphc
from pointcloud_slam_tpu_torch import convert, ops as tops
from pointcloud_slam_tpu_torch.io import synthetic as tsyn
from pointcloud_slam_tpu_torch.models import lio as tlio
from pointcloud_slam_tpu_torch.ops import phc

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _full_cube(order):
    n = 1 << order
    return np.mgrid[0:n, 0:n, 0:n].reshape(3, -1).astype(np.int64)


@pytest.mark.parametrize("order", range(1, 11))
def test_hilbert_index_bit_equal_to_jax(order):
    """Random coords plus the cube's corners and edges: index and inverse equal
    JAX's uint32 results bit for bit."""
    rng = np.random.default_rng(order)
    n = 1 << order
    g = rng.integers(0, n, size=(3, 3000))
    corners = np.array(np.meshgrid([0, n - 1], [0, n - 1], [0, n - 1])).reshape(3, -1)
    g = np.concatenate([g, corners, np.stack([np.arange(n)] * 3)], axis=1)
    if order <= 4:
        g = np.concatenate([g, _full_cube(order)], axis=1)
    hj = np.asarray(jphc.hilbert_index(jnp.asarray(g.astype(np.uint32)), order)).astype(np.int64)
    ht = phc.hilbert_index(_t(g), order).numpy()
    np.testing.assert_array_equal(ht, hj)
    hs = rng.integers(0, 8 ** order, size=3000)
    cj = np.asarray(jphc.hilbert_coords(jnp.asarray(hs.astype(np.uint32)), order)).astype(np.int64)
    np.testing.assert_array_equal(phc.hilbert_coords(_t(hs), order).numpy(), cj)


def test_hilbert_bijective_adjacent_and_nested():
    """tests/test_phc.py's curve properties on the port."""
    for order in (1, 2, 3):
        g = _full_cube(order)
        h = phc.hilbert_index(_t(g), order).numpy()
        assert sorted(h.tolist()) == list(range(8 ** order))
        pos = np.empty((8 ** order, 3), np.int64)
        pos[h] = g.T
        assert np.all(np.abs(np.diff(pos, axis=0)).sum(axis=1) == 1)
    for order in (2, 4, 7):
        rng = np.random.default_rng(order)
        g = rng.integers(0, 1 << order, size=(3, 500))
        np.testing.assert_array_equal(phc.hilbert_coords(phc.hilbert_index(_t(g), order), order).numpy(), g)
    order = 4
    g = np.random.default_rng(0).integers(0, 1 << order, size=(3, 1000))
    h = phc.hilbert_index(_t(g), order).numpy()
    np.testing.assert_array_equal(h >> (3 * (order - 1)), phc.hilbert_index(_t(g >> (order - 1)), 1).numpy())


def test_phc_merge_centroids_and_density():
    pts = np.array([[0.10, 0.10, 0.10], [0.20, 0.15, 0.05], [0.60, 0.60, 0.60], [0.10, 0.10, 0.10],
                    [1.30, 0.10, 0.10]], np.float32).T
    mask = np.array([True, True, True, False, True])
    out, om = phc.phc_merge(_t(pts), _t(mask), 1.0, 2)
    out, om = out.numpy(), om.numpy()
    assert om.sum() == 3
    np.testing.assert_allclose(sorted(out[:, om].T.tolist()),
                               sorted([[0.15, 0.125, 0.075], [0.60, 0.60, 0.60], [1.30, 0.10, 0.10]]), atol=1e-6)
    pts = np.random.default_rng(1).uniform(0, 1, size=(3, 4000)).astype(np.float32)
    _, om = phc.phc_merge(_t(pts), torch.ones(4000, dtype=torch.bool), 1.0, 2)
    assert 0 < int(om.sum()) <= 64


def _cloud(seed, n, lo=-6.0, hi=6.0, p_mask=0.85):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, size=(3, n)).astype(np.float32)
    pts[:, : n // 3] = pts[:, n // 3: 2 * (n // 3)] + rng.normal(scale=0.02, size=(3, n // 3)).astype(np.float32)
    return pts, rng.random(n) < p_mask


@pytest.mark.parametrize("res,order", [(1.0, 1), (0.4, 2), (0.5, 3), (0.3, 5)])
def test_phc_merge_and_sort_match_jax(res, order):
    """Both output modes of phc_merge and phc_sort against JAX with the
    resolution a constant of the jitted program (as lio_step calls it)."""
    pts, mask = _cloud(order, 3000)
    jp, jm = jnp.asarray(pts), jnp.asarray(mask)
    for curve in (False, True):
        oj, mj = jax.jit(lambda p, m: jphc.phc_merge(p, m, res, order, curve_output=curve))(jp, jm)
        ot, mt = phc.phc_merge(_t(pts), _t(mask), res, order, curve_output=curve)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        np.testing.assert_allclose(ot.numpy()[:, mt.numpy()], np.asarray(oj)[:, np.asarray(mj)], atol=1e-6, rtol=0)
        assert 100 < int(mt.sum()) < int(mask.sum())
    sj, smj = jax.jit(lambda p, m: jphc.phc_sort(p, m, res, order))(jp, jm)
    st, smt = phc.phc_sort(_t(pts), _t(mask), res, order)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(smt.numpy(), np.asarray(smj))


def test_phc_curve_output_packs_and_drives_the_map():
    """tests/test_phc.py's curve-output and insert cases on the port: the packed
    output holds the same centroids as the scattered one, in voxel order, and
    a map built from it answers every query within the sub-cube diagonal."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-2, 2, size=(3, 600)).astype(np.float32)
    mask = rng.random(600) < 0.85
    out_s, om_s = phc.phc_merge(_t(pts), _t(mask), 1.0, 2)
    out_c, om_c = phc.phc_merge(_t(pts), _t(mask), 1.0, 2, curve_output=True)
    out_s, om_s, out_c, om_c = (x.numpy() for x in (out_s, om_s, out_c, om_c))
    n = om_s.sum()
    assert om_c.sum() == n and om_c[:n].all() and not om_c[n:].any()
    assert sorted(map(tuple, np.round(out_c[:, :n].T, 5).tolist())) == sorted(
        map(tuple, np.round(out_s[:, om_s].T, 5).tolist()))
    keys = list(map(tuple, np.floor(out_c[:, :n]).astype(np.int64).T.tolist()))
    assert keys == sorted(keys)

    pts = rng.uniform(0, 4, size=(3, 800)).astype(np.float32)
    cfg = tops.GridConfig(capacity=1 << 10, pts_per_voxel=8, resolution=1.0, nearby=7)
    merged, mm = phc.phc_merge(_t(pts), torch.ones(800, dtype=torch.bool), 1.0, 1, curve_output=True)
    grid = tops.insert(cfg, tops.create(cfg, device="cpu"), merged, mm)
    _, d2, cnt, _ = tops.knn(cfg, grid, _t(pts[:, :64]), k=1, max_range=2.0)
    assert int(cnt.min()) >= 1 and float(d2[0].max()) <= 3.0 * 0.25 + 1e-5


N_FRAMES = 15


def _phc_cfg(lib):
    return lib.LIOConfig(grid=lib_ops(lib).GridConfig(capacity=1 << 15, pts_per_voxel=8, resolution=0.4, nearby=7),
                         scan_leaf=0.3, map_leaf=0.3, init_imu_frames=2, phc_order=2)


def lib_ops(lib):
    return jops if lib is jlio else tops


def test_lio_phc_node_tracks():
    """tests/test_lio.py's PHC node case on the port: 15 frames, final error
    < 0.25 m (its gate), mean < 0.2 m."""
    cfg = _phc_cfg(tlio)
    _, _, frames = tsyn.simulate_lio_sequence(n_frames=N_FRAMES, device="cpu")
    s = tlio.create_state(cfg, device="cpu")
    errs = []
    for k, (fr, gt_pos, _) in enumerate(frames):
        s, out = tlio.lio_step(cfg, s, fr)
        if k >= 5:
            errs.append(np.linalg.norm(out.pos.numpy() - (gt_pos - frames[0][1])))
    assert errs[-1] < 0.25 and np.mean(errs) < 0.2, errs


@pytest.mark.heavy
def test_lio_phc_node_frame_by_frame_against_jax():
    """The same run beside jitted JAX, as tests/test_torch_lio.py holds the
    linear node: started each frame from the JAX state (carried over by
    convert), the port's step lands within 1 cm of JAX's, but for the first
    update after the IMU init (frame 2: a one-scan map, the ill-conditioned
    plane fits of ROADMAP §3), within 2 cm; the linear node at this config is
    1.43 cm apart there too. Run freely, the trajectories stay within 3 cm."""
    jcfg, tcfg = _phc_cfg(jlio), _phc_cfg(tlio)
    _, _, jframes = jsyn.simulate_lio_sequence(n_frames=N_FRAMES)
    _, _, tframes = tsyn.simulate_lio_sequence(n_frames=N_FRAMES, device="cpu")
    step = jax.jit(lambda s, f: jlio.lio_step(jcfg, s, f))
    sj, st = jlio.create_state(jcfg), tlio.create_state(tcfg, device="cpu")
    step_err, free_err = [], []
    for (fj, _, _), (ft, _, _) in zip(jframes, tframes):
        _, o1 = tlio.lio_step(tcfg, convert.lio_state_from_numpy(jax.tree.map(np.asarray, sj), device="cpu"),
                              convert.frame_from_numpy(jax.tree.map(np.asarray, fj), device="cpu"))
        sj, oj = step(sj, fj)
        st, ot = tlio.lio_step(tcfg, st, ft)
        step_err.append(np.abs(o1.pos.numpy() - np.asarray(oj.pos)).max())
        free_err.append(np.abs(ot.pos.numpy() - np.asarray(oj.pos)).max())
    assert step_err[2] < 0.02 and max(step_err[:2] + step_err[3:]) < 0.01, np.round(step_err, 4)
    assert max(free_err) < 0.03, np.round(free_err, 4)


def test_mapping_app_reads_ivox_node_phc_order(tmp_path):
    """`ivox_node_phc_order` in a per-lidar YAML turns the PHC node on in both
    mapping apps' configurations alike (the port's app refused it before)."""
    import argparse
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    yaml = tmp_path / "phc.yaml"
    yaml.write_text(open(os.path.join(root, "configs", "lio", "velodyne.yaml")).read()
                    + "\nivox_node_phc_order: 2\nivox_grid_resolution: 0.4\n")
    cfgs = []
    for rel in ("apps/run_mapping_offline.py", "apps/run_mapping_offline_torch.py"):
        spec = importlib.util.spec_from_file_location(os.path.basename(rel)[:-3] + "_phc", os.path.join(root, rel))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        cfgs.append(mod.build_config(argparse.Namespace(config_file=str(yaml))))
    (cj, ct) = cfgs
    assert cj.phc_order == ct.phc_order == 2 and ct.grid.resolution == cj.grid.resolution == 0.4
    assert ct.scan_leaf == cj.scan_leaf and ct.max_iterations == cj.max_iterations
