"""Parity of the port's voxel-hash map and downsampling
(`pointcloud_slam_tpu_torch.ops`) with the JAX package's, on the same numpy
inputs. Maps are compared through what they answer (k-NN results, stored
point multisets), never slot by slot: same-batch claim races pick other
winners on the two sides.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu import ops as jops
from pointcloud_slam_tpu.ops import voxel_grid as jvg
from pointcloud_slam_tpu_torch import convert, ops as tops
from pointcloud_slam_tpu_torch.ops import voxel_grid as tvg

torch.set_num_threads(2)

# the tuned LIO map shape (small blocks, probe 4) and a baked map; one
# config and one query count per mode, so the JAX side compiles knn once
UNBAKED = dict(capacity=1 << 15, pts_per_voxel=3, resolution=0.5, nearby=7, probe=4)
BAKED = dict(capacity=1 << 16, pts_per_voxel=8, resolution=0.5, nearby=7, baked=True)
NQ = 400


def _cloud(rng, n, lo=-4.0, hi=4.0):
    return rng.uniform(lo, hi, size=(3, n)).astype(np.float32)


def _jax_grid(cfg_kw, pts):
    cfg = jops.GridConfig(**cfg_kw)
    g = jops.insert(cfg, jops.create(cfg), jnp.asarray(pts), jnp.ones(pts.shape[1], bool))
    return cfg, g


def test_hash_and_fingerprint_bit_exact(rng):
    """uint32 arithmetic reproduced in int64: equal bits for negative,
    extreme and ordinary coordinates."""
    c = rng.integers(-2 ** 31, 2 ** 31, size=(3, 4096), dtype=np.int64).astype(np.int32)
    c[:, :3] = [[-1, 0, 2 ** 31 - 1], [-2 ** 31, 1, -7], [0, -1, 123456]]
    c[:, 3:1000] = rng.integers(-200, 200, size=(3, 997))
    jc, tc = jnp.asarray(c), torch.from_numpy(c)
    for cap in (1 << 12, 1 << 16):
        np.testing.assert_array_equal(tvg._hash3(*tc, cap).numpy(), np.asarray(jvg._hash3(*jc, cap)))
    np.testing.assert_array_equal(tvg._fingerprint(*tc).numpy(), np.asarray(jvg._fingerprint(*jc)).astype(np.int64))


@pytest.mark.parametrize("cfg_kw", [UNBAKED, BAKED], ids=["unbaked", "baked"])
def test_knn_on_carried_grid(rng, cfg_kw, k=5):
    """knn on a JAX-built map carried over by convert: neighbour xyz, d2 and
    count equal (atol 1e-6: same probe, same candidates, same f32 formula),
    and the flat indices equal."""
    cfg, g = _jax_grid(cfg_kw, _cloud(rng, 1500))
    q = _cloud(rng, NQ, -4.5, 4.5)
    nj, dj, cj, ij = jops.knn(cfg, g, jnp.asarray(q), k=k, max_range=1.0)
    tg = convert.grid_from_numpy(jax.tree.map(np.asarray, g), device="cpu")
    nt, dt, ct, it = tops.knn(tops.GridConfig(**cfg_kw), tg, torch.from_numpy(q), k=k, max_range=1.0)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert int(ct.min()) < k < int(ct.max()) + 1  # both partial and full neighbour lists occur
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def _stored(grid):
    """Sorted (M, 3) multiset of the points a map holds."""
    g = convert.to_numpy(grid) if isinstance(grid, tvg.VoxelHashMap) else jax.tree.map(np.asarray, grid)
    K = g.pts.shape[1]
    live = np.arange(K)[:, None] < np.minimum(g.npts, K)[None, :]
    pts = g.pts.transpose(1, 2, 0)[live]
    return pts[np.lexsort(pts.T[::-1])]


@pytest.mark.parametrize("cfg_kw", [UNBAKED, BAKED], ids=["unbaked", "baked"])
def test_insert_matches_through_knn(rng, cfg_kw):
    """Three insert batches at load < 0.1 into fresh maps on both sides: the
    stored point multisets are equal (per-voxel overflow drops follow batch
    order on both sides) and k-NN answers on fresh queries agree."""
    jcfg, tcfg = jops.GridConfig(**cfg_kw), tops.GridConfig(**cfg_kw)
    jg, tg = jops.create(jcfg), tops.create(tcfg, device="cpu")
    for b in range(3):
        pts = _cloud(rng, 700)
        pts[:, :50] = pts[:, 50:51] + rng.uniform(0, 0.05, size=(3, 50))  # one crowded voxel: overflow drops
        mask = rng.uniform(size=700) < 0.9
        jg = jops.insert(jcfg, jg, jnp.asarray(pts), jnp.asarray(mask))
        tg = tops.insert(tcfg, tg, torch.from_numpy(pts), torch.from_numpy(mask))
    assert int(tops.num_voxels(tg)) < 0.1 * cfg_kw["capacity"]
    assert int(tops.num_voxels(tg)) == int(jops.num_voxels(jg))
    np.testing.assert_array_equal(_stored(tg), _stored(jg))
    q = _cloud(rng, NQ, -4.5, 4.5)
    nj, dj, cj, _ = jops.knn(jcfg, jg, jnp.asarray(q), k=5, max_range=1.0)
    nt, dt, ct, _ = tops.knn(tcfg, tg, torch.from_numpy(q), k=5, max_range=1.0)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-6)


def test_lookup_and_counts(rng):
    pts = _cloud(rng, 600)
    cfg = tops.GridConfig(**dict(UNBAKED, pts_per_voxel=8))
    g = tops.insert(cfg, tops.create(cfg, device="cpu"), torch.from_numpy(pts), torch.ones(600, dtype=torch.bool))
    coords = tops.point_to_voxel(torch.from_numpy(pts), cfg.resolution)
    slots = tops.lookup(cfg, g, coords)
    assert bool((slots >= 0).all())
    np.testing.assert_array_equal(g.keys[:, slots].numpy(), coords.numpy())
    n_vox = len(np.unique(coords.numpy(), axis=1).T)
    assert int(tops.num_voxels(g)) == n_vox
    assert int(g.npts.sum()) == 600 - int(np.maximum(np.unique(coords.numpy(), axis=1, return_counts=True)[1] - 8, 0).sum())
    absent = tops.lookup(cfg, g, torch.full((3, 4), 999, dtype=torch.int32))
    assert bool((absent == -1).all())


def _as_set(pts, mask):
    p = np.asarray(pts)[:, np.asarray(mask)].T
    return p[np.lexsort(p.T[::-1])]


def _ds_input(rng, n=3000):
    pts = _cloud(rng, n, -3.0, 3.0)
    pts[:, : n // 4] = np.round(pts[:, : n // 4], 1)  # duplicates and points on voxel faces
    mask = rng.uniform(size=n) < 0.8
    return pts, mask


def test_voxel_downsample_as_sets(rng):
    """Centroids compared as sets: the sums run in another order (atol 1e-6)."""
    pts, mask = _ds_input(rng)
    pj, mj = jops.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), 0.3)
    pt, mt = tops.voxel_downsample(torch.from_numpy(pts), torch.from_numpy(mask), 0.3)
    assert int(mt.sum()) == int(np.asarray(mj).sum())
    np.testing.assert_allclose(_as_set(pt.numpy(), mt.numpy()), _as_set(pj, mj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("budget", [4096, 512], ids=["fits", "truncates"])
def test_voxel_downsample_compact_as_sets(rng, budget):
    pts, mask = _ds_input(rng)
    pj, mj = jops.voxel_downsample_compact(jnp.asarray(pts), jnp.asarray(mask), 0.3, budget)
    pt, mt = tops.voxel_downsample_compact(torch.from_numpy(pts), torch.from_numpy(mask), 0.3, budget)
    assert pt.shape == pj.shape and int(mt.sum()) == int(np.asarray(mj).sum())
    np.testing.assert_allclose(_as_set(pt.numpy(), mt.numpy()), _as_set(pj, mj), rtol=0, atol=1e-6)


def test_compact(rng):
    pts = _cloud(rng, 1000)
    mask = rng.uniform(size=1000) < 0.3
    for budget in (512, 200):
        pj, mj = jops.compact(jnp.asarray(pts), jnp.asarray(mask), budget)
        pt, mt = tops.compact(torch.from_numpy(pts), torch.from_numpy(mask), budget)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        np.testing.assert_array_equal(pt.numpy()[:, mt.numpy()], np.asarray(pj)[:, np.asarray(mj)])
