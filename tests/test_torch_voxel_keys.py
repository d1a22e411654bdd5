"""Voxel keys of points on voxel bounds: the port against jitted JAX.

Jitted XLA folds the JAX package's division by the constant resolution into
a product with its float32 reciprocal; eager JAX divides. On a bound, or one
float32 ulp either side of it, the two forms put a point in different
voxels. The port multiplies by `recip32(resolution)` on every device, so its
keys are the ones jitted JAX computes: standalone, inside `insert` and inside
`knn`. The neighbours of 0 are ±1e-6 m here: one ulp either side of 0 is a
denormal, which XLA's CPU backend flushes to zero.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu import ops as jops
from pointcloud_slam_tpu.models.liosam import projection as jproj
from pointcloud_slam_tpu.ops import voxel_grid as jvg
from pointcloud_slam_tpu_torch import ops as tops
from pointcloud_slam_tpu_torch.models.liosam import projection as tproj

torch.set_num_threads(2)

RESOLUTIONS = [0.2, 0.3, 0.4, 0.5, 1.0, 2.0]


def _bound_points(res):
    """(3, 363): the bounds k * res for k in [-60, 60] and one ulp either side,
    the three rows permuted so that the points spread over many voxels."""
    ks = np.arange(-60, 61)
    b = (ks * np.float32(res)).astype(np.float32)
    up, dn = np.nextafter(b, np.float32(np.inf)), np.nextafter(b, np.float32(-np.inf))
    up[ks == 0], dn[ks == 0] = 1e-6, -1e-6
    x = np.concatenate([b, up, dn]).astype(np.float32)
    return np.stack([x, x[::-1], np.roll(x, 7)])


@pytest.mark.parametrize("res", RESOLUTIONS)
def test_point_to_voxel_matches_jitted_jax(res):
    pts = _bound_points(res)
    port = tops.point_to_voxel(torch.from_numpy(pts), res).numpy()
    jitted = np.asarray(jax.jit(lambda p: jvg.point_to_voxel(p, res))(jnp.asarray(pts)))
    np.testing.assert_array_equal(port, jitted)
    np.testing.assert_array_equal(port, np.floor(pts * (np.float32(1) / np.float32(res))).astype(np.int32))
    eager = np.asarray(jvg.point_to_voxel(jnp.asarray(pts), res))
    # eager JAX divides: it parts from the jitted form on bounds wherever the
    # reciprocal is inexact (not at the powers of two)
    assert (eager != jitted).any() == (res in (0.2, 0.3, 0.4)), res


@pytest.mark.parametrize("res", RESOLUTIONS)
def test_insert_and_knn_keys_match_jitted_jax(res):
    """The voxels `insert` files boundary points under, and the voxel `knn`
    looks a boundary query up in (one-voxel stencil over a map of voxel
    centres), equal to jitted JAX's."""
    pts = _bound_points(res)
    n = pts.shape[1]
    cfg_j = jops.GridConfig(capacity=1 << 12, pts_per_voxel=4, resolution=res, nearby=1, claim_rounds=4)
    cfg_t = tops.GridConfig(capacity=1 << 12, pts_per_voxel=4, resolution=res, nearby=1, claim_rounds=4)
    gj = jax.jit(lambda p, m: jops.insert(cfg_j, jops.create(cfg_j), p, m))(jnp.asarray(pts), jnp.ones(n, bool))
    gt = tops.insert(cfg_t, tops.create(cfg_t, device="cpu"), torch.from_numpy(pts), torch.ones(n, dtype=torch.bool))
    keys_j = {tuple(c) for c in np.asarray(gj.keys)[:, np.asarray(gj.occupied)].T}
    keys_t = {tuple(c) for c in gt.keys[:, gt.occupied].numpy().T}
    assert keys_t == keys_j and len(keys_t) > 200

    # a map of voxel centres: the neighbour a query finds names its voxel
    cells = np.unique(np.floor(pts * (np.float32(1) / np.float32(res))).astype(np.int64), axis=1)
    cells = np.unique(np.concatenate([cells + d for d in (-1, 0, 1)], axis=1), axis=1)
    centres = ((cells + 0.5) * res).astype(np.float32)
    m = centres.shape[1]
    cfg_j = jops.GridConfig(capacity=1 << 14, pts_per_voxel=2, resolution=res, nearby=1, claim_rounds=4)
    cfg_t = tops.GridConfig(capacity=1 << 14, pts_per_voxel=2, resolution=res, nearby=1, claim_rounds=4)
    mj = jops.insert(cfg_j, jops.create(cfg_j), jnp.asarray(centres), jnp.ones(m, bool))
    mt = tops.insert(cfg_t, tops.create(cfg_t, device="cpu"), torch.from_numpy(centres), torch.ones(m, dtype=torch.bool))
    nj, _, cj, _ = jax.jit(lambda g, q: jops.knn(cfg_j, g, q, k=1, max_range=10.0 * res))(mj, jnp.asarray(pts))
    nt, _, ct, _ = tops.knn(cfg_t, mt, torch.from_numpy(pts), k=1, max_range=10.0 * res)
    assert (np.asarray(cj) == 1).all() and (ct.numpy() == 1).all()
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


def test_projection_columns_match_jitted_jax():
    """Range-image columns of points at the column bounds' azimuths (and one
    ulp of the coordinates off them): the port's equal jitted JAX's wherever
    the two `atan2`s agree to the bit (XLA's and PyTorch's differ by an ulp
    on ~12 % of these points, which moves a bound point either way)."""
    H = 1800
    ang = (math.pi - 2.0 * math.pi * np.arange(H) / H).astype(np.float32)
    xy = np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32) * np.float32(10.0)
    xy = np.concatenate([xy, np.nextafter(xy, np.float32(np.inf)), np.nextafter(xy, np.float32(-np.inf))], axis=1)
    pts = np.concatenate([xy, np.zeros((1, xy.shape[1]), np.float32)]).astype(np.float32)
    rows = np.zeros(pts.shape[1], np.int32)
    mask = np.ones(pts.shape[1], bool)
    jc = jproj.ProjectionConfig(n_scan=16, horizon=H)
    tc = tproj.ProjectionConfig(n_scan=16, horizon=H)
    cj = jax.jit(lambda p, m, r: jproj.project(jc, p, m, rows=r).col)(jnp.asarray(pts), jnp.asarray(mask),
                                                                     jnp.asarray(rows))
    ct = tproj.project(tc, torch.from_numpy(pts), torch.from_numpy(mask), rows=torch.from_numpy(rows)).col
    same_ang = np.asarray(jax.jit(lambda p: jnp.arctan2(p[1], p[0]))(jnp.asarray(pts))) == torch.atan2(
        torch.from_numpy(pts[1]), torch.from_numpy(pts[0])).numpy()
    assert same_ang.sum() > 4000
    np.testing.assert_array_equal(ct.numpy()[same_ang], np.asarray(cj)[same_ang])
