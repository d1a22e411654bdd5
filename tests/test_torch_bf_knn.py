"""Parity of K1's plain PyTorch version (`pointcloud_slam_tpu_torch.ops.bf_knn`)
and of `source_covariances` with the JAX package's Pallas kernel (run in
interpret mode on the CPU, as tests/test_pallas.py runs it) and with the
C++ oracle.

Tolerance: neighbour index sets equal, d2 at rtol 1e-3 / atol 1e-4. The
Pallas kernel expands |q|^2+|p|^2-2q.p and overwrites the 9 low mantissa
bits of d2 with the column index (bf_knn.py:52-58), understating d2 by up
to 2^-14 relative and reordering near-ties; the port computes the direct
difference. The CUDA kernel itself runs only on the card: see
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu import native
from pointcloud_slam_tpu.ops import pallas as jpallas
from pointcloud_slam_tpu.register import vgicp as jvgicp
from pointcloud_slam_tpu_torch.ops import bf_knn
from pointcloud_slam_tpu_torch.register import vgicp as tvgicp

torch.set_num_threads(2)


def _sets_equal(idx_a, idx_b):
    np.testing.assert_array_equal(np.sort(idx_a, axis=0), np.sort(idx_b, axis=0))


@pytest.mark.parametrize("k", [1, 8])
def test_plain_knn_matches_pallas(rng, k):
    db = rng.uniform(-5, 5, size=(3, 1024)).astype(np.float32)
    q = rng.uniform(-5, 5, size=(3, 256)).astype(np.float32)
    dj, ij = jpallas.knn(jnp.asarray(q), jnp.asarray(db), k=k, bq=256, bm=512)
    dt, it = bf_knn.knn(torch.from_numpy(q), torch.from_numpy(db), k=k)
    assert dt.shape == (k, 256) and it.dtype == torch.int32
    _sets_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(np.sort(dt.numpy(), axis=0), np.sort(np.asarray(dj), axis=0), rtol=1e-3, atol=1e-4)
    assert np.all(np.diff(dt.numpy(), axis=0) >= 0), "d2 rows must ascend"


def test_plain_knn_matches_native_oracle(rng):
    """Against the f64 C++ oracle: same sets, d2 at rtol 1e-5 (f32 vs f64)."""
    k = 8
    db = rng.uniform(-5, 5, size=(3, 700)).astype(np.float32)   # ragged sizes: no tile multiple
    q = rng.uniform(-5, 5, size=(3, 300)).astype(np.float32)
    dt, it = bf_knn.knn(torch.from_numpy(q), torch.from_numpy(db), k=k)
    idx_o, d2_o = native.knn(db.T, q.T, k)
    np.testing.assert_array_equal(it.numpy().T, idx_o)
    np.testing.assert_allclose(dt.numpy().T, d2_o, rtol=1e-5, atol=1e-6)


def test_ties_keep_lower_index_and_short_database():
    """Equal distances keep the lower index first; fewer than k points give
    -1 / 3e38 rows (the CUDA kernel's contract)."""
    db = np.array([[1.0, -1.0, 0.0, 1.0], [0, 0, 2, 0], [0, 0, 0, 0]], np.float32)  # 0 and 3 coincide
    q = np.zeros((3, 1), np.float32)
    d2, idx = bf_knn.knn(torch.from_numpy(q), torch.from_numpy(db), k=5)
    np.testing.assert_array_equal(idx[:, 0].numpy(), [0, 1, 3, 2, -1])
    np.testing.assert_allclose(d2[:, 0].numpy(), [1, 1, 1, 4, 3e38], rtol=1e-6)


def test_masked_points_never_selected(rng):
    pts = rng.uniform(-2, 2, size=(3, 300)).astype(np.float32)
    mask = np.ones(300, bool)
    mask[150:] = False
    tp = bf_knn.pad_cloud(torch.from_numpy(pts), torch.from_numpy(mask), 512)
    assert tp.shape == (3, 512)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jpallas.pad_cloud(jnp.asarray(pts), jnp.asarray(mask), 512)))
    d2, idx = bf_knn.knn(tp[:, :150].contiguous(), tp, k=8)
    assert int(idx.max()) < 150, "a masked/padded point was selected as neighbor"


def _near_tie_free(d2_plain_kp1, rel=1e-5):
    """Queries whose k-th and (k+1)-th distances are apart: their k-sets are unique."""
    d = d2_plain_kp1
    return (d[-1] - d[-2]) > rel * np.maximum(d[-1], 1e-12)


@pytest.mark.parametrize("k", [8, 20])
def test_exact_covariances_match_jax(rng, k):
    """source_covariances(method="exact") against JAX at atol 1e-5, on a noisy
    room cloud with masked points; points whose neighbour set is decided by a
    near-tie (within 1e-5 relative) are skipped."""
    from pointcloud_slam_tpu_torch.io import synthetic

    pts = synthetic.make_room_cloud(600, seed=1, size=6.0).T.copy()
    mask = rng.uniform(size=600) < 0.9
    cj = np.asarray(jvgicp.source_covariances(jnp.asarray(pts), jnp.asarray(mask), k=k, method="exact"))
    ct = tvgicp.source_covariances(torch.from_numpy(pts), torch.from_numpy(mask), k=k, method="exact").numpy()
    db = np.where(mask[None], pts, 1e17).astype(np.float32)
    d_kp1, _ = bf_knn.knn(torch.from_numpy(db), torch.from_numpy(db), k=k + 1)
    keep = mask & _near_tie_free(d_kp1.numpy())
    assert keep.sum() > 0.8 * mask.sum()
    np.testing.assert_allclose(ct[:, keep], cj[:, keep], rtol=0, atol=1e-5)


def test_voxel_covariances_match_jax(rng):
    """method="voxel" runs the ported voxel grid (insert + stencil knn);
    k=3 keeps the JAX side's unrolled search quick to compile."""
    from pointcloud_slam_tpu_torch.io import synthetic

    pts = synthetic.make_room_cloud(800, seed=2, size=6.0).T.copy()
    mask = rng.uniform(size=800) < 0.9
    cj = np.asarray(jvgicp.source_covariances(jnp.asarray(pts), jnp.asarray(mask), k=3, resolution=0.5))
    ct = tvgicp.source_covariances(torch.from_numpy(pts), torch.from_numpy(mask), k=3, resolution=0.5).numpy()
    np.testing.assert_allclose(ct[:, mask], cj[:, mask], rtol=0, atol=1e-5)
