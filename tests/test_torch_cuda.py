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


@pytest.mark.parametrize("k", bf_knn.KERNEL_KS)
@pytest.mark.parametrize("n,m", [(1, 5), (300, 700), (1500, 2049)])
def test_bf_knn_kernel_matches_plain(cuda, k, n, m):
    """Ragged sizes (no tile multiples), k > M included: d2 at rtol 1e-5 /
    atol 1e-6 (FMA vs separate multiply-add), index sets equal away from
    near-ties, rows ascending, launches counted."""
    g = np.random.default_rng(k * 1000 + n)
    q = torch.from_numpy(g.uniform(-5, 5, size=(3, n)).astype(np.float32)).to(cuda)
    db = torch.from_numpy(g.uniform(-5, 5, size=(3, m)).astype(np.float32)).to(cuda)
    before = bf_knn.knn.launches
    d2, idx = bf_knn.knn(q, db, k=k)
    torch.cuda.synchronize()
    assert bf_knn.knn.launches == before + 1
    pd2, pidx = bf_knn.knn_plain(q, db, k=k + 1)
    torch.testing.assert_close(d2, pd2[:k], rtol=1e-5, atol=1e-6)
    assert bool((d2[1:] >= d2[:-1]).all())
    if m > k:
        clear = (pd2[k] - pd2[k - 1]) > 1e-6 * pd2[k]
        same = (torch.sort(idx, 0).values == torch.sort(pidx[:k], 0).values).all(0)
        assert bool(same[clear].all())
    else:  # fewer database points than k: the tail is -1 / 3e38
        assert bool((idx[m:] == -1).all()) and bool((d2[m:] > 1e38).all())


def test_bf_knn_kernel_ties_and_masking(cuda):
    db = torch.tensor([[1.0, -1.0, 0.0, 1.0], [0, 0, 2, 0], [0, 0, 0, 0]], device=cuda)
    d2, idx = bf_knn.knn(torch.zeros(3, 1, device=cuda), db, k=5)
    assert idx[:, 0].tolist() == [0, 1, 3, 2, -1]
    pts = torch.rand(3, 600, device=cuda)
    mask = torch.arange(600, device=cuda) < 300
    far = bf_knn.pad_cloud(pts, mask, 1)
    _, idx = bf_knn.knn(far[:, :300].contiguous(), far, k=8)
    assert int(idx.max()) < 300


def test_bf_knn_wrapper_rejects(cuda):
    q = torch.rand(3, 10, device=cuda)
    with pytest.raises(ValueError):
        bf_knn.knn(q, q, k=7)                        # no instance for k=7
    with pytest.raises(ValueError):
        bf_knn.knn(q.double(), q.double(), k=8)      # dtype
    with pytest.raises(ValueError):
        bf_knn.knn(q.T.contiguous().T, q, k=8)       # not contiguous
    with pytest.raises(ValueError):
        bf_knn.knn(q, q.cpu(), k=8)                  # devices differ


@pytest.mark.parametrize("n,m", [(1, 5), (300, 700), (1500, 2049)])
def test_nearest_neighbor_kernel_matches_plain(cuda, n, m):
    """K2 at ragged sizes: d2 at rtol 1e-5 / atol 1e-6 (FMA against separate
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
