"""Exact brute-force k-NN and 1-NN — kernels K1 and K2 (port of
`pointcloud_slam_tpu/ops/pallas/bf_knn.py`).

On CUDA tensors `knn` (K1) and `nearest_neighbor` (K2) launch the
hand-written Hopper kernel `csrc/bf_knn.cu` (built with nvcc at first use,
bound with ctypes; K2 is its k = 1 instance behind its own entry point);
on CPU tensors they run `knn_plain` / `nearest_neighbor_plain`, the plain
PyTorch versions. There is no fallback from one to the other: a CUDA call
that cannot build or launch raises.

Differences from the TPU kernel, both deliberate: d2 is the direct
difference (q-p).(q-p) (the TPU kernel expands |q|^2+|p|^2-2q.p and packs
the column index into 9 low mantissa bits), and N, M need not be tile
multiples. `pad_cloud` is kept for API parity: its far-point convention is
how callers mask points.
"""

from __future__ import annotations

import torch

from . import _cuda

KERNEL_KS = (1, 5, 8, 20)  # k values the CUDA kernel is instantiated for
_INF = 3.0e38
_FAR = 1.0e17
_CHUNK = 1024  # queries per d2 block in the plain version


def pad_cloud(points: torch.Tensor, mask: torch.Tensor, multiple: int):
    """Pad (3, N) to a multiple of `multiple` columns; masked/padded points are
    moved far outside any scene so they are never selected as neighbors.
    (The CUDA kernel needs no padding: multiple=1 just applies the mask.)"""
    N = points.shape[1]
    Np = -(-N // multiple) * multiple
    pts = torch.where(mask[None, :], points, _FAR)
    if Np != N:
        pts = torch.cat([pts, torch.full((3, Np - N), _FAR, dtype=points.dtype, device=points.device)], dim=1)
    return pts


def knn_plain(queries: torch.Tensor, database: torch.Tensor, k: int = 8):
    """Plain PyTorch exact k-NN: direct-difference d2 over query chunks, then
    torch.topk. Output ordered by ascending d2, ties by lower index.
    queries (3, N), database (3, M) -> (d2 (k, N), idx (k, N) int32);
    -1 / 3e38 where the database holds fewer than k points."""
    N, M = queries.shape[1], database.shape[1]
    kk = min(k, M)
    d2_out = torch.full((k, N), _INF, dtype=torch.float32, device=queries.device)
    idx_out = torch.full((k, N), -1, dtype=torch.int32, device=queries.device)
    for s in range(0, N, _CHUNK):
        q = queries[:, s:s + _CHUNK]
        d2 = ((q[0][:, None] - database[0][None, :]) ** 2
              + (q[1][:, None] - database[1][None, :]) ** 2
              + (q[2][:, None] - database[2][None, :]) ** 2)           # (n, M)
        vals, idx = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
        # deterministic tie order: by index, then stably by distance
        by_idx = torch.argsort(idx, dim=1)
        vals, idx = torch.gather(vals, 1, by_idx), torch.gather(idx, 1, by_idx)
        by_d2 = torch.argsort(vals, dim=1, stable=True)
        d2_out[:kk, s:s + _CHUNK] = torch.gather(vals, 1, by_d2).T
        idx_out[:kk, s:s + _CHUNK] = torch.gather(idx, 1, by_d2).T.to(torch.int32)
    return d2_out, idx_out


def _check_cuda_inputs(queries: torch.Tensor, database: torch.Tensor, rows: int):
    """The kernels take contiguous float32 (3, n) clouds on one CUDA device,
    small enough for 32-bit indexing (`rows` output rows per query)."""
    for name, t in (("queries", queries), ("database", database)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 (3, n) tensor, "
                             f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
    N, M = queries.shape[1], database.shape[1]
    if max(3 * N, 3 * M, rows * N) >= 2 ** 31:
        raise ValueError("clouds too large for the kernel's 32-bit indexing")


def _device_of(queries: torch.Tensor, database: torch.Tensor) -> str:
    if queries.device != database.device:
        raise ValueError(f"queries on {queries.device}, database on {database.device}")
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {queries.device}")
    return queries.device.type


def knn(queries: torch.Tensor, database: torch.Tensor, k: int = 8, bq: int = 256, bm: int = 512):
    """Exact brute-force k-NN: queries (3, N), database (3, M) ->
    (d2 (k, N) ascending, idx (k, N) int32).

    `bq`/`bm` are the TPU kernel's tile sizes, accepted for signature parity;
    the CUDA kernel masks ragged edges itself and takes any N, M.
    Counts its CUDA launches in `knn.launches`."""
    if _device_of(queries, database) == "cpu":
        return knn_plain(queries, database, k)
    _check_cuda_inputs(queries, database, k)
    if k not in KERNEL_KS:
        raise ValueError(f"k={k} has no CUDA kernel instance (built for {KERNEL_KS})")
    N, M = queries.shape[1], database.shape[1]
    d2 = torch.empty((k, N), dtype=torch.float32, device=queries.device)
    idx = torch.empty((k, N), dtype=torch.int32, device=queries.device)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _cuda.library().pcs_bf_knn(queries.data_ptr(), N, database.data_ptr(), M, k,
                                          d2.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bf_knn kernel launch failed: cudaError {err}")
    knn.launches += 1
    return d2, idx


knn.launches = 0


def nearest_neighbor_plain(queries: torch.Tensor, database: torch.Tensor):
    """Plain PyTorch exact 1-NN: direct-difference d2 over query chunks, then
    a min over the database (the first, i.e. lowest, index among equal
    distances). queries (3, N), database (3, M) -> (d2 (N,), idx (N,) int32)."""
    N = queries.shape[1]
    d2_out = torch.full((N,), _INF, dtype=torch.float32, device=queries.device)
    idx_out = torch.full((N,), -1, dtype=torch.int32, device=queries.device)
    if database.shape[1] == 0:
        return d2_out, idx_out
    for s in range(0, N, _CHUNK):
        q = queries[:, s:s + _CHUNK]
        d2 = ((q[0][:, None] - database[0][None, :]) ** 2
              + (q[1][:, None] - database[1][None, :]) ** 2
              + (q[2][:, None] - database[2][None, :]) ** 2)           # (n, M)
        vals, idx = torch.min(d2, dim=1)
        d2_out[s:s + _CHUNK] = vals
        idx_out[s:s + _CHUNK] = idx.to(torch.int32)
    return d2_out, idx_out


def nearest_neighbor(queries: torch.Tensor, database: torch.Tensor, bq: int = 256, bm: int = 512):
    """Exact 1-NN: queries (3, N), database (3, M) -> (d2 (N,), idx (N,) int32),
    the lower index on ties. d2 is the direct difference, never negative
    (the TPU kernel clamps its expanded form at 0).

    `bq`/`bm` are the TPU kernel's tile sizes, accepted for signature parity
    and ignored. Counts its CUDA launches in `nearest_neighbor.launches`."""
    if _device_of(queries, database) == "cpu":
        return nearest_neighbor_plain(queries, database)
    _check_cuda_inputs(queries, database, 1)
    N, M = queries.shape[1], database.shape[1]
    d2 = torch.empty((N,), dtype=torch.float32, device=queries.device)
    idx = torch.empty((N,), dtype=torch.int32, device=queries.device)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _cuda.library().pcs_bf_nn(queries.data_ptr(), N, database.data_ptr(), M,
                                         d2.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nearest_neighbor kernel launch failed: cudaError {err}")
    nearest_neighbor.launches += 1
    return d2, idx


nearest_neighbor.launches = 0
