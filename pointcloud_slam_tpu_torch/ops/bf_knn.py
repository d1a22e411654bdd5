"""Exact brute-force k-NN and 1-NN — kernels K1 and K2 (port of
`pointcloud_slam_tpu/ops/pallas/bf_knn.py`).

On CUDA tensors `knn` (K1) and `nearest_neighbor` (K2) launch the
hand-written Hopper kernel `csrc/bf_knn.cu` (built with nvcc at first use,
bound with ctypes; K2 is its k = 1 instance behind its own entry point);
on CPU tensors they run `knn_plain` / `nearest_neighbor_plain`, the plain
PyTorch versions. There is no fallback from one to the other: a CUDA call
that cannot build or launch raises.

The kernel is two passes. `plan` picks, from the shapes alone, the list
length the search is instantiated for (k rounded up to the next of
`_INSTANCES`) and S contiguous ranges of the database (4 to 16: the four
warps of a block take one each); each range's sorted top-k goes to an
(S, k, N) scratch and a merge pass picks the k least by (d2, idx).
`knn_plain_split` is the plain mirror of that split and merge.

Differences from the TPU kernel, both deliberate: d2 is the direct
difference (q-p).(q-p) (the TPU kernel expands |q|^2+|p|^2-2q.p and packs
the column index into 9 low mantissa bits), and N, M need not be tile
multiples. `pad_cloud` is kept for API parity: its far-point convention is
how callers mask points.
"""

from __future__ import annotations

import torch

from . import _cuda

MAX_K = 32  # the longest list the CUDA kernel keeps (the plain version has no limit)
_INSTANCES = (1, 2, 4, 8, 12, 16, 20, 24, 32)  # list lengths csrc/bf_knn.cu is instantiated for
_WARPS = 4              # kWarps of csrc/bf_knn.cu: ranges a block searches, one a warp
_MAX_SPLITS = 16        # kMaxSplits of csrc/bf_knn.cu
_TARGET_WARPS = 2112    # 16 warps on each of 132 SMs
_MIN_SPLIT_POINTS = 256
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
    torch.topk. Output ordered by ascending d2; among equal distances the
    lower index comes first, at the k-th place too.
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
        # topk keeps any of the points that tie at the k-th distance: in the
        # rows that have more such points than places, take every closer
        # point and the lowest indices among those at it
        kth = vals[:, -1:]
        tied = ((d2 <= kth).sum(dim=1) > kk).nonzero()[:, 0]
        if tied.numel():
            sub, kth = d2[tied], kth[tied]
            closer, at = sub < kth, sub == kth
            room = kk - closer.sum(dim=1, keepdim=True)
            keep = closer | (at & (torch.cumsum(at, dim=1, dtype=torch.int32) <= room))
            cols = torch.arange(M, device=d2.device).expand_as(sub)
            idx[tied] = torch.topk(torch.where(keep, cols, M), kk, dim=1, largest=False).values
            vals[tied] = torch.gather(sub, 1, idx[tied])
        by_idx = torch.argsort(idx, dim=1, stable=True)                # order by (d2, idx): two stable sorts
        vals, idx = torch.gather(vals, 1, by_idx), torch.gather(idx, 1, by_idx)
        by_d2 = torch.argsort(vals, dim=1, stable=True)
        vals, idx = torch.gather(vals, 1, by_d2), torch.gather(idx, 1, by_d2)
        d2_out[:kk, s:s + _CHUNK] = vals.T
        idx_out[:kk, s:s + _CHUNK] = idx.T.to(torch.int32)
    return d2_out, idx_out


def knn_plain_split(queries: torch.Tensor, database: torch.Tensor, k: int, splits: int):
    """Plain PyTorch mirror of the kernel's two passes: `knn_plain` over each
    of `splits` contiguous ranges of the database (indices offset back into
    the whole), then the k least of all partial lists by (d2, idx). Equals
    `knn_plain` bit for bit."""
    N, M = queries.shape[1], database.shape[1]
    chunk = -(-M // splits)
    part_d2, part_idx = [], []
    for s in range(splits):
        lo = min(M, s * chunk)
        d2, idx = knn_plain(queries, database[:, lo:lo + chunk], k)
        part_d2.append(d2)
        part_idx.append(torch.where(idx >= 0, idx + lo, idx))
    d2, idx = torch.cat(part_d2), torch.cat(part_idx)                  # (splits * k, N)
    by_idx = torch.argsort(idx, dim=0, stable=True)
    d2, idx = torch.gather(d2, 0, by_idx), torch.gather(idx, 0, by_idx)
    by_d2 = torch.argsort(d2, dim=0, stable=True)[:k]
    return torch.gather(d2, 0, by_d2), torch.gather(idx, 0, by_d2)


def plan(n: int, m: int, k: int):
    """What the CUDA kernel runs with for n queries over m points: (instance,
    splits) — the list length of the instance (k rounded up) and the number
    of database ranges searched apart and merged. A pure function of the
    shapes, so a call's result does not depend on the card's state.

    A block's four warps always take four ranges (they prune each other, so
    this split costs little); more blocks along the database, up to 16
    ranges in all, only while the card has fewer than 16 warps per SM and a
    range keeps 256 points."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the CUDA kernel takes 1 <= k <= {MAX_K}, got k={k}")
    instance = next(i for i in _INSTANCES if i >= k)
    query_blocks = max(1, -(-n // 32))
    along = min(_TARGET_WARPS // (query_blocks * _WARPS), _MAX_SPLITS // _WARPS, m // (_WARPS * _MIN_SPLIT_POINTS))
    return instance, _WARPS * max(1, along)


def _check_cuda_inputs(queries: torch.Tensor, database: torch.Tensor, rows: int):
    """The kernels take contiguous float32 (3, n) clouds on one CUDA device,
    small enough for 32-bit indexing (`rows` output or scratch rows per query)."""
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


def run_plan(queries: torch.Tensor, database: torch.Tensor, k: int, instance: int, splits: int, flat: bool = False):
    """Both passes of the kernel at a given plan, on the current stream:
    outputs (k, N), or (N,) through K2's entry point when `flat`. `knn` and
    `nearest_neighbor` call it with `plan`'s choice; the card tests and the
    timing tool also with other splits. Raises when either launch is refused."""
    _check_cuda_inputs(queries, database, splits * k)
    N, M = queries.shape[1], database.shape[1]
    dev = queries.device
    shape = (N,) if flat else (k, N)
    d2 = torch.empty(shape, dtype=torch.float32, device=dev)
    idx = torch.empty(shape, dtype=torch.int32, device=dev)
    # scratch of the partial lists: (splits, k, N) of d2, then of idx, in one allocation
    part = torch.empty((2, splits * k * N), dtype=torch.int32, device=dev)
    part_d2 = part.data_ptr()
    part_idx = part_d2 + 4 * splits * k * N
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        lib = _cuda.library()
        if flat:
            err = lib.pcs_bf_nn(queries.data_ptr(), N, database.data_ptr(), M, splits, d2.data_ptr(),
                                idx.data_ptr(), part_d2, part_idx, stream)
        else:
            err = lib.pcs_bf_knn(queries.data_ptr(), N, database.data_ptr(), M, k, instance, splits,
                                 d2.data_ptr(), idx.data_ptr(), part_d2, part_idx, stream)
    if err != 0:
        raise RuntimeError(f"bf_knn kernel launch failed (k={k}, instance={instance}, splits={splits}): cudaError {err}")
    return d2, idx


def knn(queries: torch.Tensor, database: torch.Tensor, k: int = 8, bq: int = 256, bm: int = 512):
    """Exact brute-force k-NN: queries (3, N), database (3, M) ->
    (d2 (k, N) ascending, idx (k, N) int32), the lower index first among
    equal distances; -1 / 3e38 where the database holds fewer than k points.

    On CUDA tensors any 1 <= k <= MAX_K runs the kernel (see `plan`) and a
    larger k raises ValueError: the limit is the card's, where the lists
    live in registers. On CPU tensors the plain version takes any k.
    `bq`/`bm` are the TPU kernel's tile sizes, accepted for signature parity;
    the CUDA kernel masks ragged edges itself and takes any N, M.
    Counts its CUDA launches in `knn.launches`."""
    if _device_of(queries, database) == "cpu":
        return knn_plain(queries, database, k)
    d2, idx = run_plan(queries, database, k, *plan(queries.shape[1], database.shape[1], k))
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
    d2, idx = run_plan(queries, database, 1, *plan(queries.shape[1], database.shape[1], 1), flat=True)
    nearest_neighbor.launches += 1
    return d2, idx


nearest_neighbor.launches = 0
