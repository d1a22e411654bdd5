"""Fixed-capacity voxel-hash point map (port of `pointcloud_slam_tpu/ops/voxel_grid.py`;
reference iVox: `ivox3d.h` voxel hash + LRU eviction + 1/7/19/27-voxel
stencil kNN).

Layouts are the JAX package's: clouds (3, N), per-voxel point blocks
(3, K, C), k-NN outputs (k, N). Hashes and fingerprints reproduce the JAX
package's uint32 arithmetic bit for bit, so a map carried over from JAX
(`convert.grid_from_numpy`) probes identically. torch has no usable uint32,
so the fingerprint row `fp` is held as int64 in [0, 2^32) and all hash
arithmetic runs in int64 reduced mod 2^32.

This is the plain PyTorch version of K3 (insert) and K4 (knn): both are
written as whole-batch gathers, sorts and scatters with no data-dependent
host control flow, so they never read back from the device. `knn` probes
the hash directly — the JAX package's rolled `knn_table` is a TPU
gather-rate device and is not ported (`tbl` is accepted and ignored).

Scatter races: where several points of one batch claim one slot,
`index_put_` keeps an unspecified writer (JAX's scatter keeps another), and
with `claim_rounds=2` the losers are dropped, so slot layouts differ from
the JAX package's. Compare maps through their k-NN answers.

Frozen copy, for the benchmark's plain reference, of
`pointcloud_slam_tpu_torch/ops/voxel_grid.py` at commit 9c22c1c.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .downsample import recip32

_INF = float(np.float32(3.0e38))
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Static configuration (field meanings as in the JAX package)."""

    capacity: int = 1 << 18          # number of voxel slots (power of two)
    pts_per_voxel: int = 8           # dense point block per voxel
    resolution: float = 0.5          # voxel edge length (m)
    probe: int = 8                   # linear-probe window
    nearby: int = 7                  # stencil: 1, 7, 19 or 27 voxels
    claim_rounds: int = 4            # scatter-race resolution rounds in insert()
    baked: bool = False              # stencil applied at insert; knn does one lookup

    def __post_init__(self):
        if self.capacity & (self.capacity - 1):
            raise ValueError("capacity must be a power of two")
        if self.nearby not in (1, 7, 19, 27):
            raise ValueError(f"nearby must be 1, 7, 19 or 27, got {self.nearby}")


class VoxelHashMap(NamedTuple):
    keys: torch.Tensor      # int32 (3, C) voxel coords per slot
    fp: torch.Tensor        # int64 (C,) uint32 coord fingerprint, 0 = empty slot
    occupied: torch.Tensor  # bool (C,)
    pts: torch.Tensor       # float32 (3, K, C)
    npts: torch.Tensor      # int32 (C,)
    stamp: torch.Tensor     # int32 (C,) LRU stamp
    counter: torch.Tensor   # int32 () insert-epoch counter


def create(config: GridConfig, dtype=torch.float32, device="cuda") -> VoxelHashMap:
    """An empty map, on the GPU unless `device` says otherwise."""
    C, K = config.capacity, config.pts_per_voxel
    return VoxelHashMap(
        keys=torch.zeros((3, C), dtype=torch.int32, device=device),
        fp=torch.zeros((C,), dtype=torch.int64, device=device),
        occupied=torch.zeros((C,), dtype=torch.bool, device=device),
        pts=torch.zeros((3, K, C), dtype=dtype, device=device),
        npts=torch.zeros((C,), dtype=torch.int32, device=device),
        stamp=torch.zeros((C,), dtype=torch.int32, device=device),
        counter=torch.zeros((), dtype=torch.int32, device=device),
    )


def stencil_offsets(nearby: int) -> np.ndarray:
    """Neighbor voxel offsets (S, 3), matching iVox NearbyType (ivox3d.h:212-235)."""
    offs = [(0, 0, 0)]
    faces = [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1)]
    edges = [
        (1, 1, 0), (-1, 1, 0), (1, -1, 0), (-1, -1, 0),
        (1, 0, 1), (-1, 0, 1), (1, 0, -1), (-1, 0, -1),
        (0, 1, 1), (0, -1, 1), (0, 1, -1), (0, -1, -1),
    ]
    corners = [(1, 1, 1), (-1, 1, 1), (1, -1, 1), (1, 1, -1), (-1, -1, 1), (-1, 1, -1), (1, -1, -1), (-1, -1, -1)]
    if nearby >= 7:
        offs += faces
    if nearby >= 19:
        offs += edges
    if nearby >= 27:
        offs += corners
    return np.asarray(offs, np.int32)


@functools.lru_cache(maxsize=None)
def _stencil_tensor(nearby: int, device: torch.device) -> torch.Tensor:
    """(3, S) int32 stencil offsets on `device`, built once per device (a
    host-to-device copy waits for the stream, so it stays off the per-call path)."""
    return torch.as_tensor(stencil_offsets(nearby).T.copy()).to(device)


def point_to_voxel(points: torch.Tensor, resolution: float) -> torch.Tensor:
    """World points (3, N) -> integer voxel coords (3, N) (floor, ivox Pos2Grid).

    The coordinates multiply by the float32 reciprocal of the resolution on
    every device: jitted XLA folds the JAX package's division by the
    constant resolution into that product, and PyTorch's CUDA kernel does
    the same to a division by a host scalar while the CPU divides. A point
    on a voxel bound then lands in one voxel everywhere."""
    return torch.floor(points * recip32(resolution)).to(torch.int32)


def _u32(c: torch.Tensor) -> torch.Tensor:
    """int tensor -> its uint32 bit pattern as int64 in [0, 2^32)."""
    return c.to(torch.int64) & _M32


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for a in [0, 2^32) (int64) and a uint32 constant b,
    split in 16-bit halves so no int64 product overflows."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash3(cx: torch.Tensor, cy: torch.Tensor, cz: torch.Tensor, capacity: int) -> torch.Tensor:
    """Spatial hash (prime-multiply additive combine + murmur3 finalizer),
    bit-identical to the JAX package's uint32 `_hash3`. Returns int64 slots."""
    h = (_mul32(_u32(cx), 73856093) + _mul32(_u32(cy), 19349669) + _mul32(_u32(cz), 83492791)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h & (capacity - 1)


def _fingerprint(cx, cy, cz) -> torch.Tensor:
    """Secondary 32-bit coordinate hash used as the slot fingerprint (never 0;
    0 marks an empty slot), bit-identical to the JAX package's. int64 values."""
    h = (_mul32(_u32(cx), 0x9E3779B1) + _mul32(_u32(cy), 0x85EBCA77) + _mul32(_u32(cz), 0xC2B2AE3D)) & _M32
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    return h | 1


def _probe_window(config: GridConfig, h0: torch.Tensor) -> torch.Tensor:
    """(P, N) slot indices of each query's linear-probe window."""
    j = torch.arange(config.probe, device=h0.device)[:, None]
    return (h0[None, :] + j) & (config.capacity - 1)



def _scatter_drop(dst: torch.Tensor, idx: torch.Tensor, val, dim_size: int) -> torch.Tensor:
    """dst.at[idx].set(val, mode="drop") along the last dim: indices equal to
    `dim_size` land in a sink column that is cut off again."""
    sink = torch.cat([dst, dst.new_zeros(dst.shape[:-1] + (1,))], dim=-1)
    if not torch.is_tensor(val):
        val = torch.full(idx.shape, val, dtype=dst.dtype, device=dst.device)
    sink[..., idx] = val.to(dst.dtype)
    return sink[..., :dim_size]


def _claim_round(config: GridConfig, fp, npts, stamp, counter, h0, fpq, remaining, slot):
    """One scatter-race claim round over the probe window (the JAX package's
    `_claim_round_fast`). Priority: existing fingerprint match > empty slot >
    LRU-evict oldest (slots stamped `counter` were claimed earlier in this
    batch and are protected). Claims scatter, then a verify re-gather marks
    losers `remaining` for the next round."""
    C = config.capacity
    win = _probe_window(config, h0)                     # (P, N)
    fpg, stg = fp[win], stamp[win].to(torch.int64)
    match = fpg == fpq[None, :]
    empty = fpg == 0
    has_match = match.any(dim=0)
    jm = torch.argmax(match.to(torch.int8), dim=0)
    has_empty = empty.any(dim=0)
    je = torch.argmax(empty.to(torch.int8), dim=0)
    old = (~empty) & (stg < counter.to(torch.int64))
    ev = torch.where(old, stg, _M32)
    jv = torch.argmin(ev, dim=0)
    has_evict = old.any(dim=0)
    j = torch.where(has_match, jm, torch.where(has_empty, je, jv))
    ok = remaining & (has_match | has_empty | has_evict)
    s = (h0 + j) & (C - 1)
    newc = ok & ~has_match
    tgt_new = torch.where(newc, s, C)
    fp = _scatter_drop(fp, tgt_new, fpq, C)
    if npts is not None:
        npts = _scatter_drop(npts, tgt_new, 0, C)
    stamp = _scatter_drop(stamp, torch.where(ok, s, C), counter.expand(s.shape), C)
    won = ok & (fp[s] == fpq)                           # verify re-gather
    slot = torch.where(won, s, slot)
    remaining = remaining & ~won
    return fp, npts, stamp, remaining, slot


def _claim_loop(config: GridConfig, fp, stamp, counter, cx, cy, cz, mask, npts=None):
    """Run `config.claim_rounds` claim rounds. Returns (fp, npts, stamp, slot)
    with slot == capacity for unresolved or unmasked points. `npts` (per-voxel
    point count, reset to 0 on a fresh claim) is optional: the Gaussian grid
    accumulates moments instead and passes None."""
    C = config.capacity
    h0 = _hash3(cx, cy, cz, C)
    fpq = _fingerprint(cx, cy, cz)
    remaining = mask
    slot = torch.full(cx.shape, C, dtype=torch.int64, device=cx.device)
    for _ in range(config.claim_rounds):
        fp, npts, stamp, remaining, slot = _claim_round(config, fp, npts, stamp, counter, h0, fpq, remaining, slot)
    return fp, npts, stamp, slot


def insert(config: GridConfig, grid: VoxelHashMap, points: torch.Tensor, mask: torch.Tensor,
           return_indices: bool = False):
    """Insert masked points. points (3, N), mask (N,) bool. Returns the new map,
    and with `return_indices` also the flat (block_row * capacity + slot) write
    index of each point, -1 where it was dropped (unbaked maps only), so that
    callers can scatter parallel per-point attribute arrays.

    Claiming runs `claim_rounds` rounds so same-batch hash collisions between
    different voxels resolve. Points in a full per-voxel block are dropped, and
    under table pressure the oldest slot in the probe window is evicted (iVox
    LRU + capacity limits, ivox3d.h:257-281)."""
    C, K = config.capacity, config.pts_per_voxel
    coords = point_to_voxel(points, config.resolution)
    if config.baked:
        if return_indices:
            raise ValueError("return_indices is not supported for baked grids")
        # stencil baked into the map: store the point under every voxel whose
        # (mirrored) stencil contains it, so knn() reads one voxel per query
        offs = _stencil_tensor(config.nearby, coords.device)  # (3, S)
        S, Nin = offs.shape[1], points.shape[1]
        coords = (coords[:, None, :] + offs[:, :, None]).reshape(3, S * Nin)
        points = points[:, None, :].expand(3, S, Nin).reshape(3, S * Nin)
        mask = mask[None, :].expand(S, Nin).reshape(S * Nin)
    N = points.shape[1]
    cx, cy, cz = coords[0], coords[1], coords[2]
    counter = grid.counter + 1  # fresh stamp for this batch
    fp, npts, stamp, slot = _claim_loop(config, grid.fp, grid.stamp, counter, cx, cy, cz, mask, npts=grid.npts)

    ok = mask & (slot < C)
    # exact keys + occupancy written once at the settled slots
    tgt = torch.where(ok, slot, C)
    keys = _scatter_drop(grid.keys, tgt, coords, C)
    occupied = _scatter_drop(grid.occupied, tgt, True, C)

    # in-batch rank within each slot (stable sort by slot, rank = i - first_occ)
    order = torch.argsort(slot, stable=True)
    sorted_slot = slot[order]
    idx = torch.arange(N, device=points.device)
    is_first = torch.ones(N, dtype=torch.bool, device=points.device)
    is_first[1:] = sorted_slot[1:] != sorted_slot[:-1]
    first_idx = torch.cummax(torch.where(is_first, idx, 0), dim=0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - first_idx

    base = npts[torch.clamp(slot, max=C - 1)].to(torch.int64)
    write_idx = base + rank
    fits = ok & (write_idx < K)
    flat = torch.where(fits, write_idx * C + slot, C * K)   # into (3, K*C)
    pts = _scatter_drop(grid.pts.reshape(3, K * C), flat, points, K * C).reshape(3, K, C)

    adds = torch.zeros(C + 1, dtype=torch.int32, device=points.device)
    adds.index_add_(0, torch.where(fits, slot, C), torch.ones(N, dtype=torch.int32, device=points.device))
    npts = npts + adds[:C]
    new_grid = VoxelHashMap(keys, fp, occupied, pts, npts, stamp, counter)
    if return_indices:
        return new_grid, torch.where(fits, flat, -1)
    return new_grid


def knn(config: GridConfig, grid: VoxelHashMap, queries: torch.Tensor, k: int = 5, max_range: float = 5.0,
        tbl=None):
    """k nearest map points for each query over the stencil neighborhood.

    queries (3, N) -> (neighbors (3, k, N), d2 (k, N), count (N,), idx (k, N)).
    Invalid neighbors have d2 == 3e38, zero coordinates and idx -1; `count`
    is the number of valid ones; `idx` is the flat map index
    (block_row * capacity + slot). `tbl` is accepted for signature parity and
    ignored (the hash is probed directly).

    Each stencil voxel is found by the JAX package's fingerprint probe (top 26
    fingerprint bits, first match wins, count = min(npts, K)); the (S*K, N)
    candidates are ranked by one stable sort on d2, which keeps the earliest
    visited candidate first among equal distances. (The JAX insertion chain
    can reorder candidates whose d2 are exactly equal; all other answers are
    identical.)
    """
    C, K = config.capacity, config.pts_per_voxel
    dev = queries.device
    N = queries.shape[1]
    dtype = grid.pts.dtype
    cq = point_to_voxel(queries, config.resolution)
    max_r2 = float(np.float32(max_range) ** 2)
    fp_hi = grid.fp & 0xFFFFFFC0
    cnt_all = torch.clamp(grid.npts, max=K)
    if config.baked:
        offsets = torch.zeros((3, 1), dtype=torch.int32, device=dev)
    else:
        offsets = _stencil_tensor(config.nearby, dev)  # (3, S)
    S = offsets.shape[1]
    cc = cq[:, None, :] + offsets[:, :, None]                          # (3, S, N)
    cx, cy, cz = cc[0].reshape(-1), cc[1].reshape(-1), cc[2].reshape(-1)
    h0 = _hash3(cx, cy, cz, C)
    fpq = _fingerprint(cx, cy, cz) & 0xFFFFFFC0
    win = _probe_window(config, h0)                                    # (P, S*N)
    match = fp_hi[win] == fpq[None, :]
    jm = torch.argmax(match.to(torch.int8), dim=0)
    safe = (h0 + jm) & (C - 1)                                         # (S*N,)
    cnt = torch.where(match.any(dim=0), cnt_all[safe], 0).reshape(S, N)
    safe = safe.reshape(S, N)

    cand = grid.pts[:, :, safe]                                        # (3, K, S, N)
    cand = cand.permute(0, 2, 1, 3).reshape(3, S * K, N)               # visit order: stencil, block row
    row = torch.arange(K, device=dev)
    live = (row[None, :, None] < cnt[:, None, :]).reshape(S * K, N)
    d2 = (cand[0] - queries[0]) ** 2 + (cand[1] - queries[1]) ** 2 + (cand[2] - queries[2]) ** 2
    d2 = torch.where(live & (d2 <= max_r2), d2, _INF)
    fidx = (row[None, :, None] * C + safe[:, None, :]).reshape(S * K, N)

    kk = min(k, S * K)
    d2s, order = torch.sort(d2, dim=0, stable=True)
    d2s, order = d2s[:kk], order[:kk]
    valid = d2s < _INF
    nbrs = torch.where(valid[None], torch.gather(cand, 1, order[None].expand(3, kk, N)), 0.0)
    idx = torch.where(valid, torch.gather(fidx, 0, order), -1)
    if kk < k:  # fewer candidates than k: pad with invalid entries
        pad = k - kk
        d2s = torch.cat([d2s, torch.full((pad, N), _INF, dtype=dtype, device=dev)])
        nbrs = torch.cat([nbrs, torch.zeros((3, pad, N), dtype=dtype, device=dev)], dim=1)
        idx = torch.cat([idx, torch.full((pad, N), -1, dtype=idx.dtype, device=dev)])
        valid = d2s < _INF
    count = valid.sum(dim=0).to(torch.int32)
    return nbrs, d2s, count, idx.to(torch.int32)
