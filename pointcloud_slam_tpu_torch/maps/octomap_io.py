"""Octomap `.bt` (binary octree) export/import for VoxelOccupancy3D (the
port's copy of `pointcloud_slam_tpu/maps/octomap_io.py`: numpy only, the
files it writes byte-identical to the JAX package's). `save_bt` reads
numpy leaves: hand it `convert.to_numpy(map)`, one read-back of the map.

Behavioral parity target: the reference's octomap_server publishes and saves
3-D maps as octree `.bt` files consumed by navigation stacks
(`src/tool/octomap_server/src/OctomapServer.cpp`, octomap_saver CLI). Our
3-D map is a voxel HASH (maps/tiled.py VoxelOccupancy3D), so
the octree exists only at the artifact boundary: `save_bt` builds a depth-16
octree from the occupied/free voxels on the host and serializes it in the
public octomap binary format; `load_bt` reads any .bt (including pruned
trees written by octomap itself — coarse leaves are expanded to voxels).

Wire format (octomap/OccupancyOcTreeBase::writeBinaryNode — re-implemented
from the public format description, 2 bits per child, LSB-first):
  header lines:  "# Octomap OcTree binary file", "id OcTree",
                 "size <n_nodes>", "res <meters>", "data"
  body:          per inner node two bytes (children 0-3, then 4-7); child i
                 encodes 01=occupied leaf, 10=free leaf, 11=inner (recurse,
                 depth-first in child order), 00=absent/unknown
  child index:   bit0 = x-key bit, bit1 = y, bit2 = z at the node's depth;
                 key = voxel_index + 2^15 (tree depth 16).
"""

from __future__ import annotations

import numpy as np

HEADER_FIRST = b"# Octomap OcTree binary file"
TREE_DEPTH = 16
TREE_OFFSET = 1 << (TREE_DEPTH - 1)  # 32768: voxel index 0 maps to key 32768


def _build_tree(keys: np.ndarray, occupied: np.ndarray):
    """Nested-dict octree from (N, 3) uint16 keys; leaves are bools."""
    root: dict = {}
    n_nodes = 1
    for (kx, ky, kz), occ in zip(keys, occupied):
        node = root
        for depth in range(TREE_DEPTH):
            b = TREE_DEPTH - 1 - depth
            idx = (((kx >> b) & 1) | (((ky >> b) & 1) << 1) | (((kz >> b) & 1) << 2))
            if depth == TREE_DEPTH - 1:
                if idx not in node:
                    n_nodes += 1
                node[idx] = bool(occ)
            else:
                child = node.get(idx)
                if not isinstance(child, dict):
                    child = {}
                    node[idx] = child
                    n_nodes += 1
                node = child
    return root, n_nodes


def _write_node(node: dict, out: bytearray):
    b1 = 0
    b2 = 0
    for i in range(8):
        child = node.get(i)
        if child is None:
            bits = 0
        elif isinstance(child, dict):
            bits = 3
        elif child:        # occupied leaf
            bits = 1
        else:              # free leaf
            bits = 2
        if i < 4:
            b1 |= bits << (2 * i)
        else:
            b2 |= bits << (2 * (i - 4))
    out.append(b1)
    out.append(b2)
    for i in range(8):
        child = node.get(i)
        if isinstance(child, dict):
            _write_node(child, out)


def save_bt(path: str, cfg, m) -> int:
    """Write the hash map's known voxels as a .bt octree; returns node count.

    Occupied = logodds > cfg.occ_thresh_logodd; known-free voxels (observed,
    logodds <= threshold) become free leaves — the same max-likelihood
    binarization octomap's writeBinary applies.
    """
    fp = np.asarray(m.fp)
    lo = np.asarray(m.logodds)
    known = fp != 0
    keys3 = np.asarray(m.keys)[:, known].T.astype(np.int64)  # (N, 3) voxel idx
    occ = lo[known] > cfg.occ_thresh_logodd
    keys = keys3 + TREE_OFFSET
    if keys.size and (keys.min() < 0 or keys.max() >= (1 << TREE_DEPTH)):
        raise ValueError("voxel index out of the depth-16 octree range")
    root, n_nodes = _build_tree(keys.astype(np.uint32), occ)
    body = bytearray()
    if keys.size:
        _write_node(root, body)
    else:
        # octomap's empty-tree convention: "size 0" and no body. Counting the
        # root (size 1, zero-byte body) would make readBinary attempt to read
        # the root's two child bytes and hit EOF.
        n_nodes = 0
    with open(path, "wb") as f:
        f.write(HEADER_FIRST + b"\n")
        f.write(b"# (generated by pointcloud_slam_tpu)\n")
        f.write(b"id OcTree\n")
        f.write(b"size %d\n" % n_nodes)
        f.write(("res %.9g\n" % cfg.resolution).encode())
        f.write(b"data\n")
        f.write(bytes(body))
    return n_nodes


def _parse_bt(path: str):
    """Parse header + body -> (res, [(kx, ky, kz, depth, occupied), ...])."""
    with open(path, "rb") as f:
        first = f.readline().rstrip()
        if first != HEADER_FIRST:
            raise ValueError(f"{path}: not an octomap .bt file")
        res = None
        tree_id = "OcTree"
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated .bt header")
            line = line.strip()
            if line.startswith(b"#") or not line:
                continue
            if line == b"data":
                break
            k, _, v = line.partition(b" ")
            if k == b"res":
                res = float(v)
            elif k == b"id":
                tree_id = v.decode()
        if res is None:
            raise ValueError(f"{path}: missing res header")
        if tree_id != "OcTree":
            raise ValueError(f"unsupported octree id '{tree_id}'")
        body = f.read()

    leaves: list = []
    pos = 0

    def read_node(kx, ky, kz, depth):
        nonlocal pos
        if pos + 2 > len(body):
            raise ValueError("truncated .bt body")
        b1, b2 = body[pos], body[pos + 1]
        pos += 2
        half = 1 << (TREE_DEPTH - depth - 1)
        inner = []
        for i in range(8):
            bits = ((b1 if i < 4 else b2) >> (2 * (i % 4))) & 3
            cx = kx + (half if (i & 1) else 0)
            cy = ky + (half if (i & 2) else 0)
            cz = kz + (half if (i & 4) else 0)
            if bits == 3:
                inner.append((cx, cy, cz))
            elif bits:
                leaves.append((cx, cy, cz, depth + 1, bits == 1))
        for cx, cy, cz in inner:
            read_node(cx, cy, cz, depth + 1)

    if body:
        read_node(0, 0, 0, 0)
    return res, leaves


def iter_bt_leaves(path: str):
    """Yield (center (3,) float32 [m], side_m float, occupied bool) for every
    LEAF of a .bt tree without voxel expansion — memory-safe for arbitrarily
    pruned trees (the box-level view of the map)."""
    res, leaves = _parse_bt(path)
    for kx, ky, kz, depth, occupied in leaves:
        side = 1 << (TREE_DEPTH - depth)
        center = ((np.asarray([kx, ky, kz], np.float64) - TREE_OFFSET) + side / 2.0) * res
        yield center.astype(np.float32), side * res, occupied


def load_bt(path: str, max_expand_side: int = 64, oversize: str = "raise"):
    """Read a .bt file -> (resolution, occupied (N,3) centers, free (M,3)).

    Coarse (pruned) leaves are expanded to their depth-16 voxels, so trees
    written by octomap itself load to the same voxel set. A single leaf
    expands to side^3 voxels; octomap prunes homogeneous FREE space very
    aggressively (a depth-5 free leaf would be 2048^3 ≈ 8.6e9 voxels), so
    leaves coarser than `max_expand_side` per axis are handled per
    `oversize`: "raise" (default — a clear error instead of a silent
    multi-GB allocation) or "skip" (drop them; an explicit, documented data
    loss for consumers that only want the fine structure). For lossless
    access to coarse leaves without expansion use `iter_bt_leaves`.
    """
    if oversize not in ("raise", "skip"):
        raise ValueError(f"oversize must be 'raise' or 'skip', got {oversize!r}")
    res, leaves = _parse_bt(path)
    occ_keys: list = []
    free_keys: list = []
    for kx, ky, kz, depth, occupied in leaves:
        side = 1 << (TREE_DEPTH - depth)
        if side > max_expand_side:
            if oversize == "skip":
                continue
            raise ValueError(
                f"{path}: pruned {'occupied' if occupied else 'free'} leaf spans "
                f"{side}^3 voxels (> max_expand_side={max_expand_side}^3); "
                f"raise max_expand_side, pass oversize='skip', or use iter_bt_leaves"
            )
        (occ_keys if occupied else free_keys).append((kx, ky, kz, side))

    def centers(entries):
        out = []
        for kx, ky, kz, side in entries:
            if side == 1:
                out.append([[kx, ky, kz]])
            else:
                r = np.arange(side)
                gx, gy, gz = np.meshgrid(kx + r, ky + r, kz + r, indexing="ij")
                out.append(np.stack([gx, gy, gz], -1).reshape(-1, 3))
        if not out:
            return np.zeros((0, 3), np.float32)
        k = np.concatenate([np.asarray(o, np.int64) for o in out])
        return ((k - TREE_OFFSET).astype(np.float32) + 0.5) * res

    return res, centers(occ_keys), centers(free_keys)
