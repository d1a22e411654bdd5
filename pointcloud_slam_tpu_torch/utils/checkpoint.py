"""Checkpoints of pipeline states, and trajectory, pose-graph and keyframe
output (port of `pointcloud_slam_tpu/utils/checkpoint.py`; the g2o export
takes the port's PoseGraph, the keyframe artifacts take tensors or arrays).

`save_state` writes the JAX package's `.npz` layout: the state's leaves in
field order (`leaf_i`, in the JAX package's dtypes, as `convert.to_numpy`
gives them) and `n_leaves`. So `load_state` reads a file the JAX package's
`save_state` wrote of the same state type, and the JAX package reads the
port's.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves(tree) -> list:
    """A state's leaves in field order (the order jax.tree.flatten gives a
    NamedTuple of arrays)."""
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _rebuild(like, it):
    if isinstance(like, tuple):
        return type(like)(*(_rebuild(v, it) for v in like))
    a = next(it)
    if torch.is_tensor(like):
        return torch.from_numpy(np.asarray(a).astype(np.int64) if a.dtype == np.uint32 else np.array(a)).to(
            device=like.device, dtype=like.dtype)
    return type(like)(a.item()) if isinstance(like, (bool, int, float)) else a


def save_state(path: str, state):
    """Serialize a state (LIOState, SLAMState, PoseGraph, a map ...) to one .npz."""
    from ..convert import to_numpy

    leaves = _leaves(to_numpy(state))
    np.savez_compressed(path, n_leaves=len(leaves), **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})


def load_state(path: str, like):
    """Restore a state saved by either package's save_state, with `like` (a
    state of the same type) giving the structure, dtypes and device."""
    data = np.load(path)
    n = int(data["n_leaves"])
    n_like = len(_leaves(like))
    assert n == n_like, f"checkpoint has {n} leaves, expected {n_like}"
    return _rebuild(like, iter(data[f"leaf_{i}"] for i in range(n)))


def save_trajectory_tum(path: str, times, positions, quats_xyzw):
    """TUM format: t x y z qx qy qz qw (laser_mapping.cc Savetrajectory)."""
    with open(path, "w") as f:
        for t, p, q in zip(times, positions, quats_xyzw):
            f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def save_poses_kitti(path: str, rotations, positions):
    """KITTI format: row-major 3x4 per line
    (mapOptmization.cpp saveOptimizedVerticesKITTIformat)."""
    with open(path, "w") as f:
        for R, t in zip(rotations, positions):
            M = np.concatenate([np.asarray(R), np.asarray(t).reshape(3, 1)], axis=1)
            f.write(" ".join(f"{v:.9f}" for v in M.reshape(-1)) + "\n")


def _quat_from_R(R):
    from ..geom import so3

    return so3.to_quat(torch.as_tensor(np.asarray(R, np.float32))).numpy()


def save_pose_graph_g2o(path: str, graph):
    """g2o text export of a PoseGraph (the reference saves its gtsam graph via
    writeG2o next to the keyframe artifacts, mapOptmization.cpp:1868-1880).

    Emits VERTEX_SE3:QUAT for the active nodes, EDGE_SE3:QUAT for odometry and
    loop between-factors with their diagonal information (upper triangle)."""
    graph = type(graph)(*(v.cpu().numpy() if torch.is_tensor(v) else v for v in graph))
    n = int(graph.n)
    nl = int(graph.n_loops)
    R = np.asarray(graph.R)
    t = np.asarray(graph.t)
    with open(path, "w") as f:
        for k in range(n):
            q = _quat_from_R(R[k])
            f.write(f"VERTEX_SE3:QUAT {k} " + " ".join(f"{v:.9f}" for v in (*t[k], *q)) + "\n")

        def edge(i, j, Rm, tm, info6):
            q = _quat_from_R(Rm)
            # g2o information matrix upper triangle (21 values), diagonal-only;
            # g2o edge ordering is [x y z qx qy qz] -> translation first
            I = np.zeros((6, 6))
            I[0, 0], I[1, 1], I[2, 2] = info6[3], info6[4], info6[5]
            I[3, 3], I[4, 4], I[5, 5] = info6[0], info6[1], info6[2]
            upper = [I[a, b] for a in range(6) for b in range(a, 6)]
            f.write(
                f"EDGE_SE3:QUAT {i} {j} "
                + " ".join(f"{v:.9f}" for v in (*tm, *q))
                + " " + " ".join(f"{v:.6f}" for v in upper) + "\n"
            )

        oR, ot, oi = np.asarray(graph.odom_R), np.asarray(graph.odom_t), np.asarray(graph.odom_info)
        for k in range(1, n):
            edge(k - 1, k, oR[k], ot[k], oi[k])
        lR, lt, li = np.asarray(graph.loop_R), np.asarray(graph.loop_t), np.asarray(graph.loop_info)
        la, lb = np.asarray(graph.loop_i), np.asarray(graph.loop_j)
        for k in range(nl):
            edge(int(la[k]), int(lb[k]), lR[k], lt[k], li[k])


def load_pose_graph_g2o(path: str):
    """Parse a g2o file -> (ids, positions (N,3), quats_xyzw (N,4), edges).

    edges = list of (i, j, t (3,), q_xyzw (4,), info_diag (6,) [rot, trans])."""
    ids, ts, qs, edges = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "VERTEX_SE3:QUAT":
                ids.append(int(parts[1]))
                vals = [float(v) for v in parts[2:9]]
                ts.append(vals[0:3])
                qs.append(vals[3:7])
            elif parts[0] == "EDGE_SE3:QUAT":
                i, j = int(parts[1]), int(parts[2])
                vals = [float(v) for v in parts[3:10]]
                upper = [float(v) for v in parts[10:31]]
                I = np.zeros((6, 6))
                k = 0
                for a in range(6):
                    for b in range(a, 6):
                        I[a, b] = upper[k]
                        k += 1
                info = np.array([I[3, 3], I[4, 4], I[5, 5], I[0, 0], I[1, 1], I[2, 2]])
                edges.append((i, j, np.array(vals[0:3]), np.array(vals[3:7]), info))
    return ids, np.array(ts), np.array(qs), edges


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_scd(path: str, descriptor):
    """ScanContext descriptor as whitespace text (SCManager SCD persistence)."""
    np.savetxt(path, _np(descriptor), fmt="%.3f")


def load_scd(path: str):
    return np.loadtxt(path, dtype=np.float32)


def save_keyframe_artifacts(out_dir: str, k: int, surf_pts, surf_mask, descriptor,
                            corner_pts=None, corner_mask=None):
    """Per-keyframe artifact persistence (saveKeyFramesAndFactor
    mapOptmization.cpp:1868-1880: Scans/*.pcd + SCDs/*.scd).

    Clouds are (3, N) with boolean masks; saved in the keyframe's own frame."""
    import os

    from ..io import pcd as pcdio

    scans = os.path.join(out_dir, "Scans")
    scds = os.path.join(out_dir, "SCDs")
    os.makedirs(scans, exist_ok=True)
    os.makedirs(scds, exist_ok=True)
    pcdio.write_pcd(os.path.join(scans, f"{k:06d}.pcd"), _np(surf_pts).T[_np(surf_mask)])
    save_scd(os.path.join(scds, f"{k:06d}.scd"), descriptor)
    if corner_pts is not None:
        pcdio.write_pcd(os.path.join(scans, f"{k:06d}_corner.pcd"), _np(corner_pts).T[_np(corner_mask)])
