#!/usr/bin/env python3
"""Holds kernel K1 of one checkout against another's, bit for bit, on one
NVIDIA GPU: the exact k-NN (`ops.bf_knn.knn`) at the shapes chip_smoke.py
times for k <= 32 — N = M = 20,000 at k = 8, a 28,646-point cloud against
itself at k = 20, 6,144 queries over it at k = 5 and 20 — on seeded clouds on
the faces of a 30 m room, with each shape's time (CUDA events: one call at a
time, and 100 calls back to back). `--rounds` adds k = 40 and 64 on the
28,646-point cloud, which run in rounds (a checkout whose K1 takes k > 32),
with each round's time besides (`bf_knn.search_round` re-run on the call's
own outputs).

    python3 tools/knn_bits_torch.py --root . --save build/change.pt
    python3 tools/knn_bits_torch.py --root build/parent --save build/parent.pt
    python3 tools/knn_bits_torch.py --compare build/parent.pt build/change.pt

`--root` is the checkout whose `pointcloud_slam_tpu_torch` is imported (its
kernels are built under its own `build/torch_kernels/`). Each run prints one
JSON line with the card's name and power limit and each shape's times;
`--compare` prints whether every output tensor is equal and exits 1 when
one differs. To compare two commits, unpack the other under `build/` and
run both in one call, in turns (A, B, B, A).
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

SHAPES = [("20k_k8", 20_000, 20_000, 8), ("map_k20", 28_646, 28_646, 20), ("scan_map_k5", 6_144, 28_646, 5),
          ("scan_map_k20", 6_144, 28_646, 20)]
ROUND_SHAPES = [("map_k40", 28_646, 28_646, 40), ("map_k64", 28_646, 28_646, 64)]


def clouds(n, m, seed):
    """Queries (3, n) and database (3, m) float32: points on the floor, walls
    and ceiling of a 30 m room with 2 cm noise, in numpy alone (the port is
    imported only from --root)."""
    g = np.random.default_rng(seed)
    size = max(n, m)
    face = g.integers(0, 6, size)
    p = g.uniform(-15.0, 15.0, (size, 3))
    axis, side = face // 2, np.where(face % 2, 15.0, -15.0)
    p[np.arange(size), axis] = side
    p = (p + g.normal(scale=0.02, size=p.shape)).astype(np.float32)
    return np.ascontiguousarray(p[:n].T), np.ascontiguousarray(p[:m].T)


def cuda_times(fn):
    """(median ms of 10 calls one at a time, mean ms of 100 back to back)."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    single = []
    for _ in range(10):
        ev[0].record()
        fn()
        ev[1].record()
        ev[1].synchronize()
        single.append(ev[0].elapsed_time(ev[1]))
    ev[0].record()
    for _ in range(100):
        fn()
    ev[1].record()
    ev[1].synchronize()
    return dict(ms=float(np.median(single)), ms_back_to_back=ev[0].elapsed_time(ev[1]) / 100)


def run(root, save, rounds):
    import torch

    shapes = SHAPES + (ROUND_SHAPES if rounds else [])
    data = {name: clouds(n, m, seed) for seed, (name, n, m, _) in enumerate(shapes)}
    sys.path.insert(0, os.path.abspath(root))
    from pointcloud_slam_tpu_torch.ops import bf_knn

    assert bf_knn.__file__.startswith(os.path.abspath(root)), bf_knn.__file__
    out, times = {}, {}
    for name, _, _, k in shapes:
        q, db = (torch.from_numpy(a).cuda() for a in data[name])
        d2, idx = bf_knn.knn(q, db, k=k)
        torch.cuda.synchronize()
        out[name] = (d2.cpu(), idx.cpu())
        times[name] = cuda_times(lambda: bf_knn.knn(q, db, k=k))
        if k > 32:
            times[name]["rounds"] = [dict(rows=rows, instance=instance, splits=splits, **cuda_times(
                lambda r=(row0, rows, instance, splits): bf_knn.search_round(q, db, d2, idx, *r)))
                for row0, rows, instance, splits in bf_knn.plan(q.shape[1], db.shape[1], k)]
    torch.save(out, save)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": root, "nvidia_smi": smi, "times": times}), flush=True)


def compare(a, b):
    import torch

    A, B = torch.load(a), torch.load(b)
    same = {name: all(torch.equal(x, y) for x, y in zip(A[name], B[name])) for name in A if name in B}
    print(json.dumps({"compare": [a, b], "bit_equal": same}), flush=True)
    return 0 if all(same.values()) else 1


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=".", help="checkout whose port is imported")
    ap.add_argument("--save", help="file the outputs are saved to")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"), help="two saved files to hold equal")
    ap.add_argument("--rounds", action="store_true", help="also k = 40 and 64 (K1 in rounds)")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    run(args.root, args.save, args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
