#!/usr/bin/env python3
"""Times and counts the port's exact-k-NN CUDA kernel (K1, and K2 as its
k = 1 entry) on one NVIDIA GPU, at the sizes chip_smoke.py times: N = M =
20,000 at k = 8, a 28,093-point map at k = 20, 17,000 x 17,000 at k = 8,
6,144 queries over the map at k = 5 and 20, and the 1-NN at 20,000. Clouds
are shuffled samples of the synthetic 30 m room.

    python3 tools/knn_sweep_torch.py                   # times
    python3 tools/knn_sweep_torch.py --count           # what the search does besides distances
    python3 tools/knn_sweep_torch.py --no-candidates   # the time with no candidate at all

Times (one JSON line a shape): the wrapper's plan is first held to
`knn_plain` (d2 at rtol 1e-5 / atol 1e-6, index sets equal away from
near-ties), then timed with chip_smoke.py's two timers: `ms`, one call at a
time (it includes the host's time to prepare a call on an idle card), and
`ms_back_to_back`, 100 calls queued one behind the other (the device's
time). `search_ms` and `merge_ms` are the two passes' device times from a
torch.profiler window of 20 calls; `splits_ms` is the back-to-back time at
every number of database ranges. The first line gives `wrapper_host_us`, the
host's time in one `knn` call (2,000 calls on a 32 x 64 shape, queued
without waiting).

`--count` builds the kernel with -DPCS_COUNTERS and prints, per warp of 32
queries, the steps, the share of steps in which some lane had a candidate,
the drains of the queues and their iterations, and per query the candidates
queued and inserted beside k ln(M / k), the number a single search with an
always-current threshold would admit. `--no-candidates` builds it with
-DPCS_NO_CANDIDATES (no query is live, so no distance passes a threshold)
and times it back to back: what the distances, the tile staging and the
merge pass cost alone. Each build has its own library under
`build/torch_kernels/`. The last line is the card's nvidia-smi name and
power limit.
"""

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [("20k_k8", 20_000, 20_000, 8), ("map_k20", 28_093, 28_093, 20), ("17k_k8", 17_000, 17_000, 8),
          ("scan_map_k5", 6_144, 28_093, 5), ("scan_map_k20", 6_144, 28_093, 20), ("nn_20k", 20_000, 20_000, 1)]


def pass_ms(fn, reps=20):
    """Device ms per call of the search and the merge kernel, from a torch.profiler window of `reps` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for name in ("search_kernel", "merge_kernel"):
            if name in ev.key:
                us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
                out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out.get("search_kernel"), out.get("merge_kernel")


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--count", action="store_true", help="count steps, candidates and drains")
    mode.add_argument("--no-candidates", action="store_true", help="time the kernel with no live query")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from chip_smoke import cuda_ms, cuda_ms_back_to_back
    from pointcloud_slam_tpu_torch.io import synthetic
    from pointcloud_slam_tpu_torch.ops import _cuda, bf_knn

    if not torch.cuda.is_available():
        print("knn_sweep_torch: no CUDA device", file=sys.stderr)
        return 1
    if args.count:
        _cuda.NVCC_FLAGS.append("-DPCS_COUNTERS")
    if args.no_candidates:
        _cuda.NVCC_FLAGS.append("-DPCS_NO_CANDIDATES")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    lib = _cuda.library()
    if args.count:
        lib.pcs_counts.argtypes = [ctypes.c_void_p, ctypes.c_int]
    else:
        print("\n".join(ln.strip() for ln in lib.build_log.splitlines() if "registers" in ln or "Compiling" in ln))
        # the wrapper's host time: calls queued without waiting, on a shape the card finishes sooner
        tiny_q, tiny_db = torch.rand(3, 32, device=dev), torch.rand(3, 64, device=dev)
        bf_knn.knn(tiny_q, tiny_db, k=8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            bf_knn.knn(tiny_q, tiny_db, k=8)
        host_us = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
        print(json.dumps({"nvcc_s": round(lib.build_seconds, 2), "nvidia_smi": smi, "wrapper_host_us": host_us}),
              flush=True)

    world = synthetic.make_room_cloud(140_000, seed=3, size=30.0).astype(np.float32)
    rng = np.random.default_rng(0)
    for name, n, m, k in SHAPES:
        db = torch.from_numpy(np.ascontiguousarray(world[rng.choice(len(world), m, replace=False)].T)).to(dev)
        q = db[:, :n].contiguous()
        flat = name.startswith("nn_")
        instance, splits = bf_knn.plan(n, m, k)
        row = {"shape": name, "n": n, "m": m, "k": k, "instance": instance, "S": splits}
        call = (lambda: bf_knn.nearest_neighbor(q, db)) if flat else (lambda: bf_knn.knn(q, db, k=k))
        if args.no_candidates:
            row["no_candidates_ms_back_to_back"] = cuda_ms_back_to_back(call)
            print(json.dumps(row), flush=True)
            continue
        pd2, pidx = bf_knn.knn_plain(q, db, k=k + 1)
        clear = (pd2[k] - pd2[k - 1]) > 1e-6 * pd2[k]

        def held(d2, idx):
            d2, idx = d2.reshape(k, n), idx.reshape(k, n)
            ok = torch.allclose(d2, pd2[:k], rtol=1e-5, atol=1e-6)
            same = (torch.sort(idx, dim=0).values == torch.sort(pidx[:k], dim=0).values).all(dim=0)
            return bool(ok and same[clear].all())

        if args.count:
            lib.pcs_counts(None, 1)
            row["ok"] = held(*call())
            out = (ctypes.c_ulonglong * 8)()
            lib.pcs_counts(out, 0)
            steps, entries, queued, drains, drain_iters, inserted = list(out)[:6]
            warps = -(-n // 32)
            row.update({"steps_per_query_warp": steps / warps, "share_of_steps_with_a_candidate": entries / steps,
                        "candidates_queued_per_query": queued / n, "candidates_inserted_per_query": inserted / n,
                        "k_ln_m_over_k": k * math.log(m / k), "drains_per_query_warp": drains / warps,
                        "iterations_per_drain": drain_iters / max(drains, 1),
                        "share_of_drain_slots_used": inserted / max(32 * drain_iters, 1)})
        else:
            row.update({"ok": held(*call()), "ms": cuda_ms(call, reps=20), "ms_back_to_back": cuda_ms_back_to_back(call)})
            row["search_ms"], row["merge_ms"] = pass_ms(call)
            grid = {}
            for s in (4, 8, 12, 16):
                forced = lambda: bf_knn.run_plan(q, db, k, instance, s, flat)  # noqa: E731
                grid[f"s{s}"] = round(cuda_ms_back_to_back(forced), 4) if held(*forced()) else "WRONG"
            row["splits_ms"] = grid
        if not row["ok"]:
            raise RuntimeError(f"{name}: the kernel disagrees with the plain version")
        print(json.dumps(row), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
