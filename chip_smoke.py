#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path once — the LIO odometry frame step at the tuned
odometry shape (20,000-point frames, 20 IMU samples per frame), then the
exact-k-NN covariance stage on the map that run built — and checks every
hand-written kernel on that path against its plain PyTorch version. Phases:

  1. device and build: card name and power limit; nvcc builds csrc/*.cu
  2. kernel K1 (exact k-NN) against its plain version at N=M=20,000, k=8
  3. the main path, with every kernel's launch count reset before it and
     read after it: LIO (tuned config, then the reference-semantics config),
     exact covariances of the final map; then the torch mapping app
  4. K1 against its plain version at the map's size, k=20, and the map's
     covariances against the same function over the plain k-NN

Each phase prints one line; the kernels' JSON line and the card's
nvidia-smi line come before the last line, which is the result object.
Any failed check raises, so the script exits non-zero. Without a CUDA
device it exits non-zero before doing anything; it imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 50          # tuned-config frames (the first 5 are IMU init / warm-up)
N_FRAMES_REF = 12      # reference-semantics frames
N_POINTS = 20_000
N_IMU = 20


def phase(number, name, **fields):
    print(f"phase {number} {name}: " + json.dumps(fields), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps=5):
    """Median time of one call on the card (CUDA events), after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare_knn(bf_knn, q, db, k):
    """Kernel vs plain version on the same card tensors. Returns (max |d2 err|,
    kernel ms, plain ms); raises when a check fails."""
    import torch

    d2, idx = bf_knn.knn(q, db, k=k)
    torch.cuda.synchronize()
    pd2, pidx = bf_knn.knn_plain(q, db, k=k + 1)
    check(bool((d2[1:] >= d2[:-1]).all()), f"k={k}: kernel d2 rows not ascending")
    err = (d2 - pd2[:k]).abs()
    check(bool(torch.allclose(d2, pd2[:k], rtol=1e-5, atol=1e-6)), f"k={k}: d2 differ, max {float(err.max())}")
    # index sets must agree wherever the k-th neighbour is not a near-tie
    clear = (pd2[k] - pd2[k - 1]) > 1e-6 * pd2[k]
    same = (torch.sort(idx, dim=0).values == torch.sort(pidx[:k], dim=0).values).all(dim=0)
    check(bool(same[clear].all()), f"k={k}: {int((~same & clear).sum())} index sets differ away from ties")
    ms = cuda_ms(lambda: bf_knn.knn(q, db, k=k))
    plain_ms = cuda_ms(lambda: bf_knn.knn_plain(q, db, k=k))
    return float(err.max()), ms, plain_ms, int(clear.sum())


def build_frames(device, n_frames):
    """The tuned odometry benchmark's sequence (bench.py:190-211): a 30 m room
    of 80k points, an exact-IMU trajectory, 20k-point scans at the frame-end pose."""
    from pointcloud_slam_tpu_torch.io import feed, synthetic

    world = synthetic.make_room_cloud(80_000, seed=3, size=30.0)
    traj = synthetic.make_imu_trajectory(n_frames + 1, imu_per_frame=N_IMU, frame_dt=0.1, seed=3)
    rng = np.random.default_rng(3)
    frames, gt = [], []
    for f in range(n_frames):
        i0, i1 = f * N_IMU, (f + 1) * N_IMU
        pos, R = traj["pos"][i1], traj["R"][i1]
        rel = (world - pos) @ R
        r = np.linalg.norm(rel, axis=1)
        vis = rel[(r < 30.0) & (r > 0.3)]
        pts = vis[rng.choice(len(vis), size=min(N_POINTS, len(vis)), replace=False)].astype(np.float32)
        imu_t = (traj["t"][i0 + 1: i1 + 1] - traj["t"][i0]).astype(np.float32)
        frames.append(feed.make_frame(pts, np.full(len(pts), 0.1, np.float32), traj["acc"][i0:i1],
                                      traj["gyro"][i0:i1], imu_t, n_points=N_POINTS, n_imu=N_IMU,
                                      prev_imu_t=0.0, device=device))
        gt.append(pos)
    return frames, np.asarray(gt)


def run_lio(cfg, frames, gt, device):
    """Frame steps from a fresh state. Returns (state, stats); the steady-state
    fps covers frames 5.. (after IMU init and the first updates)."""
    import torch

    from pointcloud_slam_tpu_torch.models import lio

    s = lio.create_state(cfg, device=device)
    outs = []
    syncs0 = lio.lio_step.host_syncs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for k, fr in enumerate(frames):
                if k == 5:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                s, out = lio.lio_step(cfg, s, fr)
                outs.append(out.pos)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    seen_syncs = sum("synchroniz" in str(w.message) for w in caught)
    est = torch.stack(outs).cpu().numpy()
    check(np.isfinite(est).all(), "non-finite pose")
    errs = np.linalg.norm(est[5:] - gt[5:len(est)], axis=1)
    return s, dict(frames=len(frames), fps=(len(frames) - 5) / wall, ate_mean_m=float(errs.mean()),
                   ate_final_m=float(errs[-1]),
                   host_syncs_per_frame=(lio.lio_step.host_syncs - syncs0) / len(frames),
                   sync_ops_seen_per_frame=seen_syncs / len(frames))


def map_points(grid):
    """Valid points of a voxel map (block row k of a slot is valid iff k < npts)."""
    import torch

    K, C = grid.pts.shape[1], grid.pts.shape[2]
    live = torch.arange(K, device=grid.pts.device)[:, None] < torch.clamp(grid.npts, max=K)[None, :]
    return grid.pts[:, live].contiguous()


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import dataclasses

    from pointcloud_slam_tpu_torch import ops  # the package pins f32 matmuls (no TF32)
    from pointcloud_slam_tpu_torch.models import lio
    from pointcloud_slam_tpu_torch.ops import _cuda, bf_knn
    from pointcloud_slam_tpu_torch.register import vgicp

    check("jax" not in sys.modules, "the port imported jax")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]

    # ---- 1. device and build ----
    t0 = time.perf_counter()
    lib = _cuda.library()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines() if "registers" in ln or "spill" in ln]
    phase(1, "device+build", device=name, nvidia_smi=smi, build_s=round(time.perf_counter() - t0, 2),
          nvcc_s=round(lib.build_seconds, 2), ptxas=ptxas)

    # ---- 2. K1 against its plain version at N = M = 20,000, k = 8 ----
    frames, gt = build_frames(dev, N_FRAMES)
    cloud = frames[10].pts.contiguous()
    err20k, ms20k, plain20k, clear20k = compare_knn(bf_knn, cloud, cloud, 8)
    phase(2, "K1 vs plain (N=M=20000, k=8)", max_abs_err=err20k, ms=ms20k, plain_ms=plain20k,
          queries_clear_of_ties=clear20k, launches=bf_knn.knn.launches)

    # ---- 3. the main path: launches counted from here ----
    cfg = lio.LIOConfig(
        grid=ops.GridConfig(capacity=1 << 16, pts_per_voxel=3, resolution=0.4, nearby=7, probe=4, claim_rounds=2),
        scan_leaf=0.3, map_leaf=0.3, init_imu_frames=1, scan_budget=6144, insert_budget=2048,
        max_iterations=3, research_on_converge=False,
    )
    cfg_ref = dataclasses.replace(cfg, max_iterations=4, research_on_converge=True)
    bf_knn.knn.launches = 0
    state, tuned = run_lio(cfg, frames, gt, dev)
    check(tuned["ate_mean_m"] < 0.2 and tuned["ate_final_m"] < 0.25, f"tuned LIO ATE gates: {tuned}")
    _, ref = run_lio(cfg_ref, frames[:N_FRAMES_REF], gt, dev)
    check(ref["ate_mean_m"] < 0.2 and ref["ate_final_m"] < 0.25, f"reference-semantics LIO ATE gates: {ref}")
    pts = map_points(state.grid)
    mask = torch.ones(pts.shape[1], dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cov = vgicp.source_covariances(pts, mask, k=20, method="exact")
    torch.cuda.synchronize()
    cov_s = time.perf_counter() - t0
    launches = {"bf_knn": bf_knn.knn.launches}
    check(launches["bf_knn"] > 0, "the main path never launched K1")
    phase(3, "main path", lio_tuned=tuned, lio_reference_semantics=ref, map_points=int(pts.shape[1]),
          cov_exact_s=cov_s, launches=launches)

    app = subprocess.run([sys.executable, os.path.join(ROOT, "apps", "run_mapping_offline_torch.py"),
                          "--synthetic", "40", "--device", "cuda", "--traj_log_file",
                          str(_cuda.BUILD_DIR / "smoke_traj.txt")],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    check(app.returncode == 0, f"mapping app failed ({app.returncode}):\n{app.stdout}\n{app.stderr}")
    phase(3, "mapping app", rc=app.returncode, out=app.stdout.strip().splitlines()[0])

    # ---- 4. K1 at the map's size, and the covariances it feeds ----
    errmap, msmap, plainmap, clearmap = compare_knn(bf_knn, pts, pts, 20)
    nbrs, nmask, cnt = vgicp.exact_neighbors(pts, mask, 20, knn_fn=bf_knn.knn_plain)
    cov_plain = vgicp.neighbor_covariances(nbrs, nmask, cnt)
    d2p, _ = bf_knn.knn_plain(pts, pts, k=21)
    clear = (d2p[20] - d2p[19]) > 1e-6 * d2p[20]
    cov_err = float((cov - cov_plain)[:, clear].abs().max())
    check(cov_err <= 1e-5, f"exact covariances differ from the plain k-NN's: {cov_err}")
    check(bool(torch.isfinite(cov).all()), "non-finite covariance")
    C = torch.stack([cov[0], cov[1], cov[2], cov[1], cov[3], cov[4], cov[2], cov[4], cov[5]]).T.reshape(-1, 3, 3)
    ev = torch.linalg.eigvalsh(C.double())
    check(bool((ev[:, 0] >= -1e-6 * ev[:, 2].clamp(min=1e-12)).all()), "a covariance is not PSD")
    phase(4, "K1 vs plain (map, k=20) + covariances", n=int(pts.shape[1]), max_abs_err=errmap, ms=msmap,
          plain_ms=plainmap, queries_clear_of_ties=clearmap, cov_max_abs_err=cov_err)

    print(json.dumps({"kernels": [{
        "name": "bf_knn", "route": "cuda", "source": "pointcloud_slam_tpu_torch/csrc/bf_knn.cu",
        "replaces": "pointcloud_slam_tpu/ops/pallas/bf_knn.py:47", "launches": launches["bf_knn"],
        "max_abs_err": errmap, "ms": msmap, "plain_ms": plainmap}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
