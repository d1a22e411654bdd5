#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths once each — the LIO odometry frame step at the
tuned odometry shape (20,000-point frames, 20 IMU samples per frame) with
the exact-k-NN covariance stage on the map that run built; the exact 1-NN
query; point-to-plane ICP at bench.py config 1's shape; GICP and VGICP with
exact covariances on align_bench's pair — and checks every hand-written
kernel on them against its plain PyTorch version. Phases:

  1. device and build: card name and power limit; nvcc builds csrc/*.cu
  2. kernel K1 (exact k-NN) against its plain version at N=M=20,000, k=8
  3. the LIO path, with every kernel's launch count reset before it and
     read after it: LIO (tuned config, then the reference-semantics config),
     exact covariances of the final map; then the torch mapping app
  4. K1 against its plain version at the map's size, k=20, and the map's
     covariances against the same function over the plain k-NN
  5. kernel K2 (exact 1-NN): its path is its public entry point (the JAX
     package has no other caller either), one call on a 20,000-point frame
     against another with the count reset before it; then K2 against its
     plain version on the same inputs
  6. point-to-plane ICP at config 1's full shape (60k-point map, 24 frames
     of 20,000 points, 30 GN iterations): batched and serial frames/s,
     translation errors, peak memory, host syncs per solve, and launches
     per GN iteration from a torch.profiler window
  7. GICP and VGICP with exact covariances (K1) on align_bench's 17,000-point
     pair, K1's count reset before it and read after it; GICP's searches per
     align against the JAX package's schedule; then K1 against its plain
     version on both clouds at k=8 and the covariances of both against the
     plain k-NN's; then apps/align_bench_torch.py

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
    kernel ms, plain ms, queries clear of near-ties, ms of torch.cdist +
    torch.topk); raises when a check fails. No single PyTorch call computes
    a k-NN: cdist + topk, two calls, is timed as context only."""
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
    ctx_ms = cuda_ms(lambda: torch.topk(torch.cdist(q.T, db.T), k, dim=1, largest=False))
    return float(err.max()), ms, plain_ms, int(clear.sum()), ctx_ms


def compare_cov(bf_knn, vgicp, pts, mask, cov, k):
    """Exact covariances `cov` (from K1) against the same function over the
    plain k-NN, on the points whose k-th neighbour is clear of a near-tie;
    every covariance finite and PSD. Returns the max |error|; raises when a
    check fails."""
    import torch

    nbrs, nmask, cnt = vgicp.exact_neighbors(pts, mask, k, knn_fn=bf_knn.knn_plain)
    cov_plain = vgicp.neighbor_covariances(nbrs, nmask, cnt)
    d2p, _ = bf_knn.knn_plain(pts, pts, k=k + 1)
    clear = (d2p[k] - d2p[k - 1]) > 1e-6 * d2p[k]
    err = float((cov - cov_plain)[:, clear].abs().max())
    check(err <= 1e-5, f"k={k}: exact covariances differ from the plain k-NN's: {err}")
    check(bool(torch.isfinite(cov).all()), f"k={k}: non-finite covariance")
    C = torch.stack([cov[0], cov[1], cov[2], cov[1], cov[3], cov[4], cov[2], cov[4], cov[5]]).T.reshape(-1, 3, 3)
    ev = torch.linalg.eigvalsh(C.double())
    check(bool((ev[:, 0] >= -1e-6 * ev[:, 2].clamp(min=1e-12)).all()), f"k={k}: a covariance is not PSD")
    return err


def gicp_searches_due(solve, search_every):
    """Replays one GICP align with solver._gn_update wrapped to keep each
    iteration's incoming `done` and its step, then applies the JAX package's
    rule (search when the iteration is a multiple of search_every or the
    last step was big, and the pose is not done). Returns (searches JAX's
    schedule runs, iterations = searches the port runs)."""
    from pointcloud_slam_tpu_torch.register import solver

    seen, gn_update = [], solver._gn_update

    def spy(H, b, pose, done, *args, **kwargs):
        out = gn_update(H, b, pose, done, *args, **kwargs)
        seen.append((done, out[3]))
        return out

    solver._gn_update = spy
    try:
        solve()
    finally:
        solver._gn_update = gn_update
    due, big = 0, False
    for it, (done, d) in enumerate(seen):
        due += int((it % search_every == 0 or big) and not bool(done))
        big = bool(d[:3].abs().max() > 0.02) or bool(d[3:].abs().max() > 0.05)
    return due, len(seen)


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


def knn_bound_ms(n, m, k):
    """The least time an H100 could take for an exact k-NN of n queries over
    m points: the larger of the bytes it must move (each input read once,
    each output written once) over 3.35 TB/s and the FP32 operations it must
    do (8 a pair: 3 subtractions, 1 multiply, 2 FMAs) over 67 TFLOP/s.
    Returns (ms, "bytes" or "operations")."""
    by = (3 * n + 3 * m) * 4 + k * n * 8
    ops = 8.0 * n * m
    t_bytes, t_ops = by / 3.35e12 * 1e3, ops / 67e12 * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def count_syncs(fn):
    """fn() under the CUDA sync debugger: (its result, synchronizing ops seen).
    The caller reads the result afterwards, outside the count."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def profile_launches(fn):
    """One run of fn() under torch.profiler: (kernel launches, GPU busy ms,
    wall ms, the three ops of most device time as [name, ms]). Launches are
    the host's CUDA launch calls; busy is the summed self device time of all
    device work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches, busy_us, device_ops = 0, 0.0, []
    for ev in prof.key_averages():
        if ev.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += ev.count
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
            busy_us += us
            device_ops.append([ev.key[:60], us / 1e3])
    top = sorted(device_ops, key=lambda e: -e[1])[:3]
    return launches, busy_us / 1e3, wall * 1e3, top


def icp_frames(world, n, n_pts, seed0=100, rot=0.05, trans=0.3):
    """bench.py:59-67 (`_frames`): frame f is n_pts world points seen from
    random_pose(seed0 + f); returns sources (n, 3, n_pts) and true t (n, 3)."""
    from pointcloud_slam_tpu_torch.io import synthetic

    rng = np.random.default_rng(1)
    srcs, gts = [], []
    for f in range(n):
        R, t = synthetic.random_pose(seed=seed0 + f, rot_scale=rot, trans_scale=trans)
        sel = rng.choice(len(world), size=n_pts, replace=False)
        srcs.append(((world[sel] - t) @ R).astype(np.float32).T)
        gts.append(t)
    return np.stack(srcs), np.stack(gts)


def timed(fn, reps):
    """Median wall ms of fn() over reps, each ended by a synchronize (after
    one warm-up call), and the last result."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def run_icp(dev):
    """bench.py config 1 (bench.py:40-135) on the port: a 60,000-point room
    in a baked map (capacity 1<<17, 10 points a voxel, 0.3 m voxels, probe 4,
    7-voxel stencil), 24 frames of 20,000 points, 30 GN iterations with a
    search every 10 and no early exit. The batched solver takes all 24
    frames at once; the serial solver takes the first 8 one after another."""
    import torch

    from pointcloud_slam_tpu_torch import ops, register
    from pointcloud_slam_tpu_torch.io import synthetic

    n_batch, n_serial, iters = 24, 8, 30
    world = synthetic.make_room_cloud(60_000, seed=0)
    srcs_np, gt = icp_frames(world, n_batch, N_POINTS)
    grid_cfg = ops.GridConfig(capacity=1 << 17, pts_per_voxel=10, resolution=0.3, probe=4, nearby=7, baked=True)
    cfg = register.ICPConfig(search_every=10, warmup_searches=0, solver=register.SolverConfig(
        max_iterations=iters, rotation_epsilon=0.0, translation_epsilon=0.0))
    torch.cuda.reset_peak_memory_stats()
    _, grid = register.build_target_map(torch.from_numpy(np.ascontiguousarray(world.T)).to(dev), grid_cfg=grid_cfg)
    srcs = torch.from_numpy(srcs_np).to(dev)

    def batched():
        return register.batched_point_to_plane_icp(grid_cfg, grid, srcs, cfg=cfg)[0]

    def single(f=0):
        return register.point_to_plane_icp(grid_cfg, grid, srcs[f], cfg=cfg).pose

    batched_ms, pose_b = timed(batched, 3)
    serial_ms, poses_s = timed(lambda: [single(f) for f in range(n_serial)], 2)
    tb = pose_b.t.cpu().numpy()
    ts = torch.stack([p.t for p in poses_s]).cpu().numpy()
    check(np.isfinite(tb).all() and np.isfinite(ts).all(), "non-finite ICP pose")
    err_b = float(np.linalg.norm(tb - gt, axis=1).max())
    err_s = float(np.linalg.norm(ts - gt[:n_serial], axis=1).max())
    agree = float(np.linalg.norm(ts - tb[:n_serial], axis=1).max())
    check(max(err_b, err_s) < 0.05, f"ICP trans_err_max_m {max(err_b, err_s)} >= 0.05")
    check(agree < 1e-3, f"serial and batched ICP poses differ by {agree} m")
    peak = torch.cuda.max_memory_allocated()
    _, syncs_b = count_syncs(batched)
    _, syncs_s = count_syncs(single)
    check(syncs_b == 0 and syncs_s == 0, f"host syncs inside an ICP solve: batched {syncs_b}, serial {syncs_s}")
    launches_s, busy_s, wall_s, top_s = profile_launches(single)
    launches_b, busy_b, wall_b, top_b = profile_launches(batched)
    mask = torch.ones(N_POINTS, dtype=torch.bool, device=dev)
    launches_q, busy_q, _, _ = profile_launches(lambda: register.icp.correspondences(cfg, grid_cfg, grid, srcs[0], mask))
    return dict(frames_per_s_batched=n_batch / batched_ms * 1e3, frames_per_s_serial=n_serial / serial_ms * 1e3,
                batched_ms=batched_ms, serial_ms_per_frame=serial_ms / n_serial, trans_err_max_m=max(err_b, err_s),
                trans_err_batched_m=err_b, trans_err_serial_m=err_s, serial_vs_batched_max_m=agree,
                peak_mem_gib=peak / 2 ** 30, syncs_per_solve_batched=syncs_b, syncs_per_solve_serial=syncs_s,
                profile_serial=dict(launches=launches_s, launches_per_iter=launches_s / iters, gpu_busy_ms=busy_s,
                                    wall_ms=wall_s, idle_share=1 - busy_s / wall_s, top_device_ms=top_s),
                profile_batched=dict(launches=launches_b, launches_per_iter=launches_b / iters, gpu_busy_ms=busy_b,
                                     wall_ms=wall_b, idle_share=1 - busy_b / wall_b, top_device_ms=top_b),
                profile_one_search=dict(launches=launches_q, gpu_busy_ms=busy_q))


def run_pairwise(dev):
    """apps/align_bench.py's synthetic pair at its default size (17,000
    points each side from a 40,000-point room, offset random_pose(seed=1,
    0.05, 0.3)): GICP with cov_method="exact" targets and VGICP on a baked
    target (capacity 1<<15), both with exact source covariances (k = 8), so
    K1 runs in the target build and the source covariances. Returns the
    phase's fields and (source, target, mask, source covariances) for the
    kernel checks that follow the launch count."""
    import torch

    from apps.align_bench_torch import make_pair
    from pointcloud_slam_tpu_torch import register

    src_t, tgt_t, mask, t_true, fit_grid, fit_map = make_pair(17_000, dev)
    cov_ms, cov = timed(lambda: register.source_covariances(src_t, mask, k=8, method="exact"), 3)
    gcfg = register.GICPConfig(cov_method="exact")
    build_ms, (ggc, ggrid, gatt) = timed(lambda: register.gicp.build_target(gcfg, tgt_t), 1)
    vcfg = register.VGICPConfig(resolution=1.0)
    vgc, vmap = register.vgicp.build_target(vcfg, tgt_t, capacity=1 << 15, baked=True)
    out = dict(cov_exact_ms=cov_ms, gicp_target_build_ms=build_ms)
    solves = {"gicp": lambda: register.gicp.align(ggc, ggrid, gatt, src_t, cov, mask, cfg=gcfg),
              "vgicp": lambda: register.vgicp.align(vgc, vmap, src_t, cov, mask, cfg=vcfg)}
    for name, solve in solves.items():
        ms, res = timed(solve, 5)
        _, syncs = count_syncs(solve)
        check(bool(torch.isfinite(res.pose.R).all() and torch.isfinite(res.pose.t).all()), f"{name}: non-finite pose")
        terr = float(np.linalg.norm(res.pose.t.cpu().numpy() - t_true))
        fitness, _ = register.fitness_score(fit_grid, fit_map, res.pose.apply(src_t), mask, max_range=1.0)
        check(terr < 0.1, f"{name}: terr {terr} >= 0.1 m")
        launches, busy, wall, _ = profile_launches(solve)
        out[name] = dict(ms_per_align=ms, terr_m=terr, fitness=float(fitness), iterations=int(res.iterations),
                         syncs_per_align=syncs, profile=dict(launches=launches, gpu_busy_ms=busy, wall_ms=wall,
                                                             idle_share=1 - busy / wall))
    # GICP's search runs every iteration (torch.where keeps the cache);
    # JAX's lax.cond runs it only where due: the launches that costs
    jax_searches, port_searches = gicp_searches_due(solves["gicp"], gcfg.search_every)
    pose = solves["gicp"]().pose
    s_launches, s_busy, _, _ = profile_launches(
        lambda: register.gicp._search(gcfg, ggc, ggrid, pose.apply(src_t), mask))
    extra = (port_searches - jax_searches) * s_launches
    out["gicp"]["searches"] = dict(port=port_searches, jax_schedule=jax_searches, launches_per_search=s_launches,
                                   gpu_busy_ms_per_search=s_busy, extra_launches=extra,
                                   extra_share_of_launches=extra / out["gicp"]["profile"]["launches"])
    return out, (src_t, tgt_t, mask, cov)


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
    err20k, ms20k, plain20k, clear20k, ctx20k = compare_knn(bf_knn, cloud, cloud, 8)
    phase(2, "K1 vs plain (N=M=20000, k=8)", max_abs_err=err20k, ms=ms20k, plain_ms=plain20k, cdist_topk_ms=ctx20k,
          bound_ms=knn_bound_ms(cloud.shape[1], cloud.shape[1], 8)[0], queries_clear_of_ties=clear20k,
          launches=bf_knn.knn.launches)

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
    errmap, msmap, plainmap, clearmap, ctxmap = compare_knn(bf_knn, pts, pts, 20)
    cov_err = compare_cov(bf_knn, vgicp, pts, mask, cov, 20)
    phase(4, "K1 vs plain (map, k=20) + covariances", n=int(pts.shape[1]), max_abs_err=errmap, ms=msmap,
          plain_ms=plainmap, cdist_topk_ms=ctxmap, bound_ms=knn_bound_ms(pts.shape[1], pts.shape[1], 20)[0],
          queries_clear_of_ties=clearmap, cov_max_abs_err=cov_err)

    # ---- 5. K2 (exact 1-NN): its public entry point, then against its plain version ----
    q, db = frames[11].pts.contiguous(), frames[10].pts.contiguous()
    bf_knn.nearest_neighbor.launches = 0
    nd2, nidx = bf_knn.nearest_neighbor(q, db)
    torch.cuda.synchronize()
    launches["nearest_neighbor"] = bf_knn.nearest_neighbor.launches
    check(launches["nearest_neighbor"] > 0, "the 1-NN path never launched K2")
    pd2, pidx = bf_knn.nearest_neighbor_plain(q, db)
    nn_err = float((nd2 - pd2).abs().max())
    check(bool(torch.allclose(nd2, pd2, rtol=1e-5, atol=1e-6)), f"K2: d2 differ, max {nn_err}")
    d2k, _ = bf_knn.knn_plain(q, db, k=2)
    clear = (d2k[1] - d2k[0]) > 1e-6 * d2k[1]
    check(bool((nidx == pidx)[clear].all()), f"K2: {int(((nidx != pidx) & clear).sum())} indices differ away from ties")
    nn_ms = cuda_ms(lambda: bf_knn.nearest_neighbor(q, db))
    nn_plain_ms = cuda_ms(lambda: bf_knn.nearest_neighbor_plain(q, db))
    nn_ctx_ms = cuda_ms(lambda: torch.cdist(q.T, db.T).min(dim=1))   # two calls: context only
    nn_bound, nn_bound_by = knn_bound_ms(q.shape[1], db.shape[1], 1)
    phase(5, "K2 vs plain (N=M=20000)", max_abs_err=nn_err, ms=nn_ms, plain_ms=nn_plain_ms, bound_ms=nn_bound,
          cdist_min_ms=nn_ctx_ms, queries_clear_of_ties=int(clear.sum()), launches=launches["nearest_neighbor"])

    # ---- 6. point-to-plane ICP at bench.py config 1's full shape ----
    phase(6, "ICP config 1", **run_icp(dev))

    # ---- 7. GICP and VGICP with exact covariances (K1) ----
    bf_knn.knn.launches = 0
    pair, (src, tgt, pmask, pcov) = run_pairwise(dev)
    pair_launches = bf_knn.knn.launches
    check(pair_launches > 0, "the pairwise path never launched K1")
    launches["bf_knn"] += pair_launches
    # K1 against its plain version at the shapes this path gives it (both
    # clouds, k = 8), and the covariances it feeds on both sides
    k1_pair = {}
    for side, cloud_t in (("source", src), ("target", tgt)):
        err, ms, plain_ms, clear_n, ctx_ms = compare_knn(bf_knn, cloud_t, cloud_t, 8)
        side_cov = pcov if side == "source" else vgicp.source_covariances(cloud_t, pmask, k=8, method="exact")
        k1_pair[side] = dict(n=int(cloud_t.shape[1]), max_abs_err=err, ms=ms, plain_ms=plain_ms, cdist_topk_ms=ctx_ms,
                             bound_ms=knn_bound_ms(cloud_t.shape[1], cloud_t.shape[1], 8)[0],
                             queries_clear_of_ties=clear_n,
                             cov_max_abs_err=compare_cov(bf_knn, vgicp, cloud_t, pmask, side_cov, 8))
    phase(7, "GICP/VGICP exact covariances", k1_launches=pair_launches, k1_vs_plain_k8=k1_pair, **pair)
    bench = subprocess.run([sys.executable, os.path.join(ROOT, "apps", "align_bench_torch.py"), "--device", "cuda",
                            "--reps", "3"], capture_output=True, text=True, timeout=600, cwd=ROOT)
    check(bench.returncode == 0, f"align bench failed ({bench.returncode}):\n{bench.stdout}\n{bench.stderr}")
    table = [" ".join(ln.split()) for ln in bench.stdout.split("\n\n")[-1].strip().splitlines()]
    phase(7, "align bench", rc=bench.returncode, table=" | ".join(table))

    k1_bound, k1_bound_by = knn_bound_ms(pts.shape[1], pts.shape[1], 20)
    print(json.dumps({"kernels": [
        {"name": "bf_knn", "route": "cuda", "source": "pointcloud_slam_tpu_torch/csrc/bf_knn.cu",
         "replaces": "pointcloud_slam_tpu/ops/pallas/bf_knn.py:47", "launches": launches["bf_knn"],
         "max_abs_err": max(err20k, errmap, *(v["max_abs_err"] for v in k1_pair.values())), "ms": msmap, "plain_ms": plainmap, "bound_ms": k1_bound, "bound_by": k1_bound_by,
         "library_ms": None},
        {"name": "nearest_neighbor", "route": "cuda", "source": "pointcloud_slam_tpu_torch/csrc/bf_knn.cu",
         "replaces": "pointcloud_slam_tpu/ops/pallas/bf_knn.py:25", "launches": launches["nearest_neighbor"],
         "max_abs_err": nn_err, "ms": nn_ms, "plain_ms": nn_plain_ms, "bound_ms": nn_bound,
         "bound_by": nn_bound_by, "library_ms": None}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
