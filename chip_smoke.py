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
     covariances against the same function over the plain k-NN; K1 with a
     scan's worth of queries (6,144) over the map at k=5 and k=20; a sweep
     of k (2 .. 32, instances and the k between them, and 33, 40, 64, 100,
     which run in rounds) at a ragged shape, and the rounds bit for bit on
     integer coordinates; the whole call's and each round's time at k=40
     and 64 on the map; exact ties across the kernel's database splits, in
     K1 and K2
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
  8. NDT on the same pair: P2D align on a plain and a stencil-baked target,
     D2D align from the voxelized source, and VGICP on RBF source
     covariances: ms per align, translation error, host syncs per align
     (gate: 0), K6 launches per align, launches and GPU busy from a
     torch.profiler window. K6's count is reset before this phase and read
     after it, and so for each path of phases 9 and 10
  9. LIO-SAM SLAM at bench.py config 6's full shapes (bench.py:720-731:
     512 keyframes with 480 pre-populated, 64 loops, 512 corner / 2048
     surface points a frame, baked local maps; keyframes every 0.3 m, 3 GN
     sweeps of 24 PCG iterations): 32 frames on the fresh and the revisit
     shape, then the revisit shape at 4,096 keyframes (4,064 pre-populated)
     over 8 frames; frames/s, final error, loops, the fresh shape's frame-0
     latch and drift per metre, per-frame p50/p99 and launches, host reads,
     host syncs (gate: every frame exactly its counted reads), K6 launches
     and GPU busy per frame of each class (plain, loop, drain), peak
     memory; then apps/run_slam_offline_torch.py --synthetic 40. K6 runs
     scan-to-map's and NDT's eigendecompositions; K1 and K2 (the local maps'
     k-NN is the voxel hash's) are counted and must stay at 0
 10. prior-map localization at bench.py config 8's full shape (bench.py:
     590-694: the feature world, 64 frames of 512 corner / 2,048 surface
     points on a 3 m circle, constant-velocity prediction, 6 GN
     iterations): frames/s, per-frame p50/p99, launches, host syncs and GPU
     busy a frame, K6 launches a frame, peak memory, max error, lost
     frames; the teleport relocalization and its latency; NDT localization
     at run_localization's defaults (8,192 points against the 60,000-point
     room, baked target, 16 frames) with the same fields;
     apps/run_localization_torch.py --synthetic 16 with --method ndt and
     loam. Gates: error < 0.10 m and 0 lost (LOAM chain, NDT chain, both
     apps), relocalization triggered and recovered within 0.05 m, 0 host
     syncs a frame on both chains. K1 and K2 must stay at 0 launches. Then
     K6 against its plain version on the matrices its call sites gave it
     (scan-to-map's eigh and eigvalsh, NDT's eigvalsh; 6 x 6 float32, and
     the same in float64) and on batches of 24 and 1,000 of them turned by
     random rotations: eigenvalues within 1e-5 (f32) / 1e-12 (f64) x
     max|lambda|, projectors within 1e-4 away from the thresholds; K6's ms
     (one call at a time, back to back), its device time a launch (a CUDA
     graph of 100 launches), the wrapper's host time a call and both at
     n = 1 (the launch floor), beside torch.linalg.eigh's
 11. recorded data: tools/make_dataset_torch.py writes a 20-frame LIO
     dataset and its bag under build/; the mapping app's directory, native
     bag and Python bag sources must build the same frames; its three
     replays, the SLAM app on the bag and the localization app on the
     dataset against the mapped PCD must run to finite trajectories (their
     gaps and errors against ground truth reported); the SLAM app on a
     ring-structured bag (io.synthetic.write_ring_bag: 30 sweeps of a
     16 x 1,800 spinning LiDAR ray-cast in a hall) within 0.10 m of the
     ground truth at every frame and keyframe; the C++ oracle's esti_plane
     beside plane_fit on the card
 12. map products (apps/construct_full_map_torch.py): on the keyframes the
     SLAM app saved in phase 9, every product, then config 8's localization
     (64 frames) against the feature tiles it wrote, through the
     localization app's TileMapLoader (gates: < 0.10 m, 0 lost); 100
     synthetic keyframes of 20,000 points (2 M points, 8 downsample chunks)
     at the app's default sizes: per product (downsample, feature tiles, 2-D
     occupancy, 3-D occupancy + .bt) wall, keyframes/s, host syncs, launches
     and GPU busy a keyframe, peak memory, the 3-D map's slot collisions;
     the app with --device cpu against the card on the first 10 keyframes
     (full map 1e-5 m after a sort, tiles byte-identical, grid cells
     listed, .bt leaves); the mapping app with --auto_grid --time_log_file
     on phase 11's dataset and the tuned LIO under the timer (no added
     sync). K1 and K2 must stay at 0 launches
 13. deployed modes: phase 3's tuned LIO with the PHC node (phc_order=2;
     ATE gates as phase 3's; frames/s, syncs and launches a frame) and
     phc_merge on one frame's batch, card against CPU (equal keys and
     centroids); apps/run_mapping_online_torch.py at 20,000 points for 20
     frames against the stream's trajectory (the LIO gates);
     tools/soak_online_torch.py at 20,000 points and 10 Hz for 20 s (frames,
     drops, latency, queue trend; gate: ATE) and
     tools/soak_localization_torch.py for 20 s at config 8's shapes (gates:
     the injected loss recovered, final error < 0.10 m); 60 frames of the
     synthetic KITTI street at 30,000 points through apps/run_kitti_torch.py
     with --algo icp, ndt and vgicp (frames/s, K6 launches a frame; gates:
     KITTI_MAX_ERR_M); the session CLI (start --mode fast --run --synthetic
     20, save-map, pub-occ-map, stop) and its files. K1 and K2 must stay at
     0 launches; K6 is counted in the localization soak and the NDT KITTI
     run
 14. multi-device parallelism: the sharded ICP, LIO update, scan-to-map
     and backend on 4 ranks sharing the card over gloo (mesh (2, 2)) and on
     1 rank over NCCL, against the single device; then the dry run
 15. done

Every timed K1 / K2 shape prints what the wrapper's plan ran it with: the
instance (list length), R (queries per thread, always 1) and S (database
splits).
Each phase prints one line; the kernels' JSON line and the card's
nvidia-smi line come before the last line, which is the result object.
Any failed check raises, so the script exits non-zero. Without a CUDA
device it exits non-zero before doing anything; it imports nothing of JAX
(checked at the end).
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


T_START = time.perf_counter()


def phase(number, name, **fields):
    """One phase line; `t_s` is the script's wall time when it was printed."""
    fields["t_s"] = round(time.perf_counter() - T_START, 1)
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


def cuda_ms_back_to_back(fn, reps=100):
    """Mean time of one call among `reps` queued one behind the other (CUDA
    events around them all): the device's time, without the host's time to
    prepare a call on an idle card that `cuda_ms` includes."""
    import torch

    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps=100, replays=10):
    """The device's time a launch of fn, without the host's time between
    launches that `cuda_ms_back_to_back` includes: `reps` calls of fn (after
    one warm-up call) captured in one CUDA graph, the graph replayed
    `replays` times between two CUDA events, over reps x replays. Every
    launch is timed, and the gap between two kernels of a graph is part of
    the time. fn returns the tensor its kernel writes (or a tuple led by
    one): the check that the graph holds the kernel fills it with NaN and
    replays the graph, which must write the same values again."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            out = fn()
    out = out[0] if isinstance(out, tuple) else out
    graph.replay()
    torch.cuda.synchronize()
    want = out.clone()
    out.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(want).all()) and torch.equal(out, want), "a graph replay did not rerun the kernel")
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (reps * replays)


def host_ms(fn, reps=1000):
    """The host's time a call: `reps` calls queued with no synchronise between
    them on a host clock (one warm-up call before; one synchronise after,
    outside the time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def compare_knn(bf_knn, q, db, k):
    """Kernel vs plain version on the same card tensors. Returns the phase
    fields: max |d2 err|, kernel ms (one call at a time, and back to back),
    plain ms, ms of torch.cdist + torch.topk, the bound, queries clear of
    near-ties, and the plan the wrapper ran; raises when a check fails. No
    single PyTorch call computes a k-NN: cdist + topk, two calls, is timed
    as context only."""
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
    return dict(max_abs_err=float(err.max()), ms=cuda_ms(lambda: bf_knn.knn(q, db, k=k)),
                ms_back_to_back=cuda_ms_back_to_back(lambda: bf_knn.knn(q, db, k=k)),
                plain_ms=cuda_ms(lambda: bf_knn.knn_plain(q, db, k=k)),
                cdist_topk_ms=cuda_ms(lambda: torch.topk(torch.cdist(q.T, db.T), k, dim=1, largest=False)),
                bound_ms=knn_bound_ms(q.shape[1], db.shape[1], k)[0], queries_clear_of_ties=int(clear.sum()),
                **plan_fields(bf_knn, q, db, k))


def plan_fields(bf_knn, q, db, k):
    """What the wrapper runs the kernel with at this shape, for the phase line."""
    layout = bf_knn.plan(q.shape[1], db.shape[1], k)
    if k > bf_knn.MAX_K:
        return dict(rounds=[dict(rows=rows, instance=instance, S=splits) for _, rows, instance, splits in layout], R=1)
    instance, splits = layout
    return dict(instance=instance, R=1, S=splits)


def sweep_k(bf_knn, q, db, ks):
    """K1 against its plain version for every k of `ks` (d2 at rtol 1e-5 /
    atol 1e-6, index sets equal away from near-ties, rows ascending; a k
    above MAX_K runs in rounds). Returns {k: max |d2 err|}; raises on a
    mismatch."""
    import torch

    pd2, pidx = bf_knn.knn_plain(q, db, k=max(ks) + 1)
    errs = {}
    for k in ks:
        d2, idx = bf_knn.knn(q, db, k=k)
        torch.cuda.synchronize()
        check(d2.shape == (k, q.shape[1]) and idx.dtype == torch.int32, f"k={k}: output shape or type")
        check(bool((d2[1:] >= d2[:-1]).all()), f"k={k}: kernel d2 rows not ascending")
        check(bool(torch.allclose(d2, pd2[:k], rtol=1e-5, atol=1e-6)), f"k={k}: d2 differ from the plain version")
        clear = (pd2[k] - pd2[k - 1]) > 1e-6 * pd2[k]
        same = (torch.sort(idx, dim=0).values == torch.sort(pidx[:k], dim=0).values).all(dim=0)
        check(bool(same[clear].all()), f"k={k}: {int((~same & clear).sum())} index sets differ away from ties")
        errs[k] = float((d2 - pd2[:k]).abs().max())
    return errs


def exact_rounds(bf_knn, ks, n=3001, m=20_000):
    """K1 above MAX_K on integer coordinates (exact distances, masses of
    ties across every round edge): d2 and idx equal to knn_plain bit for
    bit at every k of `ks`. Returns the share of queries whose distance at
    the first round edge ties across it; raises on a difference."""
    import torch

    g = np.random.default_rng(9)
    q = torch.from_numpy(g.integers(-8, 9, size=(3, n)).astype(np.float32)).cuda()
    db = torch.from_numpy(g.integers(-8, 9, size=(3, m)).astype(np.float32)).cuda()
    pd2, pidx = bf_knn.knn_plain(q, db, k=max(ks))
    for k in ks:
        d2, idx = bf_knn.knn(q, db, k=k)
        torch.cuda.synchronize()
        check(torch.equal(d2, pd2[:k]) and torch.equal(idx, pidx[:k]), f"k={k}: rounds differ from knn_plain on ties")
    edge = bf_knn.MAX_K
    return float((pd2[edge - 1] == pd2[edge]).float().mean())


def round_times(bf_knn, q, db, k):
    """K1 at k > MAX_K: the whole call's ms (one at a time, back to back) and
    each round's, re-run on the call's own outputs (a round rewrites its rows
    from the final rows before it), with its plan."""
    d2, idx = bf_knn.knn(q, db, k=k)
    rounds = []
    for row0, rows, instance, splits in bf_knn.plan(q.shape[1], db.shape[1], k):
        def one(row0=row0, rows=rows, instance=instance, splits=splits):
            bf_knn.search_round(q, db, d2, idx, row0, rows, instance, splits)
        rounds.append(dict(row0=row0, rows=rows, instance=instance, S=splits, ms=cuda_ms(one),
                           ms_back_to_back=cuda_ms_back_to_back(one)))
    return dict(k=k, n=int(q.shape[1]), m=int(db.shape[1]), ms=cuda_ms(lambda: bf_knn.knn(q, db, k=k)),
                ms_back_to_back=cuda_ms_back_to_back(lambda: bf_knn.knn(q, db, k=k)),
                plain_ms=cuda_ms(lambda: bf_knn.knn_plain(q, db, k=k)),
                bound_ms=knn_bound_ms(q.shape[1], db.shape[1], k)[0], rounds=rounds)


def check_split_ties(bf_knn, cloud, k):
    """Exact ties across the kernel's database splits: 100 points of `cloud`
    are copied into the middle and the last third of the database, which is
    then its own query set. Each copy sees the three at distance 0 and must
    list them in index order (K1), and K2 must return the first. Returns the
    number of splits the plan used; raises on a wrong order."""
    import torch

    db = cloud.clone()
    m = db.shape[1]
    first = torch.arange(100, device=db.device) * 7
    mid, last = m // 2 + first, m - 1 - torch.arange(100, device=db.device) * 5
    db[:, mid] = db[:, first]
    db[:, last] = db[:, first]
    splits = bf_knn.plan(m, m, k)[1]
    chunk = -(-m // splits)
    ranges = [at // chunk for at in (first, mid, last)]
    check(int(ranges[0].max()) < int(ranges[1].min()) and int(ranges[1].max()) < int(ranges[2].min()),
          f"the tie case does not straddle the splits (S={splits})")
    d2, idx = bf_knn.knn(db, db, k=k)
    nd2, nidx = bf_knn.nearest_neighbor(db, db)
    torch.cuda.synchronize()
    want = torch.stack([first, mid, last]).to(torch.int32)
    for at in (first, mid, last):
        check(bool((idx[:3, at] == want).all()), "K1: equal distances across splits are not in index order")
        check(bool((d2[:3, at] == 0).all()), "K1: a copy is not at distance 0")
        check(bool((nidx[at] == want[0]).all()) and bool((nd2[at] == 0).all()),
              "K2: a tie across splits did not keep the lower index")
    pd2, pidx = bf_knn.knn_plain(db, db, k=k)
    check(bool((idx[:, first] == pidx[:, first]).all()), "K1: tie queries differ from the plain version")
    return splits, bf_knn.plan(m, m, 1)[1]


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


def run_lio(cfg, frames, gt, device, timer=False):
    """Frame steps from a fresh state. Returns (state, stats); the steady-state
    fps covers frames 5.. (after IMU init and the first updates). With
    `timer`, `lio_step`'s spans record (`Timer.enable()`), as the mapping
    app's `--time_log_file` has them."""
    import torch

    from pointcloud_slam_tpu_torch.models import lio
    from pointcloud_slam_tpu_torch.utils.timer import Timer

    s = lio.create_state(cfg, device=device)
    outs = []
    syncs0 = lio.lio_step.host_syncs
    Timer.enable(timer)
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
            Timer.enable(False)
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


def k6_launches():
    """K6's launch count: its two wrappers, `eigh` and `eigvalsh`."""
    from pointcloud_slam_tpu_torch.ops import small_eigh

    return small_eigh.eigh.launches + small_eigh.eigvalsh.launches


def reset_k6():
    from pointcloud_slam_tpu_torch.ops import small_eigh

    small_eigh.eigh.launches = small_eigh.eigvalsh.launches = 0


def capture_eigh_inputs(fn):
    """fn() with every matrix batch K6 is launched on recorded: [(A, with
    eigenvectors)], copies of the call sites' own inputs."""
    from pointcloud_slam_tpu_torch.ops import small_eigh

    seen, launch = [], small_eigh._launch

    def spy(A, vectors):
        seen.append((A.detach().clone(), vectors))
        return launch(A, vectors)

    small_eigh._launch = spy
    try:
        fn()
    finally:
        small_eigh._launch = launch
    return seen


def k6_bound_ms(A, vectors):
    """The least time an H100 could take for K6 on A (B, n, n): the larger of
    the bytes it must move (A read once, w and V written once) over 3.35
    TB/s and the operations of the sweeps this data needs (counted with
    `eigh_jacobi_mirror` on the same input; every pair is rotated each
    sweep, a = 0 pair as the identity) over 67 TFLOP/s (FP32) or 33.5
    (FP64). A rotation is 12 n + 5 operations with the eigenvectors, 6 n + 5
    without: its angle 13 (3 divisions and 2 square roots counted as one
    each), the two diagonal updates 4, and 6 for each other row of A and of
    V. Returns (ms, "bytes" or "operations"); a single launch's latency lies
    far above either."""
    from pointcloud_slam_tpu_torch.ops import small_eigh

    B, n = A.reshape(-1, A.shape[-1], A.shape[-1]).shape[:2]
    size = A.element_size()
    by = size * B * (n * n + n + (n * n if vectors else 0))
    sweeps = int(small_eigh.eigh_jacobi_mirror(A)[2].sum())
    ops = sweeps * n * (n - 1) // 2 * ((12 * n + 5) if vectors else (6 * n + 5))
    t_bytes, t_ops = by / 3.35e12 * 1e3, ops / (67e12 if size == 4 else 33.5e12) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare_eigh(A, thresholds):
    """K6 against its plain version (torch.linalg.eigh) on card tensors A
    (..., n, n), float32 and float64: eigenvalues within 1e-5 / 1e-12 x
    max|lambda|, eigvalsh's within the same of eigh's, projectors
    V diag(w > t) V^T within 1e-4 for each t of `thresholds` on the matrices
    with no eigenvalue within 1e-3 relative of t. Returns the max errors;
    raises when a check fails."""
    import torch

    from pointcloud_slam_tpu_torch.ops import small_eigh

    out = {}
    for name, dt, tol in (("f32", torch.float32, 1e-5), ("f64", torch.float64, 1e-12)):
        a = A.to(dt)
        w, V = small_eigh.eigh(a)
        wv = small_eigh.eigvalsh(a)
        torch.cuda.synchronize()
        wp, Vp = small_eigh.eigh_plain(a)
        scale = wp.abs().amax(dim=-1, keepdim=True)
        rel = float(((w - wp).abs() / scale).max())
        rel_v = float(((wv - wp).abs() / scale).max())
        check(rel <= tol and rel_v <= tol, f"K6 {name}: eigenvalues off by {rel} / {rel_v} x max|lambda| (tol {tol})")
        proj, clear_n = 0.0, 0
        for t in thresholds:
            clear = ((wp - t).abs() > 1e-3 * abs(t)).all(dim=-1)
            P = (V * (w > t).to(dt)[..., None, :]) @ V.mT
            Pp = (Vp * (wp > t).to(dt)[..., None, :]) @ Vp.mT
            if bool(clear.any()):
                proj = max(proj, float((P - Pp)[clear].abs().max()))
            clear_n += int(clear.sum())
        check(proj <= 1e-4, f"K6 {name}: projectors differ by {proj}")
        out[name] = dict(eig_rel_err=rel, eigvalsh_rel_err=rel_v, eig_abs_err=float((w - wp).abs().max()),
                         projector_err=proj, projectors_compared=clear_n)
    return out


def k6_times(A, floor):
    """K6's ms on A (one call at a time, back to back), its device time a
    launch (`device_ms`) and the wrapper's host time a call (`host_ms`),
    `floor` (the same two at n = 1, where the kernel rotates nothing),
    eigvalsh's ms, the plain version's, which is the library call
    (torch.linalg.eigh, reading its info back), torch.linalg.eigvalsh's, and
    the bound."""
    import torch

    from pointcloud_slam_tpu_torch.ops import small_eigh

    bound, bound_by = k6_bound_ms(A, True)
    plain = cuda_ms(lambda: small_eigh.eigh_plain(A), reps=20)
    return dict(batch=int(A.reshape(-1, 6, 6).shape[0]), dtype=str(A.dtype).split(".")[1],
                ms=cuda_ms(lambda: small_eigh.eigh(A), reps=20),
                ms_back_to_back=cuda_ms_back_to_back(lambda: small_eigh.eigh(A)),
                device_ms=device_ms(lambda: small_eigh.eigh(A)),
                host_ms=host_ms(lambda: small_eigh.eigh(A)), floor_ms=floor,
                eigvalsh_ms=cuda_ms(lambda: small_eigh.eigvalsh(A), reps=20), plain_ms=plain, library_ms=plain,
                library_eigvalsh_ms=cuda_ms(lambda: torch.linalg.eigvalsh(A), reps=20),
                bound_ms=bound, bound_by=bound_by)


def k6_floor(dev, dtype):
    """K6's launch floor on this path: `device_ms` and `host_ms` of `eigh` on
    one 1 x 1 matrix, where the kernel does no rotation."""
    import torch

    from pointcloud_slam_tpu_torch.ops import small_eigh

    one = torch.ones(1, 1, 1, dtype=dtype, device=dev)
    return dict(device_ms=device_ms(lambda: small_eigh.eigh(one)),
                host_ms=host_ms(lambda: small_eigh.eigh(one)))


def run_k6_check(dev, loam_inputs, ndt_inputs):
    """K6 against its plain version on the matrices its call sites gave it
    on the main path (one LOAM frame's scan-to-map eigh and eigvalsh, one
    NDT align's eigvalsh) and on batches of 24 and 1,000 of them turned by
    random rotations, at the thresholds 1.0 (config 8) and 100 (the SLAM
    default); then its times at batch 1 (f32, f64), 24 and 1,000, each with
    the launch floor of its dtype. Returns (errors, times)."""
    import torch

    sites = {"scan_to_map_eigh": [a for a, v in loam_inputs if v],
             "scan_to_map_eigvalsh": [a for a, v in loam_inputs if not v],
             "ndt_eigvalsh": [a for a, _ in ndt_inputs]}
    check(all(sites.values()) and all(a.shape == (6, 6) for v in sites.values() for a in v),
          f"K6 call sites: {({k: [tuple(a.shape) for a in v] for k, v in sites.items()})}")
    g = np.random.default_rng(6)
    Q = torch.from_numpy(np.linalg.qr(g.normal(size=(1000, 6, 6)))[0].astype(np.float32)).to(dev)
    every = torch.stack([a for v in sites.values() for a in v])
    batches = {b: (Q[:b] @ every.repeat(-(-b // len(every)), 1, 1)[:b] @ Q[:b].mT).contiguous() for b in (24, 1000)}
    errors = {name: compare_eigh(torch.stack(v), (1.0, 100.0)) for name, v in sites.items()}
    errors.update({f"batch_{b}": compare_eigh(h, (1.0, 100.0)) for b, h in batches.items()})
    h1 = sites["scan_to_map_eigh"][0].reshape(1, 6, 6).contiguous()
    f32, f64 = k6_floor(dev, torch.float32), k6_floor(dev, torch.float64)
    times = {"batch_1_f32": k6_times(h1, f32), "batch_1_f64": k6_times(h1.double(), f64),
             "batch_24_f32": k6_times(batches[24], f32), "batch_1000_f32": k6_times(batches[1000], f32)}
    return errors, times


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


def run_ndt(dev):
    """NDT on align_bench's pair (apps/align_bench.py:102-109: resolution 1 m,
    target capacity 1<<15): P2D on the plain target (as SLAM's RS loop
    verification builds it) and on the stencil-baked one, D2D from the
    voxelized source, VGICP on RBF source covariances (kernel width 0.5 m)."""
    import torch

    from apps.align_bench_torch import make_pair
    from pointcloud_slam_tpu_torch import register

    src_t, tgt_t, mask, t_true, fit_grid, fit_map = make_pair(17_000, dev)
    ncfg = register.NDTConfig(resolution=1.0)
    build_ms, (pg, pmap) = timed(lambda: register.ndt.build_target(ncfg, tgt_t, capacity=1 << 15), 3)
    bake_ms, (bg, bmap) = timed(lambda: register.ndt.build_target(ncfg, tgt_t, capacity=1 << 15, baked=True), 1)
    vox_ms, (sm, sc, sv, _) = timed(lambda: register.ndt.voxelize_source(ncfg, src_t), 3)
    rbf_ms, cov_rbf = timed(lambda: register.source_covariances_rbf(src_t, mask, resolution=1.0, kernel_width=0.5), 3)
    check(bool(torch.isfinite(cov_rbf).all()), "non-finite RBF covariance")
    vcfg = register.VGICPConfig(resolution=1.0)
    vg, vmap = register.vgicp.build_target(vcfg, tgt_t, capacity=1 << 15, baked=True)
    out = dict(target_build_ms=build_ms, baked_target_build_ms=bake_ms, voxelize_source_ms=vox_ms,
               source_voxels=int(sv.sum()), rbf_cov_ms=rbf_ms)
    # gates: tests/test_registration.py (P2D 0.1 m, D2D 0.15 m, RBF 0.15 m)
    solves = {"p2d_plain": (lambda: register.ndt.align(pg, pmap, src_t, cfg=ncfg), 0.1),
              "p2d_baked": (lambda: register.ndt.align(bg, bmap, src_t, cfg=ncfg), 0.1),
              "d2d_baked": (lambda: register.ndt.align_d2d(bg, bmap, sm, sc, sv, cfg=ncfg), 0.15),
              "vgicp_rbf_cov": (lambda: register.vgicp.align(vg, vmap, src_t, cov_rbf, mask, cfg=vcfg), 0.15)}
    for name, (solve, gate) in solves.items():
        ms, res = timed(solve, 5)
        k6 = k6_launches()
        _, syncs = count_syncs(solve)
        k6 = k6_launches() - k6
        check(syncs == 0, f"{name}: {syncs} host syncs an align (K6 replaced the eigvalsh read)")
        check(bool(torch.isfinite(res.pose.R).all() and torch.isfinite(res.pose.t).all()), f"{name}: non-finite pose")
        terr = float(np.linalg.norm(res.pose.t.cpu().numpy() - t_true))
        check(terr < gate, f"{name}: terr {terr} >= {gate} m")
        fitness, _ = register.fitness_score(fit_grid, fit_map, res.pose.apply(src_t), mask, max_range=1.0)
        launches, busy, wall, top = profile_launches(solve)
        out[name] = dict(ms_per_align=ms, terr_m=terr, fitness=float(fitness), iterations=int(res.iterations),
                         syncs_per_align=syncs, k6_launches_per_align=k6,
                         profile=dict(launches=launches, gpu_busy_ms=busy, wall_ms=wall, idle_share=1 - busy / wall,
                                      top_device_ms=top))
    check(out["p2d_plain"]["k6_launches_per_align"] == 1 and out["d2d_baked"]["k6_launches_per_align"] == 1,
          "NDT aligns: not one K6 launch an align")
    return out, capture_eigh_inputs(solves["p2d_baked"][0])


SLAM_KF_DT = 0.5           # pre-populated keyframe spacing in time [s] (bench.py:711)
SLAM_KF_ANG = 0.04 * 1.5   # revisit keyframe spacing on the circle [rad] (bench.py:803)


def slam_config(max_keyframes):
    """bench.py config 6 (bench.py:720-731) on the port."""
    from pointcloud_slam_tpu_torch.models.liosam import backend as bk
    from pointcloud_slam_tpu_torch.models.liosam import scan2map as s2m
    from pointcloud_slam_tpu_torch.models.liosam import slam

    base = s2m.Scan2MapConfig()
    return slam.SLAMConfig(
        backend=bk.BackendConfig(max_keyframes=max_keyframes, max_loops=64, keyframe_dist_thresh=0.3,
                                 gn_iterations=3, pcg_iterations=24),
        n_corner=512, n_surf=2048,
        scan2map=s2m.Scan2MapConfig(corner_grid=s2m.baked_grid(base.corner_grid),
                                    surf_grid=s2m.baked_grid(base.surf_grid)))


def slam_circle(ang):
    return np.array([6.0 * np.cos(ang) - 6.0, 6.0 * np.sin(ang), 1.0], np.float32)


def slam_scan(world, t, seed):
    """bench.py's scan_at: 512 corner and 2048 surface points seen from t (identity attitude)."""
    from pointcloud_slam_tpu_torch.io import synthetic

    eye = np.eye(3, dtype=np.float32)
    c, cm = synthetic.take_scan(world[0], eye, t, 512, seed=seed)
    s, sm = synthetic.take_scan(world[1], eye, t, 2048, seed=1000 + seed)
    return c, cm, s, sm


def slam_populated(cfg, dev, shape, n_pre, world):
    """bench.py's populate (bench.py:748-784): n_pre keyframes with their
    odometry factors, feature stores, one batched ScanContext descriptor
    call, 0.5 s stamps, and local maps from the surrounding-keyframe rebuild.
    shape "fresh": a straight approach along -y ending at the circle start,
    real scans on its last ~30 keyframes and noise clouds before (far out of
    RS range); "revisit": n_pre keyframes along the circle the frames
    continue. Returns (state, angle of the first measured frame)."""
    import torch

    from pointcloud_slam_tpu_torch.geom import se3
    from pointcloud_slam_tpu_torch.models.liosam import scancontext as sc
    from pointcloud_slam_tpu_torch.models.liosam import slam

    KF = cfg.backend.max_keyframes
    rng = np.random.default_rng(7)
    if shape == "fresh":
        ys = -0.32 * np.arange(n_pre - 1, -1, -1) - 0.35
        poses = np.stack([np.zeros(n_pre), ys, np.ones(n_pre)], 1).astype(np.float32)
        ang0 = 0.0
    else:
        poses = np.stack([slam_circle(SLAM_KF_ANG * i) for i in range(n_pre)]).astype(np.float32)
        ang0 = SLAM_KF_ANG * n_pre
    kf_c = np.zeros((KF, 3, cfg.n_corner), np.float32)
    kf_cm = np.zeros((KF, cfg.n_corner), bool)
    kf_s = np.zeros((KF, 3, cfg.n_surf), np.float32)
    kf_sm = np.zeros((KF, cfg.n_surf), bool)
    for i in range(n_pre):
        if shape == "revisit" or poses[i, 1] > -10.0:
            c, cm, s, sm = slam_scan(world, poses[i], (6000 if shape == "revisit" else 5000) + i)
        else:
            c = rng.uniform(-8, 8, (cfg.n_corner, 3)).astype(np.float32) + poses[i]
            s = rng.uniform(-8, 8, (cfg.n_surf, 3)).astype(np.float32) + poses[i]
            cm, sm = np.ones(cfg.n_corner, bool), np.ones(cfg.n_surf, bool)
        kf_c[i], kf_cm[i], kf_s[i], kf_sm[i] = c.T, cm, s.T, sm
    t_all = np.zeros((KF, 3), np.float32)
    t_all[:n_pre] = poses
    odom_t = np.zeros((KF, 3), np.float32)
    odom_t[1:n_pre] = poses[1:] - poses[:-1]
    oinfo = np.zeros((KF, 6), np.float32)
    oinfo[1:n_pre] = [1e6] * 3 + [1e4] * 3
    kf_time = np.zeros(KF, np.float32)
    kf_time[:n_pre] = np.arange(n_pre) * SLAM_KF_DT

    def dv(a):
        return torch.from_numpy(a).to(dev)

    kf_s_d, kf_sm_d = dv(kf_s), dv(kf_sm)
    descs, keys = sc.make_descriptor(cfg.scancontext, kf_s_d, kf_sm_d)      # one batched call
    state = slam.create_state(cfg, device=dev)
    graph = state.graph._replace(t=dv(t_all), n=torch.full((), n_pre, dtype=torch.int32, device=dev),
                                 odom_t=dv(odom_t), odom_info=dv(oinfo))
    state = state._replace(
        graph=graph, kf_corner=dv(kf_c), kf_corner_mask=dv(kf_cm), kf_surf=kf_s_d, kf_surf_mask=kf_sm_d,
        sc_descs=descs, sc_keys=keys, kf_time=dv(kf_time), pose=se3.Pose(state.pose.R, dv(poses[-1])),
        frame_idx=torch.full((), int(n_pre * SLAM_KF_DT / cfg.nominal_scan_period), dtype=torch.int32, device=dev))
    cmap, smap = slam._rebuild_maps(cfg, state, state.graph, state.graph.t[n_pre - 1])
    return state._replace(corner_map=cmap, surf_map=smap), ang0


def slam_frames(dev, world, ang0, n_frames):
    """The measured frames (bench.py:808-816): scans along the circle from
    ang0 in steps of 0.04 rad, on the card, and their true positions."""
    import torch

    frames, gts = [], []
    for k in range(n_frames):
        t = slam_circle(ang0 + 0.04 * k)
        c, cm, s, sm = slam_scan(world, t, k)
        frames.append(tuple(torch.from_numpy(np.ascontiguousarray(a.T) if a.ndim == 2 else a).to(dev)
                            for a in (c, cm, s, sm)))
        gts.append(t)
    return frames, np.stack(gts)


def slam_classes(outs):
    """Frame classes as bench.py:872-882 splits them: "loop" (a loop factor
    landed), "drain" (a deferred sweep ran: sweeps pending after the frame,
    or pending before it), else "plain"."""
    looped = [bool(o.loop_detected) for o in outs]
    pending = [int(o.opt_pending) for o in outs]
    return ["loop" if lp else ("drain" if p > 0 or (k > 0 and pending[k - 1] > 0) else "plain")
            for k, (lp, p) in enumerate(zip(looped, pending))]


def run_slam_shape(cfg, dev, shape, n_pre, n_frames, world, profiled_per_class=2):
    """One shape: populate, warm up on 3 frames from the populated state
    (slam_step returns new tensors, so the state is reused), then three
    passes over the frames from it: timed (a synchronize after each frame);
    under torch.profiler for the first `profiled_per_class` frames of each
    class (launches, GPU busy, top device ops; a profiler's own setup and
    teardown cost seconds a frame); under the CUDA sync debugger frame by
    frame (host syncs, and the step's own reads, `slam_step.host_reads`).
    Returns the phase's fields."""
    import torch

    from pointcloud_slam_tpu_torch.models.liosam import slam
    from pointcloud_slam_tpu_torch.ops import bf_knn

    t0 = time.perf_counter()
    state0, ang0 = slam_populated(cfg, dev, shape, n_pre, world)
    frames, gts = slam_frames(dev, world, ang0, n_frames)
    torch.cuda.synchronize()
    populate_s = time.perf_counter() - t0
    st = state0
    for f in frames[:3]:
        st, _ = slam.slam_step(cfg, st, *f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bf_knn.knn.launches = bf_knn.nearest_neighbor.launches = 0

    def replay(step):
        st, outs = state0, []
        for f in frames:
            st, out = step(st, f)
            outs.append(out)
        return st, outs

    lat = []

    def timed_step(st, f):
        t1 = time.perf_counter()
        out = slam.slam_step(cfg, st, *f)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t1) * 1e3)
        return out

    t_pass = time.perf_counter()
    st, outs = replay(timed_step)
    wall = time.perf_counter() - t_pass
    peak = torch.cuda.max_memory_allocated()
    knn_launches = [bf_knn.knn.launches, bf_knn.nearest_neighbor.launches]
    ts = torch.stack([o.pose.t for o in outs]).cpu().numpy()
    check(np.isfinite(ts).all() and bool(torch.isfinite(st.graph.t).all()), f"SLAM {shape}: non-finite poses")
    check(knn_launches == [0, 0], f"SLAM {shape}: K1/K2 launched {knn_launches} times (no caller on this path)")
    classes = slam_classes(outs)
    errs = np.linalg.norm(ts - gts, axis=1)
    res = dict(frames=n_frames, keyframes_before=n_pre, keyframes_after=int(st.graph.n),
               frames_per_s=n_frames / wall, final_err_m=float(errs[-1]), loops=int(st.n_loops_found),
               populate_s=populate_s, peak_mem_gib=peak / 2 ** 30, k1_k2_launches=knn_launches)
    if shape == "fresh":
        path = float(np.sum(np.linalg.norm(np.diff(gts, axis=0), axis=1)))
        res.update(frame0_latch_m=float(errs[0]), drift_m_per_m=float((errs[-1] - errs[0]) / max(path, 1e-9)))

    t_passes = [time.perf_counter()]
    chosen = set()
    for c in ("plain", "loop", "drain"):
        chosen.update([k for k, x in enumerate(classes) if x == c][:profiled_per_class])
    prof = {}

    def profiled_step(st, f):
        k = len(prof_seen)
        prof_seen.append(k)
        if k not in chosen:
            return slam.slam_step(cfg, st, *f)
        box = []
        prof[k] = profile_launches(lambda: box.append(slam.slam_step(cfg, st, *f)))
        return box[0]

    prof_seen = []
    _, outs_p = replay(profiled_step)
    t_passes.append(time.perf_counter())
    syncs = []

    def counted_step(st, f):
        r0, k0 = slam.slam_step.host_reads, k6_launches()
        out, n = count_syncs(lambda: slam.slam_step(cfg, st, *f))
        syncs.append((n, slam.slam_step.host_reads - r0, k6_launches() - k0))
        return out

    _, outs_s = replay(counted_step)
    t_passes.append(time.perf_counter())
    per_class = {}
    for c in ("plain", "loop", "drain"):
        sel = [k for k, x in enumerate(classes) if x == c]
        if not sel:
            continue
        sel_p = [k for k, x in enumerate(slam_classes(outs_p)) if x == c and k in prof]
        sel_s = [k for k, x in enumerate(slam_classes(outs_s)) if x == c]
        ms = np.asarray(lat)[sel]
        top = {}
        for k in sel_p:
            for name_, t in prof[k][3]:
                top[name_] = top.get(name_, 0.0) + t / len(sel_p)
        busy = float(np.mean([prof[k][1] for k in sel_p])) if sel_p else float("nan")
        per_class[c] = dict(
            count=len(sel), p50_ms=float(np.percentile(ms, 50)), p99_ms=float(np.percentile(ms, 99)),
            profiled_frames=len(sel_p),
            launches_per_frame=float(np.mean([prof[k][0] for k in sel_p])) if sel_p else None,
            gpu_busy_ms_per_frame=busy, idle_share=1 - busy / float(np.mean(ms)),
            top_device_ms=sorted(([n_, t] for n_, t in top.items()), key=lambda e: -e[1])[:3],
            host_syncs_per_frame=float(np.mean([syncs[k][0] for k in sel_s])) if sel_s else None,
            step_reads_per_frame=float(np.mean([syncs[k][1] for k in sel_s])) if sel_s else None,
            k6_launches_per_frame=float(np.mean([syncs[k][2] for k in sel_s])) if sel_s else None)
    # no read besides the step's own: scan-to-map's and NDT's eigendecompositions are K6
    bad = [(k, n, r) for k, (n, r, _) in enumerate(syncs) if n != r]
    check(not bad, f"SLAM {shape}: frames (index, syncs, counted reads) with syncs other than their reads: {bad}")
    check(all(k6 >= 1 for _, _, k6 in syncs), f"SLAM {shape}: a frame never launched K6")
    res["per_class"] = per_class
    # the whole pass's GPU busy, each class's per-frame busy weighted by its frame count
    busy_all = sum(v["gpu_busy_ms_per_frame"] * v["count"] for v in per_class.values())
    res["profile"] = dict(gpu_busy_ms=busy_all, unprofiled_wall_ms=wall * 1e3, idle_share=1 - busy_all / (wall * 1e3))
    res["pass_s"] = dict(timed=wall, profiled=t_passes[1] - t_passes[0], sync_counted=t_passes[2] - t_passes[1])
    return res, errs


LOC_FRAMES = 64            # bench.py config 8's chain length (bench.py:605)
LOC_NDT_FRAMES = 16        # run_localization's synthetic replay, 16 frames
LOC_NDT_POINTS = 8192      # run_localization's --n_points default
REPLAY_MAX_ERR_M = 0.05    # each recorded replay's LIO trajectory against gt_traj.txt
LIO_SPANS = ["lio_step", "lio_step.downsample", "lio_step.insert", "lio_step.knn", "lio_step.plane_fit",
             "lio_step.propagate", "lio_step.residuals", "lio_step.undistort", "lio_step.update"]   # the CSV's columns
RING_BAG_FRAMES = 30       # io.synthetic.write_ring_bag's sweeps (16 x 1,800 rays each) ...
RING_BAG_MAX_ERR_M = 0.10  # ... and the SLAM app's bound on them at every frame and keyframe


def loc_config():
    """bench.py config 8's LocalizationConfig (bench.py:610-612): 6 GN
    iterations, degeneracy threshold 1.0, the default corner / surface grids."""
    from pointcloud_slam_tpu_torch import register
    from pointcloud_slam_tpu_torch.models.liosam import scan2map as s2m
    from pointcloud_slam_tpu_torch.models.localization import pipeline as loc

    return loc.LocalizationConfig(scan2map=s2m.Scan2MapConfig(solver=register.SolverConfig(max_iterations=6),
                                                             degeneracy_eig=1.0))


def per_frame_fields(lat_ms, n_frames, wall_s, prof, syncs):
    """The phase fields of a sequential chain: frames/s of an unsynchronized
    pass, p50/p99 of a pass synchronized frame by frame, and per frame from
    the profiled and sync-counted frames: launches, GPU busy, idle share
    (busy against the p50), host syncs."""
    p50 = float(np.percentile(lat_ms, 50))
    busy = float(np.mean([p[1] for p in prof]))
    return dict(frames=n_frames, frames_per_s=n_frames / wall_s, p50_ms=p50, p99_ms=float(np.percentile(lat_ms, 99)),
                launches_per_frame=float(np.mean([p[0] for p in prof])), gpu_busy_ms_per_frame=busy,
                idle_share=1 - busy / p50, profiled_frames=len(prof),
                top_device_ms=sorted(([n_, t] for p in prof for n_, t in p[3]), key=lambda e: -e[1])[:3],
                host_syncs_per_frame=float(np.mean(syncs)))


def run_chain(step, frames, dev):
    """A sequential chain three times from its start: a warm-up pass, a pass
    synchronized after each frame (latencies), an unsynchronized pass (wall).
    Returns (results of the last pass, latencies ms, wall s, peak GiB)."""
    import torch

    step(frames, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    step(frames, lat)
    t0 = time.perf_counter()
    outs = step(frames, None)
    torch.cuda.synchronize()
    return outs, lat, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2 ** 30


def run_localization(dev):
    """bench.py config 8 (bench.py:590-694, nothing cut): the feature world
    (seed 3) in corner and surface maps, 64 frames of 512 corner and 2,048
    surface points along a 3 m circle, each matched by localize_loam from
    the constant-velocity prediction (bench.py:636-645); then the teleport
    relocalization (bench.py:666-684). K1 and K2 counted: none on this path."""
    import torch

    from pointcloud_slam_tpu_torch import ops
    from pointcloud_slam_tpu_torch.geom import se3
    from pointcloud_slam_tpu_torch.io import synthetic
    from pointcloud_slam_tpu_torch.models.localization import pipeline as loc
    from pointcloud_slam_tpu_torch.ops import bf_knn

    cfg = loc_config()
    corners_w, surfs_w = synthetic.make_feature_world(seed=3)
    maps = []
    for cloud, g in ((corners_w, cfg.scan2map.corner_grid), (surfs_w, cfg.scan2map.surf_grid)):
        pts = torch.from_numpy(np.ascontiguousarray(cloud.T.astype(np.float32))).to(dev)
        maps.append(ops.insert(g, ops.create(g, device=dev), pts, torch.ones(pts.shape[1], dtype=torch.bool,
                                                                                  device=dev)))
    frames, gts = [], []
    eye = np.eye(3, dtype=np.float32)
    for k in range(LOC_FRAMES):
        ang = 2 * np.pi * k / LOC_FRAMES
        t = np.array([3.0 * np.sin(ang), 3.0 * (1 - np.cos(ang)), 1.0], np.float32)
        c, cm = synthetic.take_scan(corners_w, eye, t, 512, seed=k)
        s, sm = synthetic.take_scan(surfs_w, eye, t, 2048, seed=100 + k)
        frames.append(tuple(torch.from_numpy(np.ascontiguousarray(a.T) if a.ndim == 2 else a).to(dev)
                            for a in (c, cm, s, sm)))
        gts.append(t)
    gts = np.stack(gts)

    def match(pose, prev_t, f):
        return loc.localize_loam(cfg, None, *maps, *f, se3.Pose(pose.R, pose.t + (pose.t - prev_t)))

    def chain(fs, lat):
        p0 = se3.Pose(torch.eye(3, device=dev), torch.from_numpy(gts[0]).to(dev))
        pose, prev_t, outs = p0, p0.t, []
        for f in fs:
            t1 = time.perf_counter()
            res = match(pose, prev_t, f)
            if lat is not None:
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t1) * 1e3)
            pose, prev_t = res.pose, pose.t
            outs.append(res)
        return outs

    bf_knn.knn.launches = bf_knn.nearest_neighbor.launches = 0
    outs, lat, wall, peak = run_chain(chain, frames, dev)
    ts = torch.stack([o.pose.t for o in outs]).cpu().numpy()
    lost = int(torch.stack([o.lost for o in outs]).sum())
    errs = np.linalg.norm(ts - gts, axis=1)
    check(np.isfinite(ts).all(), "localization: non-finite poses")
    prof, syncs, k6 = [], [], []
    for k in (20, 21):
        args = (outs[k - 1].pose, outs[k - 2].pose.t, frames[k])
        prof.append(profile_launches(lambda: match(*args)))
        k0 = k6_launches()
        syncs.append(count_syncs(lambda: match(*args))[1])
        k6.append(k6_launches() - k0)
    check(syncs == [0, 0], f"localization LOAM: {syncs} host syncs a frame (K6 replaced the eigh reads)")
    res = dict(per_frame_fields(lat, LOC_FRAMES, wall, prof, syncs), peak_mem_gib=peak, max_err_m=float(errs.max()),
               mean_err_m=float(errs.mean()), lost_frames=lost, k6_launches_per_frame=float(np.mean(k6)),
               fitness_max=float(torch.stack([o.fitness for o in outs]).max()))
    eigh_inputs = capture_eigh_inputs(lambda: match(*args))

    # relocalization: a teleported guess (+5, +5, +2 m) is lost, the fallback
    # pose (the GPS / initialPose role) re-matches; latency of the sequence
    k = 7
    bad = se3.Pose(torch.eye(3, device=dev), torch.from_numpy(gts[k] + np.array([5.0, 5.0, 2.0], np.float32)).to(dev))
    fb = se3.Pose(torch.eye(3, device=dev), torch.from_numpy(gts[k]).to(dev))

    def recover():
        r1 = loc.localize_loam(cfg, None, *maps, *frames[k], bad)
        r2 = loc.localize_loam(cfg, None, *maps, *frames[k], loc.relocalize(r1, fb))
        return r1.lost, r2.lost, r2.pose.t

    reloc_ms, (l1, l2, t2) = timed(recover, 3)
    res.update(reloc_triggered=bool(l1), reloc_recovered=not bool(l2), reloc_err_m=float(np.linalg.norm(
        t2.cpu().numpy() - gts[k])), reloc_latency_ms=reloc_ms)
    res["k1_k2_launches"] = [bf_knn.knn.launches, bf_knn.nearest_neighbor.launches]
    check(res["k1_k2_launches"] == [0, 0], f"localization launched K1/K2 {res['k1_k2_launches']} times")
    return res, eigh_inputs


def run_localization_ndt(dev):
    """run_localization's NDT mode at its defaults (apps/run_localization.py:
    224-235): 16 frames of 8,192 points of the 60,000-point room seen from
    (0.1 k, 0.05 k, 0), each matched from the previous pose against the
    baked NDT target (capacity 1<<15) with the fitness score on the point
    map; the loss fallback (relocalize) in the chain as in the app. K1 and
    K2 counted: none on this path."""
    import torch

    from pointcloud_slam_tpu_torch import register
    from pointcloud_slam_tpu_torch.geom import se3
    from pointcloud_slam_tpu_torch.io import synthetic
    from pointcloud_slam_tpu_torch.models.localization import pipeline as loc
    from pointcloud_slam_tpu_torch.ops import bf_knn

    cfg = loc.LocalizationConfig(method="ndt")
    bf_knn.knn.launches = bf_knn.nearest_neighbor.launches = 0
    world = synthetic.make_room_cloud(60_000, seed=0)
    w = torch.from_numpy(np.ascontiguousarray(world.T)).to(dev)
    t0 = time.perf_counter()
    grid_cfg, point_map = register.build_target_map(w, grid_cfg=cfg.scan2map.surf_grid)
    ndt_grid, ndt_map = register.ndt.build_target(cfg.ndt, w, capacity=1 << 15, baked=True)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    rng = np.random.default_rng(1)
    scans, gts = [], []
    for k in range(LOC_NDT_FRAMES):
        t = np.array([0.1 * k, 0.05 * k, 0.0], np.float32)
        sel = rng.choice(len(world), LOC_NDT_POINTS, replace=False)
        scans.append(torch.from_numpy(np.ascontiguousarray((world[sel] - t).T)).to(dev))
        gts.append(t)
    gts = np.stack(gts)
    mask = torch.ones(LOC_NDT_POINTS, dtype=torch.bool, device=dev)
    init = se3.identity(device=dev)

    def match(pose, scan):
        return loc.localize_ndt(cfg, ndt_grid, ndt_map, grid_cfg, point_map, scan, mask, pose)

    def chain(fs, lat):
        pose, outs = init, []
        for scan in fs:
            t1 = time.perf_counter()
            res = match(pose, scan)
            pose = loc.relocalize(res, init)
            if lat is not None:
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t1) * 1e3)
            outs.append(res)
        return outs

    outs, lat, wall, peak = run_chain(chain, scans, dev)
    ts = torch.stack([o.pose.t for o in outs]).cpu().numpy()
    errs = np.linalg.norm(ts - gts, axis=1)
    check(np.isfinite(ts).all(), "NDT localization: non-finite poses")
    prof, syncs, k6 = [], [], []
    for k in (8, 9):
        args = (outs[k - 1].pose, scans[k])
        prof.append(profile_launches(lambda: match(*args)))
        k0 = k6_launches()
        syncs.append(count_syncs(lambda: match(*args))[1])
        k6.append(k6_launches() - k0)
    check(syncs == [0, 0], f"NDT localization: {syncs} host syncs a frame (K6 replaced the eigvalsh read)")
    k1_k2 = [bf_knn.knn.launches, bf_knn.nearest_neighbor.launches]
    check(k1_k2 == [0, 0], f"NDT localization launched K1/K2 {k1_k2} times")
    return dict(per_frame_fields(lat, LOC_NDT_FRAMES, wall, prof, syncs), points=LOC_NDT_POINTS, map_build_ms=build_ms,
                peak_mem_gib=peak, max_err_m=float(errs.max()),
                lost_frames=int(torch.stack([o.lost for o in outs]).sum()), k6_launches_per_frame=float(np.mean(k6)),
                max_eigen_min=float(torch.stack([o.max_eigen for o in outs]).min()), k1_k2_launches=k1_k2)


def run_apps(commands, timeout):
    """Start every command at once (each is an app in its own process, and
    each mostly waits on its host); {name: (rc, stdout, stderr)}."""
    procs = {name: subprocess.Popen([sys.executable, *cmd], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True) for name, cmd in commands.items()}
    out = {}
    try:
        for name, p in procs.items():
            so, se = p.communicate(timeout=timeout)
            out[name] = (p.returncode, so, se)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, (rc, so, se) in out.items():
        check(rc == 0, f"{name} failed ({rc}):\n{so}\n{se}")
    return out


def lost_count(stdout):
    return int(stdout.split("lost: ")[1].split()[0])


def load_app(rel, name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compare_replays(dev, seq):
    """The mapping app's three frame sources on the recorded dataset: the
    directory, the bag by the native reader and by the Python one. Masks
    equal; points within 1e-5 m and times within 1e-6 s (the bag holds point
    offsets in whole ns), as tests/test_rosbag.py:242-278 holds them.
    Returns the largest difference of each field."""
    import torch

    app = load_app("apps/run_mapping_offline_torch.py", "smoke_mapping_app")
    args = app.parse_args(["--data_dir", seq, "--bag_file", os.path.join(seq, "data.bag"), "--bag_reader", "native"])
    sources = {"dir": list(app.frames_from_dir(args, dev)), "native": list(app.frames_from_bag(args, dev))}
    args.bag_reader = "python"
    sources["python"] = list(app.frames_from_bag(args, dev))
    diffs = {}
    for name in ("native", "python"):
        check(len(sources[name]) == len(sources["dir"]) > 0, f"replay {name}: {len(sources[name])} frames")
        for (fd, td), (fb, tb) in zip(sources["dir"], sources[name]):
            check(abs(td - tb) < 1e-6, f"replay {name}: stamps {td} / {tb}")
            for field in fd._fields:
                a, b = getattr(fd, field), getattr(fb, field)
                if a.dtype == torch.bool:
                    check(bool((a == b).all()), f"replay {name}: {field} differ")
                    continue
                d = float((a - b).abs().max())
                check(d <= (1e-5 if field == "pts" else 1e-6), f"replay {name}: {field} differ by {d}")
                diffs[f"{name}_{field}"] = max(d, diffs.get(f"{name}_{field}", 0.0))
    return dict(frames=len(sources["dir"]), max_diff=diffs)


def oracle_plane_fit(dev):
    """The C++ oracle's esti_plane on the host beside the port's plane_fit on
    card tensors: 512 noisy 5-point patches; max |coefficient difference|
    (sign-aligned) over the patches both call valid, and the flags agreeing."""
    import torch

    from pointcloud_slam_tpu_torch import native
    from pointcloud_slam_tpu_torch.geom import fit

    rng = np.random.default_rng(0)
    n = 512
    pts = rng.normal(size=(n, 5, 3))
    pts[..., 2] = pts[..., :2] @ [0.1, -0.2] + 1.5 + rng.normal(scale=0.01, size=(n, 5))
    coef, ok = fit.plane_fit(torch.from_numpy(pts.transpose(2, 1, 0).astype(np.float32)).to(dev),
                             torch.ones((5, n), dtype=torch.bool, device=dev), 0.1, 3)
    coef, ok = coef.cpu().numpy(), ok.cpu().numpy()
    err, agree = 0.0, 0
    for i in range(n):
        c_o, ok_o = native.esti_plane(pts[i], threshold=0.1)
        agree += ok_o == bool(ok[i])
        if ok_o and ok[i]:
            err = max(err, float(np.abs(coef[:, i] - np.sign(coef[:3, i] @ c_o[:3]) * c_o).max()))
    check(agree == n and err < 5e-4, f"plane_fit vs oracle: {agree}/{n} flags agree, max diff {err}")
    return dict(patches=n, flags_agree=agree, max_abs_diff=err)


def run_recorded(dev, out_dir):
    """Phase 11: a 20-frame LIO dataset and its bag written by
    tools/make_dataset_torch.py, the mapping app's three replays of it
    (frames compared in this process, then the apps run), SLAM on the bag,
    localization on the dataset against the mapped PCD."""
    from pointcloud_slam_tpu_torch.io import synthetic

    seq = os.path.join(out_dir, "smoke_lio")
    t0 = time.perf_counter()
    mk = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_dataset_torch.py"), "--out", seq,
                         "--frames", "20", "--bag"], capture_output=True, text=True, timeout=600, cwd=ROOT)
    check(mk.returncode == 0, f"make_dataset_torch failed ({mk.returncode}):\n{mk.stdout}\n{mk.stderr}")
    res = dict(dataset_s=time.perf_counter() - t0, bag_mib=os.path.getsize(os.path.join(seq, "data.bag")) / 2 ** 20)
    ring_bag = os.path.join(out_dir, "smoke_ring.bag")
    _, ring_R, ring_t = synthetic.write_ring_bag(ring_bag, n_frames=RING_BAG_FRAMES)
    res["frames"] = compare_replays(dev, seq)
    bag = os.path.join(seq, "data.bag")
    trajs = {name: os.path.join(out_dir, f"smoke_replay_{name}.txt") for name in ("dir", "native", "python")}
    map_file = os.path.join(out_dir, "smoke_map.pcd")
    mapping = os.path.join(ROOT, "apps", "run_mapping_offline_torch.py")
    apps = run_apps({
        "dir": [mapping, "--data_dir", seq, "--traj_log_file", trajs["dir"], "--map_file", map_file],
        "native": [mapping, "--bag_file", bag, "--bag_reader", "native", "--traj_log_file", trajs["native"]],
        "python": [mapping, "--bag_file", bag, "--bag_reader", "python", "--traj_log_file", trajs["python"]],
        "slam": [os.path.join(ROOT, "apps", "run_slam_offline_torch.py"), "--bag_file", bag, "--out_dir",
                 os.path.join(out_dir, "smoke_slam_bag")],
        "slam_ring": [os.path.join(ROOT, "apps", "run_slam_offline_torch.py"), "--bag_file", ring_bag, "--out_dir",
                      os.path.join(out_dir, "smoke_slam_ring"), "--save_artifacts"]}, timeout=600)
    # each replay is held to the ground truth, not to the others within 1e-3 m:
    # the three sources' point times differ by up to one float32 ulp, which
    # can make the update's convergence test (1e-3 a state dimension) stop an
    # iteration earlier or later; the maps then part and the replays land
    # millimetres apart, the JAX package's replays of the same files too
    # (ROADMAP.md §3)
    rows = {name: np.loadtxt(path) for name, path in trajs.items()}
    gt = np.loadtxt(os.path.join(seq, "gt_traj.txt"))
    for name, r in rows.items():
        check(r.shape == (20, 8) and np.isfinite(r).all(), f"replay {name}: trajectory {r.shape}")
    err = {name: float(np.linalg.norm(r[:, 1:4] - gt[:, 1:4], axis=1).max()) for name, r in rows.items()}
    check(max(err.values()) < REPLAY_MAX_ERR_M, f"replays' max error against ground truth {err} m "
                                                f"(gate: < {REPLAY_MAX_ERR_M} m)")
    gap = {name: float(np.abs(rows[name][:, 1:4] - rows["dir"][:, 1:4]).max()) for name in ("native", "python")}
    slam_rows = np.loadtxt(os.path.join(out_dir, "smoke_slam_bag", "traj_tum.txt"))
    check(slam_rows.shape == (20, 8) and np.isfinite(slam_rows).all(), "SLAM bag replay: trajectory")
    # SLAM on a ring-structured bag, held to the ground truth at every frame and keyframe
    ring_gt = np.einsum("ji,nj->ni", ring_R[0], ring_t - ring_t[0])
    ring_est = np.loadtxt(os.path.join(out_dir, "smoke_slam_ring", "traj_tum.txt"))[:, 1:4]
    ring_kf = np.loadtxt(os.path.join(out_dir, "smoke_slam_ring", "poses_kitti.txt")).reshape(-1, 3, 4)[:, :, 3]
    check(ring_est.shape == ring_gt.shape, f"SLAM ring bag: trajectory {ring_est.shape}")
    ring_err = np.linalg.norm(ring_est - ring_gt, axis=1)
    kf_frame = [int(np.argmin(np.linalg.norm(ring_est - p, axis=1))) for p in ring_kf]
    kf_err = np.linalg.norm(ring_kf - ring_gt[kf_frame], axis=1)
    res["slam_ring_bag"] = dict(frames=len(ring_est), keyframes=len(ring_kf), max_err_m=float(ring_err.max()),
                                keyframe_max_err_m=float(kf_err.max()), gate_m=RING_BAG_MAX_ERR_M)
    check(ring_err.max() < RING_BAG_MAX_ERR_M and kf_err.max() < RING_BAG_MAX_ERR_M,
          f"SLAM ring bag: {res['slam_ring_bag']}")
    res.update(replay_err_vs_gt_m=err, replay_traj_gap_m=gap,
               apps={name: so.strip().splitlines()[0] for name, (_, so, _) in apps.items()})
    # feature-LOAM localization on the ring bag's sweeps against the tiles of
    # the SLAM replay's keyframes, held to the same bound, none lost
    from pointcloud_slam_tpu_torch.io import pcd

    ring_tiles, ring_frames = os.path.join(out_dir, "smoke_ring_tiles"), os.path.join(out_dir, "smoke_ring_frames")
    run_apps({"ring_tiles": [os.path.join(ROOT, "apps", "construct_full_map_torch.py"),
                             os.path.join(out_dir, "smoke_slam_ring"), "--out",
                             os.path.join(out_dir, "smoke_ring_full.pcd"), "--feature_maps", ring_tiles]}, timeout=600)
    os.makedirs(ring_frames, exist_ok=True)
    box = synthetic.make_box_world(0)
    for k in range(RING_BAG_FRAMES):   # the bag's sweeps (write_ring_bag's seeds), sensor frame
        sweep, _, _ = synthetic.spinning_scan(box, ring_R[k], ring_t[k], seed=k)
        pcd.write_pcd(os.path.join(ring_frames, f"frame_{k:06d}.pcd"), sweep)
    loc = os.path.join(ROOT, "apps", "run_localization_torch.py")
    loc_app = run_apps({"localization": [loc, "--map_pcd", map_file, "--data_dir", seq, "--out_dir",
                                         os.path.join(out_dir, "smoke_loc_recorded")],
                        "loc_ring": [loc, "--feature_map_dir", ring_tiles, "--data_dir", ring_frames, "--n_points",
                                     str(len(sweep)), "--out_dir", os.path.join(out_dir, "smoke_loc_ring")]},
                       timeout=600)
    res["apps"]["localization"] = loc_app["localization"][1].strip().splitlines()[0]
    loc_est = np.loadtxt(os.path.join(out_dir, "smoke_loc_ring", "traj_tum.txt"))[:, 1:4]
    check(loc_est.shape == ring_gt.shape, f"localization ring bag: trajectory {loc_est.shape}")
    res["loc_ring_bag"] = dict(frames=len(loc_est), max_err_m=float(np.linalg.norm(loc_est - ring_gt, axis=1).max()),
                               lost=lost_count(loc_app["loc_ring"][1]), gate_m=RING_BAG_MAX_ERR_M,
                               app=next(ln for ln in loc_app["loc_ring"][1].splitlines() if "lost:" in ln))
    check(res["loc_ring_bag"]["max_err_m"] < RING_BAG_MAX_ERR_M and res["loc_ring_bag"]["lost"] == 0,
          f"feature-LOAM localization on the ring bag: {res['loc_ring_bag']}")
    res["plane_fit_vs_oracle"] = oracle_plane_fit(dev)
    return res


MAP_KEYFRAMES = 100        # phase 12's full-size keyframes ...
MAP_POINTS = 20_000        # ... of this many points each (2 M points, 8 downsample chunks)
MAP_CMP_KEYFRAMES = 10     # the card against the CPU on the first ones
MAP_LOC_FRAMES = 64        # localization on the app's tiles: bench.py config 8's chain length


def map_keyframes(out_dir, n, n_pts):
    """n keyframes of n_pts points of the 30 m room (make_room_cloud, 400,000
    points) seen from a 33.9 m diagonal (-12, -12, 1.5) -> (12, 12, 1.5),
    heading along it with a +-0.3 rad sway, range-gated at 30 m
    (make_scan_from_world): Scans/%06d.pcd in the sensor frame, every tenth
    point again as %06d_corner.pcd, and the exact poses in poses_kitti.txt."""
    from pointcloud_slam_tpu_torch.io import pcd, synthetic

    world = synthetic.make_room_cloud(400_000, seed=7, size=30.0)
    os.makedirs(os.path.join(out_dir, "Scans"), exist_ok=True)
    rows = []
    for k in range(n):
        s = k / (n - 1)
        pos = np.array([-12.0 + 24.0 * s, -12.0 + 24.0 * s, 1.5])
        yaw = np.pi / 4 + 0.3 * np.sin(6 * np.pi * s)
        R = np.array([[np.cos(yaw), -np.sin(yaw), 0.0], [np.sin(yaw), np.cos(yaw), 0.0], [0.0, 0.0, 1.0]])
        pts = (synthetic.make_scan_from_world(world, pos, max_range=30.0, seed=k, n_out=n_pts) @ R).astype(np.float32)
        pcd.write_pcd(os.path.join(out_dir, "Scans", f"{k:06d}.pcd"), pts)
        pcd.write_pcd(os.path.join(out_dir, "Scans", f"{k:06d}_corner.pcd"), pts[::10])
        rows.append(np.hstack([R, pos[:, None]]).reshape(-1))
    np.savetxt(os.path.join(out_dir, "poses_kitti.txt"), np.stack(rows))


def maps_chain(dev, kf_dir):
    """Phase 12, item 1: apps/construct_full_map_torch.py on the SLAM app's
    keyframes (phase 9), then localize_loam at bench.py config 8's shapes
    against the feature tiles it wrote, loaded by the localization app's
    TileMapLoader: 64 frames of 512 corner / 2,048 surface points of the
    SLAM world (make_feature_world(seed=1)) from the same 3 m circle, between
    the SLAM frames, constant-velocity prediction, 6 GN iterations. The SLAM
    run starts at the identity where the world has (0, 0, 1): the ground
    truth is taken in the map's frame."""
    import dataclasses

    import torch

    from pointcloud_slam_tpu_torch import register
    from pointcloud_slam_tpu_torch.geom import se3
    from pointcloud_slam_tpu_torch.io import synthetic
    from pointcloud_slam_tpu_torch.maps import octomap_io
    from pointcloud_slam_tpu_torch.models.localization import pipeline as loc

    fm = os.path.join(kf_dir, "features")
    t0 = time.perf_counter()
    app = run_apps({"maps": [os.path.join(ROOT, "apps", "construct_full_map_torch.py"), kf_dir, "--out",
                             os.path.join(kf_dir, "full.pcd"), "--feature_maps", fm, "--occupancy",
                             os.path.join(kf_dir, "grid"), "--bt", os.path.join(kf_dir, "map.bt")]}, timeout=600)
    res = dict(app_s=time.perf_counter() - t0, app=app["maps"][1].strip().splitlines())
    _, occ_pts, free_pts = octomap_io.load_bt(os.path.join(kf_dir, "map.bt"))
    check(len(occ_pts) > 0 and len(free_pts) > 0, "maps app: empty .bt")
    loc_app = load_app("apps/run_localization_torch.py", "smoke_loc_app")
    args = loc_app.parse_args(["--feature_map_dir", fm, "--synthetic", "1"])
    cfg = loc_app.build_config(args)
    cfg = dataclasses.replace(cfg, scan2map=dataclasses.replace(
        cfg.scan2map, solver=register.SolverConfig(max_iterations=6)))
    loader = loc_app.TileMapLoader(args, cfg, dev)
    corners_w, surfs_w = synthetic.make_feature_world(seed=1)
    eye = np.eye(3, dtype=np.float32)
    origin = np.array([0.0, 0.0, 1.0], np.float32)
    frames, gts = [], []
    for k in range(MAP_LOC_FRAMES):
        ang = 2 * np.pi * (k + 0.5) / MAP_LOC_FRAMES
        t = np.array([3.0 * np.sin(ang), 3.0 * (1 - np.cos(ang)), 1.0], np.float32)
        c, cm = synthetic.take_scan(corners_w, eye, t, 512, seed=k)
        s, sm = synthetic.take_scan(surfs_w, eye, t, 2048, seed=100 + k)
        frames.append(tuple(torch.from_numpy(np.ascontiguousarray(a.T) if a.ndim == 2 else a).to(dev)
                            for a in (c, cm, s, sm)))
        gts.append(t - origin)
    pose = prev_t = None
    outs = []
    t1 = time.perf_counter()
    for k, f in enumerate(frames):
        if pose is None:
            pose = se3.Pose(torch.eye(3, device=dev), torch.from_numpy(gts[0]).to(dev))
            prev_t = pose.t
        x, y = pose.t[:2].tolist()     # tile selection, as the app reads it
        r = loc.localize_loam(cfg, None, *loader.maybe_update_features(x, y), *f,
                              se3.Pose(pose.R, pose.t + (pose.t - prev_t)))
        pose, prev_t = r.pose, pose.t
        outs.append(r)
    ts = torch.stack([o.pose.t for o in outs]).cpu().numpy()
    wall = time.perf_counter() - t1
    errs = np.linalg.norm(ts - np.stack(gts), axis=1)
    lost = int(torch.stack([o.lost for o in outs]).sum())
    res.update(loc_frames=MAP_LOC_FRAMES, loc_frames_per_s=MAP_LOC_FRAMES / wall, loc_max_err_m=float(errs.max()),
               loc_mean_err_m=float(errs.mean()), loc_lost=lost,
               tiles={fam: len(a) for fam, a in loader.feat_areas.items()})
    check(np.isfinite(ts).all() and errs.max() < 0.10 and lost == 0,
          f"localization on the app's tiles: max error {errs.max()} m, {lost} lost (gates: < 0.10 m, 0)")
    return res


def measure_product(fn, window, n_window, n_keyframes):
    """One product over every keyframe: wall, keyframes/s, host syncs a
    keyframe and peak memory; then launches and GPU busy a keyframe from a
    torch.profiler window of n_window keyframes. Returns (fn's result, fields)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, syncs = count_syncs(fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches, busy, pwall, top = profile_launches(window)
    return out, dict(wall_s=wall, keyframes_per_s=n_keyframes / wall, host_syncs_per_keyframe=syncs / n_keyframes,
                     launches_per_keyframe=launches / n_window, gpu_busy_ms_per_keyframe=busy / n_window,
                     idle_share=1 - busy / pwall, peak_mem_gib=peak, profiled_keyframes=n_window, top_device_ms=top)


def map_products(dev, kf_dir):
    """Phase 12, item 2: each product of apps/construct_full_map_torch.py at
    its default sizes (0.2 m leaf in 2^18-point chunks; 50 m feature tiles;
    a 1,024^2 grid at 0.1 m; the 3-D map at 0.2 m with 2^20 slots and 32 free
    steps a beam, then the .bt file) over MAP_KEYFRAMES keyframes, measured
    one by one through the app's own functions."""
    import torch

    from pointcloud_slam_tpu_torch import convert
    from pointcloud_slam_tpu_torch.io import pcd
    from pointcloud_slam_tpu_torch.maps import occupancy, octomap_io, tiled

    app = load_app("apps/construct_full_map_torch.py", "smoke_maps_app")
    out = os.path.join(kf_dir, "products")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    kf = app.load_keyframes(kf_dir, "poses_kitti.txt", dev)
    torch.cuda.synchronize()
    K = len(kf.names)
    res = dict(keyframes=K, points=int(kf.world.shape[1]), load_s=time.perf_counter() - t0)
    cfg = occupancy.OccupancyConfig(size=1024, resolution=0.1, origin=-1024 * 0.1 / 2)
    vcfg = tiled.VoxelOccConfig(capacity=1 << 20, resolution=0.2)

    def downsample():
        full = app.full_map(kf, 0.2)
        pcd.write_pcd(os.path.join(out, "full.pcd"), full)
        return len(full)

    n_full, res["downsample"] = measure_product(downsample, lambda: app.full_map(kf, 0.2), K, K)
    res["downsample"].update(chunks=-(-res["points"] // app.CH), points_out=n_full)
    tiles, res["feature_tiles"] = measure_product(
        lambda: app.feature_maps(kf_dir, kf, os.path.join(out, "features"), 50.0),
        lambda: app.feature_maps(kf_dir, kf.head(8), os.path.join(out, "features_window"), 50.0), 8, K)
    res["feature_tiles"]["families"] = tiles
    _, res["occupancy_2d"] = measure_product(
        lambda: occupancy.save_pgm(cfg, app.occupancy_map(kf, cfg, range(K)), os.path.join(out, "grid")),
        lambda: app.occupancy_map(kf, cfg, range(8)), 8, K)

    def octomap():
        vmap, collisions = app.octomap(kf, vcfg)
        host = convert.to_numpy(vmap)
        return octomap_io.save_bt(os.path.join(out, "map.bt"), vcfg, host), int((host.fp != 0).sum()), collisions

    (n_nodes, n_voxels, collisions), res["occupancy_3d_bt"] = measure_product(
        octomap, lambda: app.octomap(kf.head(4), vcfg), 4, K)
    res["occupancy_3d_bt"].update(bt_nodes=n_nodes, voxels=n_voxels, slot_collisions=int(collisions))
    grid, _ = occupancy.load_pgm(os.path.join(out, "grid"))
    check(n_full > 0 and (grid == 100).sum() > 0 and (grid == 0).sum() > 0 and n_nodes > 0,
          f"map products: {n_full} points, grid {np.unique(grid)}, {n_nodes} .bt nodes")
    return res


def maps_card_vs_cpu(kf_dir, cmp_dir, n):
    """Phase 12, item 3: the app on the first n keyframes with --device cpu
    and on the card; full maps equal point by point within 1e-5 m,
    feature tiles and arealists byte-identical, the trinary grids' differing
    cells listed (gate: at most 0.1 % of the observed cells, each free on
    one side and unknown on the other at the free region's edge), the .bt
    files' occupied and free leaves equal as sets."""
    import filecmp
    import shutil

    from pointcloud_slam_tpu_torch.io import pcd
    from pointcloud_slam_tpu_torch.maps import occupancy, octomap_io

    os.makedirs(os.path.join(cmp_dir, "Scans"), exist_ok=True)
    for k in range(n):
        for pat in ("%06d.pcd", "%06d_corner.pcd"):
            shutil.copy(os.path.join(kf_dir, "Scans", pat % k), os.path.join(cmp_dir, "Scans", pat % k))
    with open(os.path.join(kf_dir, "poses_kitti.txt")) as f:
        rows = f.read().splitlines()[:n]
    with open(os.path.join(cmp_dir, "poses_kitti.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    app = load_app("apps/construct_full_map_torch.py", "smoke_maps_cmp_app")
    res, outs = {}, {}
    for dev in ("cpu", "cuda"):
        d = outs[dev] = os.path.join(cmp_dir, dev)
        os.makedirs(d, exist_ok=True)
        t0 = time.perf_counter()
        app.main([cmp_dir, "--out", os.path.join(d, "full.pcd"), "--feature_maps", os.path.join(d, "features"),
                  "--occupancy", os.path.join(d, "grid"), "--bt", os.path.join(d, "map.bt"), "--device", dev])
        res[f"{dev}_s"] = time.perf_counter() - t0
    # both devices put every point in the same voxel and emit the voxels in
    # the same order (that of each voxel's first point): compared point by
    # point, which implies equal after a sort
    full = {dev: pcd.read_pcd_xyz(os.path.join(d, "full.pcd")) for dev, d in outs.items()}
    check(full["cpu"].shape == full["cuda"].shape, f"full maps: {full['cpu'].shape} / {full['cuda'].shape}")
    res["full_map_points"] = len(full["cpu"])
    res["full_map_max_diff_m"] = float(np.abs(full["cpu"] - full["cuda"]).max())
    check(res["full_map_max_diff_m"] <= 1e-5, f"full maps differ by {res['full_map_max_diff_m']} m")
    names = sorted(os.listdir(os.path.join(outs["cpu"], "features")))
    check(names == sorted(os.listdir(os.path.join(outs["cuda"], "features"))), "feature tile names differ")
    check(all(filecmp.cmp(os.path.join(outs["cpu"], "features", nm), os.path.join(outs["cuda"], "features", nm),
                          shallow=False) for nm in names), "feature tiles differ")
    res["feature_files_identical"] = len(names)
    gc, _ = occupancy.load_pgm(os.path.join(outs["cpu"], "grid"))
    gg, _ = occupancy.load_pgm(os.path.join(outs["cuda"], "grid"))
    observed = (gc != -1) | (gg != -1)
    diff = np.argwhere(gc != gg)
    free_c = np.pad(gc == 0, 1)
    edge = [bool((~free_c[i:i + 3, j:j + 3]).any()) for i, j in diff]
    pairs = {(int(gc[i, j]), int(gg[i, j])) for i, j in diff}
    res.update(grid_observed_cells=int(observed.sum()), grid_differing_cells=len(diff),
               grid_differing=[[int(i), int(j), int(gc[i, j]), int(gg[i, j])] for i, j in diff[:20]])
    check(len(diff) <= 1e-3 * observed.sum() and pairs <= {(0, -1), (-1, 0)} and all(edge),
          f"grids: {len(diff)} of {int(observed.sum())} observed cells differ, pairs {pairs}")
    bt = [os.path.join(d, "map.bt") for d in (outs["cpu"], outs["cuda"])]
    res["bt_identical"] = filecmp.cmp(*bt, shallow=False)
    if not res["bt_identical"]:
        (_, oc, fc), (_, og, fg) = (octomap_io.load_bt(p) for p in bt)
        as_set = (lambda q: set(map(tuple, np.round(q / 0.2 - 0.5).astype(int))))
        check(as_set(oc) == as_set(og) and as_set(fc) == as_set(fg), ".bt leaves differ")
    return res


def mapping_timer(dev, seq, out_dir, cfg, frames, gt, tuned):
    """Phase 12, item 4: the mapping app with --auto_grid --time_log_file on
    phase 11's dataset (trajectory within REPLAY_MAX_ERR_M of gt_traj.txt at
    every frame; the CSV read by apps/plot_timings.read_timer_csv: a column
    for each of lio_step's spans, a row a frame); the tuned LIO of phase 3
    with its spans recording: its host syncs a frame must stay phase 3's, and
    each row of its CSV sums to the frame's lio_step span."""
    from pointcloud_slam_tpu_torch.utils.timer import Timer

    plot = load_app("apps/plot_timings.py", "smoke_plot_timings")

    traj, csv = os.path.join(out_dir, "smoke_replay_autogrid.txt"), os.path.join(out_dir, "smoke_time.csv")
    app = run_apps({"mapping": [os.path.join(ROOT, "apps", "run_mapping_offline_torch.py"), "--data_dir", seq,
                                "--auto_grid", "--time_log_file", csv, "--traj_log_file", traj]}, timeout=600)
    so = app["mapping"][1]
    rows, gt_rows = np.loadtxt(traj), np.loadtxt(os.path.join(seq, "gt_traj.txt"))
    err = float(np.linalg.norm(rows[:, 1:4] - gt_rows[:, 1:4], axis=1).max())
    cols = plot.read_timer_csv(csv)
    check(rows.shape == gt_rows.shape and err < REPLAY_MAX_ERR_M, f"auto_grid replay: {err} m from the ground truth")
    check(list(cols) == LIO_SPANS and all(len(c) == len(rows) for c in cols.values()), f"timer CSV: {list(cols)}")
    Timer.reset()
    _, timed = run_lio(cfg, frames, gt, dev, timer=True)
    frame_ms = np.array([f.ms for f in Timer.frames()])
    csv = os.path.join(out_dir, "smoke_time_lio.csv")
    Timer.dump_into_file(csv)
    lio_cols = plot.read_timer_csv(csv)
    gap = float(np.abs(np.sum(list(lio_cols.values()), axis=0) - frame_ms).max())
    check(list(lio_cols) == LIO_SPANS and gap < 1e-3, f"timed LIO's CSV: {list(lio_cols)}, rows off by {gap} ms")
    res = dict(auto_grid=next(ln for ln in so.splitlines() if ln.startswith("auto_grid")), replay_err_vs_gt_m=err,
               csv_rows=len(cols["lio_step"]), csv_frame_ms=float(np.sum(list(cols.values()), axis=0).mean()),
               csv_stage_ms={n: float(c.mean()) for n, c in cols.items()},
               lio_timer=dict(fps=timed["fps"], host_syncs_per_frame=timed["host_syncs_per_frame"],
                              sync_ops_seen_per_frame=timed["sync_ops_seen_per_frame"],
                              frame_ms=float(frame_ms.mean()), csv_row_gap_ms=gap),
               lio_phase3=dict(host_syncs_per_frame=tuned["host_syncs_per_frame"],
                               sync_ops_seen_per_frame=tuned["sync_ops_seen_per_frame"]))
    Timer.reset()
    check(timed["host_syncs_per_frame"] == tuned["host_syncs_per_frame"]
          and timed["sync_ops_seen_per_frame"] <= tuned["sync_ops_seen_per_frame"],
          f"the timer adds syncs: {res['lio_timer']} against phase 3's {res['lio_phase3']}")
    return res


DEPLOY_ONLINE_FRAMES = 20      # the online mapper's frames at N_POINTS
DEPLOY_SOAK_S = 20             # each soak's paced seconds (10 Hz)
DEPLOY_KITTI_FRAMES = 60       # the synthetic street at the KITTI app's default width ...
DEPLOY_KITTI_POINTS = 30_000   # ... of this many points a frame
# KITTI gates: the largest position error over the 60 frames (48 m of travel)
# against poses.txt, 1.5 x what the app measured on the CPU on the same
# sequence (ICP 1.077 m, NDT 0.348, VGICP 0.257; frame-to-frame drift)
KITTI_MAX_ERR_M = {"icp": 1.6, "ndt": 0.55, "vgicp": 0.40}


def phc_lio(dev, cfg, frames, gt):
    """Phase 13, PHC LIO: phase 3's tuned LIO with phc_order=2 (ATE gates as
    phase 3's), frames/s, host syncs a frame, launches and GPU busy a frame;
    phc_merge on one frame's batch (frame 10, both output modes): keys,
    masks and centroids of the card equal to the CPU's."""
    import dataclasses

    import torch

    from pointcloud_slam_tpu_torch.models import lio
    from pointcloud_slam_tpu_torch.ops import phc

    cfg_phc = dataclasses.replace(cfg, phc_order=2)
    state, res = run_lio(cfg_phc, frames, gt, dev)
    check(res["ate_mean_m"] < 0.2 and res["ate_final_m"] < 0.25, f"PHC LIO ATE gates: {res}")
    launches, busy, wall, top = profile_launches(lambda: lio.lio_step(cfg_phc, state, frames[-1]))
    pts, mask, r = frames[10].pts, frames[10].pt_mask, cfg.grid.resolution
    (vg, hg), (vc, hc) = phc._phc_key(pts, mask, r, 2), phc._phc_key(pts.cpu(), mask.cpu(), r, 2)
    check(torch.equal(vg.cpu(), vc) and torch.equal(hg.cpu(), hc), "phc keys: the card's differ from the CPU's")
    merged = {}
    for curve in (False, True):
        (og, mg), (oc, mc) = (phc.phc_merge(pts, mask, r, 2, curve_output=curve),
                              phc.phc_merge(pts.cpu(), mask.cpu(), r, 2, curve_output=curve))
        check(torch.equal(mg.cpu(), mc) and torch.equal(og.cpu()[:, mc], oc[:, mc]),
              f"phc_merge (curve_output={curve}): the card differs from the CPU")
        merged[f"curve_output_{curve}"] = int(mc.sum())
    return dict(lio_phc=res, launches_per_frame=launches, gpu_busy_ms_per_frame=busy, profiled_frame_ms=wall,
                top_device_ms=top, phc_merge_card_vs_cpu="equal", merged_of=int(mask.sum()), merged=merged)


def last_json(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


def online_paths(out_dir, smi):
    """Phase 13: the online mapper app at N_POINTS for DEPLOY_ONLINE_FRAMES
    frames against the stream's own trajectory (the LIO gates from frame 5),
    then the live-driver soak at N_POINTS and 10 Hz for DEPLOY_SOAK_S seconds
    (gate: its ATE; latency and drops are findings) and the localization
    soak at config 8's shapes (gates: the injected loss recovered, final
    error < 0.10 m)."""
    from pointcloud_slam_tpu_torch.io import synthetic

    traj = os.path.join(out_dir, "smoke_online.txt")
    app = run_apps({"online": [os.path.join(ROOT, "apps", "run_mapping_online_torch.py"), "--frames",
                               str(DEPLOY_ONLINE_FRAMES), "--n_points", str(N_POINTS), "--traj_log_file", traj]},
                   timeout=600)
    t = synthetic.make_imu_trajectory(DEPLOY_ONLINE_FRAMES, 20, 0.1, seed=0)
    gt_pos = t["pos"][20::20][:DEPLOY_ONLINE_FRAMES]
    est = np.loadtxt(traj)[:, 1:4]
    check(est.shape == gt_pos.shape and np.isfinite(est).all(), f"online mapper: trajectory {est.shape}")
    err = np.linalg.norm(est - (gt_pos - gt_pos[0]), axis=1)[5:]
    res = dict(online_mapper=dict(frames=len(est), ate_mean_m=float(err.mean()), ate_final_m=float(err[-1]),
                                  out=next(ln for ln in app["online"][1].splitlines() if " frames in " in ln)))
    check(err.mean() < 0.2 and err[-1] < 0.25, f"online mapper ATE gates: {res['online_mapper']}")
    soak = run_apps({"soak": [os.path.join(ROOT, "tools", "soak_online_torch.py"), "--n_points", str(N_POINTS),
                              "--seconds", str(DEPLOY_SOAK_S)]}, timeout=600)
    res["soak_online"] = dict(last_json(soak["soak"][1]), nvidia_smi=smi)
    so = res["soak_online"]
    check(so["ate_mean_m"] < 0.2 and so["ate_final_m"] < 0.25, f"online soak ATE gates: {so}")
    loc = run_apps({"soak": [os.path.join(ROOT, "tools", "soak_localization_torch.py"), "--seconds",
                             str(DEPLOY_SOAK_S)]}, timeout=600)
    res["soak_localization"] = dict(last_json(loc["soak"][1]), nvidia_smi=smi)
    sl = res["soak_localization"]
    sl["k6_launches_per_match"] = sl["k6_launches"] / sl["matches"]
    check(sl["k6_launches"] > 0, "the localization soak never launched K6")
    check(sl["losses"] >= 1 and sl["recoveries"] == sl["losses"] and sl["err_final_m"] < 0.10,
          f"localization soak: loss not recovered or final error >= 0.10 m: {sl}")
    return res


def kitti_errors(poses_file, est_file):
    """(final, max) position error of a KITTI pose file against the sequence's
    poses.txt, expressed in its first frame."""
    gt = np.loadtxt(poses_file).reshape(-1, 3, 4)
    est = np.loadtxt(est_file).reshape(-1, 3, 4)
    rel = np.einsum("ji,nj->ni", gt[0, :, :3], gt[:, :, 3] - gt[0, :, 3])
    e = np.linalg.norm(est[:, :, 3] - rel, axis=1)
    return float(e[-1]), float(e.max())


def kitti_paths(out_dir):
    """Phase 13: tools/make_dataset_torch.py kitti (60 frames of 30,000 points),
    then apps/run_kitti_torch.py with --algo icp, ndt and vgicp, one after
    another: frames/s and the final and largest error against poses.txt
    (gates: KITTI_MAX_ERR_M)."""
    seq = os.path.join(out_dir, "smoke_kitti")
    t0 = time.perf_counter()
    mk = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_dataset_torch.py"), "kitti", "--out", seq,
                         "--frames", str(DEPLOY_KITTI_FRAMES), "--points", str(DEPLOY_KITTI_POINTS)],
                        capture_output=True, text=True, timeout=600, cwd=ROOT)
    check(mk.returncode == 0, f"make_dataset_torch kitti failed ({mk.returncode}):\n{mk.stdout}\n{mk.stderr}")
    res = dict(dataset_s=time.perf_counter() - t0)
    for algo in ("icp", "ndt", "vgicp"):
        out = os.path.join(out_dir, f"smoke_kitti_{algo}.txt")
        app = run_apps({algo: [os.path.join(ROOT, "apps", "run_kitti_torch.py"), seq, "--algo", algo, "--out", out]},
                       timeout=600)
        done = next(ln for ln in app[algo][1].splitlines() if ln.startswith("done:"))
        k6 = int(next(ln for ln in app[algo][1].splitlines() if ln.startswith("kernel launches: K6 ")).split()[-1])
        final, worst = kitti_errors(os.path.join(seq, "poses.txt"), out)
        res[algo] = dict(fps=float(done.split(", ")[1].split()[0]), final_err_m=final, max_err_m=worst,
                         k6_launches_per_frame=k6 / DEPLOY_KITTI_FRAMES)
        check(worst < KITTI_MAX_ERR_M[algo], f"KITTI {algo}: largest error {worst} m (gate {KITTI_MAX_ERR_M[algo]} m)")
        check(algo != "ndt" or k6 > 0, "KITTI ndt: the app never launched K6")
    return res


def _alive(pid):
    """Whether a process runs (a zombie waiting for its reaper counts as ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def mapping_session(dev, out_dir):
    """Phase 13: apps/mapping_session_torch.py start --mode fast --run
    --synthetic 20 (the port's mapping app on the card, launched by the
    session), then the session's occupancy product from its jueying.pcd
    (maps.occupancy on the card) and save-map, pub-occ-map and stop. Holds
    the session's files: the trajectory (20 rows), time.csv, jueying.pcd and
    the published PGM/YAML."""
    import shutil

    import torch

    from pointcloud_slam_tpu_torch.io import pcd
    from pointcloud_slam_tpu_torch.maps import occupancy as occ

    root = os.path.join(out_dir, "smoke_session")
    shutil.rmtree(root, ignore_errors=True)
    cli = [sys.executable, os.path.join(ROOT, "apps", "mapping_session_torch.py"), "--root", root]

    def run(*args):
        r = subprocess.run([*cli, *args], capture_output=True, text=True, timeout=300, cwd=ROOT)
        check(r.returncode == 0, f"mapping session {args[0]} failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
        return r.stdout

    t0 = time.perf_counter()
    run("start", "--mode", "fast", "--run", "--synthetic", "20")
    session = os.path.realpath(os.path.join(root, "system", "maps", "default"))
    with open(os.path.join(session, "details", "pids")) as f:
        pids = [int(x) for x in f.read().split()]
    while any(_alive(p) for p in pids) and time.perf_counter() - t0 < 600:
        time.sleep(0.5)
    run_s = time.perf_counter() - t0
    details = os.path.join(session, "details")
    with open(os.path.join(details, "mapping.log")) as f:
        log = f.read()
    traj_file, csv, map_pcd = (os.path.join(details, "traj.txt"), os.path.join(details, "time.csv"),
                               os.path.join(session, "jueying.pcd"))
    check(all(os.path.exists(p) for p in (traj_file, csv, map_pcd)), f"session files missing; log:\n{log}")
    rows = np.loadtxt(traj_file)
    check(rows.shape == (20, 8) and np.isfinite(rows).all(), f"session trajectory {rows.shape}")
    pts = pcd.read_pcd_xyz(map_pcd)
    cfg = occ.OccupancyConfig(size=512, resolution=0.1, origin=-25.6)
    grid = occ.insert_cloud(cfg, occ.create(cfg, device=dev), torch.from_numpy(np.ascontiguousarray(pts.T)).to(dev),
                            torch.ones(len(pts), dtype=torch.bool, device=dev), (0.0, 0.0), 0.0)
    occ.save_pgm(cfg, grid, os.path.join(details, "occ"))
    run("save-map")
    pub = run("pub-occ-map")
    stop = run("stop")
    published = [os.path.join(root, "system", "map", "jueying" + ext) for ext in (".pgm", ".yaml")]
    check(all(os.path.exists(p) for p in published), "session: the published PGM/YAML are missing")
    grid_pub, _ = occ.load_pgm(published[0][:-4])
    return dict(session_s=run_s, traj_rows=int(rows.shape[0]), map_points=int(len(pts)),
                csv_bytes=os.path.getsize(csv), published_cells=int(grid_pub.size),
                occupied_cells=int((grid_pub == 100).sum()), publish=pub.strip().splitlines()[0],
                stop=stop.strip().splitlines()[-1], app=log.strip().splitlines()[0] if log.strip() else "")


PAR_WORLD = 4              # phase 14: ranks sharing the card over gloo, mesh (2, 2) ...
PAR_KF, PAR_LOOPS, PAR_NL = 4096, 64, 24   # ... the backend's keyframes, loop slots and loops
# the backend's loop layouts (stride, span): the dry run's as written (they tie
# only the first 2,352 of 4,096 nodes) and scaled with the node count (every
# node tied to the opposite one)
PAR_LAYOUTS = dict(backend=(80, 512), backend_scaled=(80 * PAR_KF // 1024, PAR_KF // 2))
PAR_REPS = 3               # timed calls of each sharded function after a warm-up call
# (label, ranks, backend, mesh): the ranks share the card over gloo; one rank has it alone over NCCL
PAR_RUNS = (("gloo", PAR_WORLD, "gloo", (2, 2)), ("nccl", 1, "nccl", (1, 1)))


def device_sync(dev):
    import torch

    return torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)


def peak_gib(dev):
    import torch

    return torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else 0.0


def parallel_inputs(dev, lio_cfg, state, frame):
    """Phase 14's inputs at the product shapes, built once in this process:
    ICP at bench.py config 1 (as phase 6), the tuned LIO update on one
    20,000-point frame's downsampled points against the map phase 3 built
    (from its final state), config 8's scan-to-map from the previous pose
    on the circle, and config 6's backend at 4,096 keyframes with 64 loop
    slots on the dry run's drifting circle (__graft_entry__.py:116-133)
    with 24 loops in each of PAR_LAYOUTS. Returns (configs and host
    tensors, true ICP t, true graph t, noisy graph t)."""
    import torch

    from pointcloud_slam_tpu_torch import ops, register
    from pointcloud_slam_tpu_torch.io import synthetic
    from pointcloud_slam_tpu_torch.models.liosam import backend as bk

    host = lambda tree: tuple(host(t) for t in tree) if isinstance(tree, tuple) else tree.cpu()
    world = synthetic.make_room_cloud(60_000, seed=0)
    srcs, icp_gt = icp_frames(world, 24, N_POINTS)
    icp_grid_cfg = ops.GridConfig(capacity=1 << 17, pts_per_voxel=10, resolution=0.3, probe=4, nearby=7, baked=True)
    icp_cfg = register.ICPConfig(search_every=10, warmup_searches=0, solver=register.SolverConfig(
        max_iterations=30, rotation_epsilon=0.0, translation_epsilon=0.0))
    _, icp_grid = register.build_target_map(torch.from_numpy(np.ascontiguousarray(world.T)).to(dev),
                                            grid_cfg=icp_grid_cfg)
    pts_d, mask_d = ops.voxel_downsample_compact(frame.pts, frame.pt_mask, lio_cfg.scan_leaf, lio_cfg.scan_budget)

    s2cfg = loc_config().scan2map
    corners_w, surfs_w = synthetic.make_feature_world(seed=3)
    fmaps = []
    for cloud, g in ((corners_w, s2cfg.corner_grid), (surfs_w, s2cfg.surf_grid)):
        pts = torch.from_numpy(np.ascontiguousarray(cloud.T.astype(np.float32))).to(dev)
        fmaps.append(ops.insert(g, ops.create(g, device=dev), pts, torch.ones(pts.shape[1], dtype=torch.bool,
                                                                                   device=dev)))
    circle = lambda k: np.array([3.0 * np.sin(2 * np.pi * k / LOC_FRAMES), 3.0 * (1 - np.cos(2 * np.pi * k / LOC_FRAMES)),
                                 1.0], np.float32)
    eye = np.eye(3, dtype=np.float32)
    c, cm = synthetic.take_scan(corners_w, eye, circle(8), 512, seed=8)
    s, sm = synthetic.take_scan(surfs_w, eye, circle(8), 2048, seed=108)

    bcfg = bk.BackendConfig(max_keyframes=PAR_KF, max_loops=PAR_LOOPS, keyframe_dist_thresh=0.3, gn_iterations=3,
                            pcg_iterations=24)
    graphs = {name: synthetic.drifting_circle_graph(bcfg, PAR_NL, stride, span, device="cpu")
              for name, (stride, span) in PAR_LAYOUTS.items()}
    inp = dict(icp=(icp_grid_cfg, icp_cfg, host(icp_grid), torch.from_numpy(srcs)),
               lio=(lio_cfg, host(state.grid), host(tuple(state.x)), state.P.cpu(), pts_d.cpu(), mask_d.cpu()),
               s2m=(s2cfg, host(fmaps[0]), host(fmaps[1]),
                    *(torch.from_numpy(np.ascontiguousarray(a.T) if a.ndim == 2 else a) for a in (c, cm, s, sm)),
                    torch.from_numpy(circle(7))),
               **{name: (bcfg, g) for name, (g, _, _) in graphs.items()})
    _, t_true, t_noisy = graphs["backend"]
    return inp, icp_gt, t_true, t_noisy


def parallel_calls(inp, dev, mesh=None):
    """{name: fn()} for the four functions on `inp` moved to `dev`: sharded
    over `mesh`, or the single-device functions without one. With a mesh,
    every replicated input is broadcast from rank 0 first."""
    import torch

    from pointcloud_slam_tpu_torch import ops, parallel, register
    from pointcloud_slam_tpu_torch.geom import se3
    from pointcloud_slam_tpu_torch.models.lio import eskf, state as lst
    from pointcloud_slam_tpu_torch.models.lio import pipeline as lp
    from pointcloud_slam_tpu_torch.models.liosam import backend as bk
    from pointcloud_slam_tpu_torch.models.liosam import scan2map as s2m
    from pointcloud_slam_tpu_torch.parallel import mesh as pmesh

    def card(tree):
        if isinstance(tree, torch.Tensor):
            return tree.to(dev)
        return type(tree)(*map(card, tree)) if hasattr(tree, "_fields") else type(tree)(map(card, tree))

    rep = (lambda tree: pmesh.replicate(tree)) if mesh is not None else (lambda tree: tree)
    icp_grid_cfg, icp_cfg, icp_grid, srcs = inp["icp"]
    icp_grid, srcs = rep(card(ops.VoxelHashMap(*icp_grid))), rep(card(srcs))
    B = srcs.shape[0]
    icp_mask = torch.ones((B, srcs.shape[2]), dtype=torch.bool, device=dev)
    lio_cfg, lio_grid, x0, P0, pts_d, mask_d = inp["lio"]
    lio_grid, x0, P0 = rep(card(ops.VoxelHashMap(*lio_grid))), rep(card(lst.NavState(*x0))), rep(card(P0))
    pts_d, mask_d = rep(card(pts_d)), rep(card(mask_d))
    s2cfg, cmap, smap, c, cm, s, sm, t_prev = inp["s2m"]
    cmap, smap = rep(card(ops.VoxelHashMap(*cmap))), rep(card(ops.VoxelHashMap(*smap)))
    c, cm, s, sm, t_prev = (rep(card(a)) for a in (c, cm, s, sm, t_prev))
    graphs = {name: (inp[name][0], rep(card(inp[name][1]))) for name in PAR_LAYOUTS}
    init = se3.Pose(torch.eye(3, device=dev), t_prev)
    if mesh is None:
        def lio_single():
            body_norm = torch.sqrt(torch.sum(pts_d * pts_d, dim=0))
            u = eskf.update_iterated(x0, P0, lp._obs_model(lio_cfg, lio_grid, pts_d, body_norm, mask_d),
                                     lio_cfg.laser_point_cov, lio_cfg.max_iterations, lio_cfg.epsi)
            return u.x, u.P, u.iterations, u.converged
        calls = dict(
            icp=lambda: register.batched_point_to_plane_icp(icp_grid_cfg, icp_grid, srcs, icp_mask, cfg=icp_cfg),
            lio=lio_single,
            s2m=lambda: s2m.scan_to_map(s2cfg, cmap, smap, c, cm, s, sm, init),
            **{name: (lambda g=g: bk.optimize(*g)) for name, g in graphs.items()})
    else:
        calls = dict(
            icp=lambda: parallel.sharded_point_to_plane_icp(
                mesh, icp_grid_cfg, icp_grid, srcs, icp_mask, se3.identity(batch=(B,), device=dev), cfg=icp_cfg),
            lio=lambda: parallel.sharded_lio_update(mesh, lio_cfg, lio_grid, x0, P0, pts_d, mask_d),
            s2m=lambda: parallel.sharded_scan_to_map(mesh, s2cfg, cmap, smap, c, cm, s, sm, init),
            **{name: (lambda g=g: parallel.sharded_optimize(mesh, *g)) for name, g in graphs.items()})
    return calls


def parallel_outputs(name, out):
    """The compared outputs of each function, as host tensors."""
    if name == "icp":
        return (out[0].R, out[0].t, out[1], out[2])
    if name == "lio":
        return (out[0].pos, out[0].rot, out[1], out[2], out[3])
    if name == "s2m":
        return (out.pose.R, out.pose.t, out.num_corner, out.num_surf, out.degenerate)
    return (out.R, out.t)


def time_calls(calls, reps, sync):
    """Each call once to warm up, then `reps` times: {name: (host outputs,
    median wall ms, all-reduce calls and bytes a call)}."""
    from pointcloud_slam_tpu_torch.parallel import mesh as pmesh

    res = {}
    for name, fn in calls.items():
        fn()
        sync()
        times = []
        for _ in range(reps):
            c0, b0 = pmesh.all_reduce_sum.calls, pmesh.all_reduce_sum.bytes
            t0 = time.perf_counter()
            out = fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            calls_1, bytes_1 = pmesh.all_reduce_sum.calls - c0, pmesh.all_reduce_sum.bytes - b0
        res[name] = (tuple(t.cpu() for t in parallel_outputs(name, out)), statistics.median(times), calls_1, bytes_1)
    return res


def parallel_rank(inp, reps, device):
    """One rank of phase 14: the four sharded functions on rank 0's
    broadcast inputs. Returns outputs, wall ms, all-reduces a call, peak
    memory, K1 / K2 launches, the mesh and the backend."""
    import torch
    import torch.distributed as dist

    from pointcloud_slam_tpu_torch import parallel
    from pointcloud_slam_tpu_torch.ops import bf_knn

    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device(device)
    mesh = parallel.make_mesh(device_type=device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    bf_knn.knn.launches = bf_knn.nearest_neighbor.launches = 0
    res = time_calls(parallel_calls(inp, dev, mesh), reps, device_sync(dev))
    return dict(res=res, peak_gib=peak_gib(dev), mesh=tuple(mesh.shape), backend=dist.get_backend(),
                k1_k2=[bf_knn.knn.launches, bf_knn.nearest_neighbor.launches])


def run_parallel(dev, lio_cfg, state, frame):
    """Phase 14: the sharded ICP, LIO update, scan-to-map and backend at the
    product shapes on PAR_WORLD ranks sharing the card over gloo (mesh
    (2, 2)) and on one rank over NCCL (mesh (1, 1)), each held against the
    single-device function on the same inputs in this process at
    tests/test_parallel.py's tolerances (the backend on its written loop
    layout only reported: see below); ranks bit for bit equal; the
    backend's error must fall on every run; K1 / K2 at 0 launches."""
    import torch

    from pointcloud_slam_tpu_torch import parallel
    from pointcloud_slam_tpu_torch.ops import bf_knn

    inp, icp_gt, t_true, t_noisy = parallel_inputs(dev, lio_cfg, state, frame)
    bf_knn.knn.launches = bf_knn.nearest_neighbor.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    single = time_calls(parallel_calls(inp, dev), PAR_REPS, device_sync(dev))
    k1_k2 = [bf_knn.knn.launches, bf_knn.nearest_neighbor.launches]
    err0 = float(np.linalg.norm(t_noisy - t_true, axis=1).max())
    single_err = {name: float(np.linalg.norm(single[name][0][1].numpy() - t_true, axis=1).max())
                  for name in PAR_LAYOUTS}
    check(all(e < err0 for e in single_err.values()), f"single device: backend error {err0} -> {single_err} m")
    tol = dict(icp=1e-2, lio=1e-5, s2m=1e-4, backend_scaled=5e-4)   # tests/test_parallel.py
    fields = dict(single=dict(wall_ms={k: v[1] for k, v in single.items()}, peak_gib=peak_gib(dev), k1_k2=k1_k2,
                              backend_err_m=dict(noisy=err0, **single_err)))
    for label, world, backend, shape in PAR_RUNS:
        t0 = time.perf_counter()
        ranks = parallel.launch(parallel_rank, world, device=dev.type, backend=backend,
                                args=(inp, PAR_REPS, dev.type), timeout=600)
        launch_s = time.perf_counter() - t0
        check(all(r["mesh"] == shape and r["backend"] == backend for r in ranks),
              f"{label}: meshes {[r['mesh'] for r in ranks]}, backends {[r['backend'] for r in ranks]}")
        for r in ranks[1:]:
            for name in single:
                check(all(torch.equal(a, b) for a, b in zip(ranks[0]["res"][name][0], r["res"][name][0])),
                      f"{label}: {name} differs between ranks")
        err = {}
        for name, (ref, _, _, _) in single.items():
            got = ranks[0]["res"][name][0]
            floats = [(a, b) for a, b in zip(got, ref) if a.is_floating_point()]
            err[name] = max(float((a.double() - b.double()).abs().max()) for a, b in floats)
            # the written layout's 3 GN x 24 PCG result moves by centimetres with the order of
            # its float32 sums (the single device's atomics change it from run to run, ROADMAP
            # §3): its gap is reported; it is held to finite values, equal ranks and a falling error
            check(name not in tol or err[name] <= tol[name],
                  f"{label}: {name} off the single-device result by {err[name]} (tolerance {tol.get(name)})")
            check(all(torch.equal(a, b) for a, b in zip(got, ref) if not a.is_floating_point()),
                  f"{label}: {name}'s iterations, counts or flags differ from the single-device result")
        fields[label] = dict(
            ranks=len(ranks), launch_s=launch_s, max_abs_err_vs_single=err,
            wall_ms={name: [r["res"][name][1] for r in ranks] for name in single},
            all_reduce_calls={name: ranks[0]["res"][name][2] for name in single},
            all_reduce_bytes={name: ranks[0]["res"][name][3] for name in single},
            peak_gib=[r["peak_gib"] for r in ranks], k1_k2=[r["k1_k2"] for r in ranks])
        check(all(r["k1_k2"] == [0, 0] for r in ranks), f"{label}: the sharded paths launched K1/K2")
        icp_err = float(np.linalg.norm(ranks[0]["res"]["icp"][0][1].numpy() - icp_gt, axis=1).max())
        err1 = {name: float(np.linalg.norm(ranks[0]["res"][name][0][1].numpy() - t_true, axis=1).max())
                for name in PAR_LAYOUTS}
        fields[label].update(icp_trans_err_max_m=icp_err, backend_err_m=dict(noisy=err0, **err1))
        check(icp_err < 0.05 and all(e < err0 for e in err1.values()),
              f"{label}: ICP error {icp_err} m, backend error {err0} -> {err1} m")
    check(k1_k2 == [0, 0], f"the single-device references launched K1/K2 {k1_k2} times")
    t0 = time.perf_counter()
    dry = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "dryrun_multichip_torch.py"), "--world_size",
                          str(PAR_WORLD), "--device", dev.type], capture_output=True, text=True, timeout=600, cwd=ROOT)
    check(dry.returncode == 0 and "dryrun_multichip ok" in dry.stdout,
          f"dry run failed ({dry.returncode}):\n{dry.stdout}\n{dry.stderr[-3000:]}")
    fields["dryrun"] = dict(s=time.perf_counter() - t0, out=dry.stdout.strip().splitlines()[-1])
    return fields


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

    t_script = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]

    # ---- 1. device and build ----
    t0 = time.perf_counter()
    lib = _cuda.library()
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    phase(1, "device+build", device=name, nvidia_smi=smi, build_s=round(time.perf_counter() - t0, 2),
          nvcc_s=round(lib.build_seconds, 2), ptxas=ptxas)

    # ---- 2. K1 against its plain version at N = M = 20,000, k = 8 ----
    frames, gt = build_frames(dev, N_FRAMES)
    cloud = frames[10].pts.contiguous()
    k1_20k = compare_knn(bf_knn, cloud, cloud, 8)
    phase(2, "K1 vs plain (N=M=20000, k=8)", launches=bf_knn.knn.launches, **k1_20k)

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
    k1_map = compare_knn(bf_knn, pts, pts, 20)
    cov_err = compare_cov(bf_knn, vgicp, pts, mask, cov, 20)
    phase(4, "K1 vs plain (map, k=20) + covariances", n=int(pts.shape[1]), cov_max_abs_err=cov_err, **k1_map)
    # a scan's worth of queries over the map: few query blocks, so the plan splits the database
    scan = pts[:, :6144].contiguous()
    scan_fields = {f"k{k}": compare_knn(bf_knn, scan, pts, k) for k in (5, 20)}
    phase(4, "K1 vs plain (6144 queries over the map)", n=int(scan.shape[1]), m=int(pts.shape[1]), **scan_fields)
    ragged_q, ragged_db = frames[11].pts[:, :3001].contiguous(), cloud
    sweep = sweep_k(bf_knn, ragged_q, ragged_db, (2, 3, 4, 7, 9, 16, 21, 32, 33, 40, 64, 100))
    phase(4, "K1 sweep of k (3001 x 20000; above MAX_K in rounds)", max_abs_err=sweep, list_length=bf_knn.MAX_K,
          plans={k: plan_fields(bf_knn, ragged_q, ragged_db, k) for k in sweep},
          tie_share_at_round_edge=exact_rounds(bf_knn, (33, 40, 64, 100)))
    phase(4, "K1 rounds on the map (k=40, 64)", **{f"k{k}": round_times(bf_knn, pts, pts, k) for k in (40, 64)})
    tie_splits = check_split_ties(bf_knn, cloud, 8)
    phase(4, "ties across splits (K1 k=8, K2)", S_k1=tie_splits[0], S_k2=tie_splits[1], copies=300)

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
    nn_b2b_ms = cuda_ms_back_to_back(lambda: bf_knn.nearest_neighbor(q, db))
    nn_plain_ms = cuda_ms(lambda: bf_knn.nearest_neighbor_plain(q, db))
    nn_ctx_ms = cuda_ms(lambda: torch.cdist(q.T, db.T).min(dim=1))   # two calls: context only
    nn_bound, nn_bound_by = knn_bound_ms(q.shape[1], db.shape[1], 1)
    phase(5, "K2 vs plain (N=M=20000)", max_abs_err=nn_err, ms=nn_ms, ms_back_to_back=nn_b2b_ms, plain_ms=nn_plain_ms,
          bound_ms=nn_bound, cdist_min_ms=nn_ctx_ms, queries_clear_of_ties=int(clear.sum()),
          launches=launches["nearest_neighbor"], **plan_fields(bf_knn, q, db, 1))

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
        side_cov = pcov if side == "source" else vgicp.source_covariances(cloud_t, pmask, k=8, method="exact")
        k1_pair[side] = dict(n=int(cloud_t.shape[1]), **compare_knn(bf_knn, cloud_t, cloud_t, 8),
                             cov_max_abs_err=compare_cov(bf_knn, vgicp, cloud_t, pmask, side_cov, 8))
    phase(7, "GICP/VGICP exact covariances", k1_launches=pair_launches, k1_vs_plain_k8=k1_pair, **pair)
    bench = subprocess.run([sys.executable, os.path.join(ROOT, "apps", "align_bench_torch.py"), "--device", "cuda",
                            "--reps", "3"], capture_output=True, text=True, timeout=600, cwd=ROOT)
    check(bench.returncode == 0, f"align bench failed ({bench.returncode}):\n{bench.stdout}\n{bench.stderr}")
    table = [" ".join(ln.split()) for ln in bench.stdout.split("\n\n")[-1].strip().splitlines()]
    phase(7, "align bench", rc=bench.returncode, table=" | ".join(table))

    # ---- 8. NDT, D2D and RBF covariances on the same pair (K6 counted) ----
    reset_k6()
    ndt_fields, ndt_eigh_inputs = run_ndt(dev)
    k6_main = k6_launches()
    phase(8, "NDT on the align pair", k6_launches=k6_main, **ndt_fields)

    # ---- 9. LIO-SAM SLAM at bench.py config 6's full shapes ----
    from pointcloud_slam_tpu_torch.io import synthetic

    world = synthetic.make_feature_world()
    cfg512 = slam_config(512)
    slam_res = {}
    for shape in ("fresh", "revisit"):
        reset_k6()
        slam_res[shape], _ = run_slam_shape(cfg512, dev, shape, 480, 32, world)
        k6_main += k6_launches()
        phase(9, f"SLAM {shape} (KF 512, 480 pre-populated, 32 frames)", k6_launches=k6_launches(), **slam_res[shape])
    rv, fr = slam_res["revisit"], slam_res["fresh"]
    check(rv["loops"] >= 1 and rv["final_err_m"] < 0.05,
          f"SLAM revisit: {rv['loops']} loops, final error {rv['final_err_m']} m (gates: >= 1, < 0.05 m)")
    check(abs(fr["drift_m_per_m"]) <= 0.01, f"SLAM fresh: drift {fr['drift_m_per_m']} m/m (gate 0.01, bench.py:867)")
    reset_k6()
    big, _ = run_slam_shape(slam_config(4096), dev, "revisit", 4064, 8, world)
    k6_main += k6_launches()
    phase(9, "SLAM revisit (KF 4096, 4064 pre-populated, 8 frames)", k6_launches=k6_launches(), **big)
    # its keyframe artifacts are phase 12's input
    app = subprocess.run([sys.executable, os.path.join(ROOT, "apps", "run_slam_offline_torch.py"), "--synthetic", "40",
                          "--device", "cuda", "--save_artifacts",
                          "--out_dir", str(_cuda.BUILD_DIR / "smoke_maps" / "kf")],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    check(app.returncode == 0, f"SLAM app failed ({app.returncode}):\n{app.stdout}\n{app.stderr}")
    phase(9, "SLAM app", rc=app.returncode, out=app.stdout.strip().splitlines()[0])

    # ---- 10. prior-map localization at bench.py config 8's full shape ----
    reset_k6()
    loam, loam_eigh_inputs = run_localization(dev)
    k6_main += k6_launches()
    phase(10, "localization LOAM (config 8: 64 frames, 512 + 2048 points)", k6_launches=k6_launches(), **loam)
    check(loam["max_err_m"] < 0.10 and loam["lost_frames"] == 0,
          f"localization: max error {loam['max_err_m']} m, {loam['lost_frames']} lost (gates: < 0.10 m, 0)")
    check(loam["reloc_triggered"] and loam["reloc_recovered"] and loam["reloc_err_m"] < 0.05,
          f"relocalization: {loam['reloc_triggered']}, {loam['reloc_recovered']}, {loam['reloc_err_m']} m")
    reset_k6()
    ndt_loc = run_localization_ndt(dev)
    k6_main += k6_launches()
    phase(10, "localization NDT (8192 points, 60k-point room, 16 frames)", k6_launches=k6_launches(), **ndt_loc)
    check(ndt_loc["max_err_m"] < 0.10 and ndt_loc["lost_frames"] == 0,
          f"NDT localization: max error {ndt_loc['max_err_m']} m, {ndt_loc['lost_frames']} lost (gates: < 0.10 m, 0)")
    loc_app = os.path.join(ROOT, "apps", "run_localization_torch.py")
    apps = run_apps({m: [loc_app, "--synthetic", "16", "--method", m, "--out_dir", str(_cuda.BUILD_DIR / f"smoke_loc_{m}")]
                     for m in ("ndt", "loam")}, timeout=600)
    lost = {m: lost_count(so) for m, (_, so, _) in apps.items()}
    phase(10, "localization app", lost=lost, out={m: so.strip().splitlines()[0] for m, (_, so, _) in apps.items()})
    check(lost == {"ndt": 0, "loam": 0}, f"localization app lost frames: {lost}")
    check(k6_main > 0, "the paths of phases 8-10 never launched K6")

    # ---- 10. K6 against its plain version at the call sites' inputs, then its times ----
    k6_cmp, k6_t = run_k6_check(dev, loam_eigh_inputs, ndt_eigh_inputs)
    # the kernels line's error: on spectra scaled to max|lambda| = 1 (the H of an
    # NDT align reach 1e8, where a float32 ulp alone is ~10)
    k6_err = max(v["f32"]["eig_rel_err"] for v in k6_cmp.values())
    phase(10, "K6 vs plain at the call sites (scan-to-map, NDT; batches 24 and 1,000), and its times",
          nvidia_smi=smi, errors=k6_cmp, times=k6_t, launches=k6_main)

    # ---- 11. recorded data: dataset + bag, three replays, SLAM and localization on them ----
    phase(11, "recorded data", **run_recorded(dev, str(_cuda.BUILD_DIR)))

    # ---- 12. map products: keyframes -> maps -> localization; full size; card vs CPU; timer ----
    bf_knn.knn.launches = bf_knn.nearest_neighbor.launches = 0
    maps_dir = _cuda.BUILD_DIR / "smoke_maps"
    phase(12, "maps from the SLAM app's keyframes, localization on their tiles",
          **maps_chain(dev, str(maps_dir / "kf")))
    t0 = time.perf_counter()
    map_keyframes(str(maps_dir / "full"), MAP_KEYFRAMES, MAP_POINTS)
    products = dict(dataset_s=time.perf_counter() - t0, **map_products(dev, str(maps_dir / "full")))
    phase(12, f"map products ({MAP_KEYFRAMES} keyframes x {MAP_POINTS} points)", nvidia_smi=smi, **products)
    phase(12, f"maps card vs CPU ({MAP_CMP_KEYFRAMES} keyframes)",
          **maps_card_vs_cpu(str(maps_dir / "full"), str(maps_dir / "cmp"), MAP_CMP_KEYFRAMES))
    timer = mapping_timer(dev, str(_cuda.BUILD_DIR / "smoke_lio"), str(_cuda.BUILD_DIR), cfg, frames, gt, tuned)
    k1_k2 = [bf_knn.knn.launches, bf_knn.nearest_neighbor.launches]
    phase(12, "mapping app --auto_grid --time_log_file, LIO under the timer", k1_k2_launches=k1_k2, **timer)
    check(k1_k2 == [0, 0], f"the maps path launched K1/K2 {k1_k2} times")

    # ---- 13. deployed modes: PHC LIO, online mapper and soaks, KITTI, session ----
    bf_knn.knn.launches = bf_knn.nearest_neighbor.launches = 0
    phase(13, "PHC LIO (tuned, phc_order=2, 50 frames of 20,000 points)", **phc_lio(dev, cfg, frames, gt))
    phase(13, f"online mapper ({DEPLOY_ONLINE_FRAMES} frames) and soaks ({DEPLOY_SOAK_S} s at 10 Hz)",
          **online_paths(str(_cuda.BUILD_DIR), smi))
    phase(13, f"KITTI ({DEPLOY_KITTI_FRAMES} frames of {DEPLOY_KITTI_POINTS} points)",
          nvidia_smi=smi, **kitti_paths(str(_cuda.BUILD_DIR)))
    session = mapping_session(dev, str(_cuda.BUILD_DIR))
    k1_k2 = [bf_knn.knn.launches, bf_knn.nearest_neighbor.launches]
    phase(13, "mapping session (start --mode fast --run --synthetic 20, save-map, pub-occ-map, stop)",
          k1_k2_launches=k1_k2, **session)
    check(k1_k2 == [0, 0], f"the deployed modes launched K1/K2 {k1_k2} times")

    # ---- 14. multi-device parallelism: ranks sharing the card over gloo, one rank over NCCL ----
    phase(14, f"parallel ({PAR_WORLD} ranks sharing the card over gloo, mesh (2, 2); 1 rank over NCCL)",
          nvidia_smi=smi, **run_parallel(dev, cfg, state, frames[-1]))
    check("jax" not in sys.modules and not any(m.split(".")[0] == "pointcloud_slam_tpu" for m in sys.modules),
          "the port imported jax or the JAX package")
    phase(15, "done", wall_s=time.perf_counter() - t_script)

    k1_bound, k1_bound_by = knn_bound_ms(pts.shape[1], pts.shape[1], 20)
    print(json.dumps({"kernels": [
        {"name": "bf_knn", "route": "cuda", "source": "pointcloud_slam_tpu_torch/csrc/bf_knn.cu",
         "replaces": "pointcloud_slam_tpu/ops/pallas/bf_knn.py:47", "launches": launches["bf_knn"],
         "max_abs_err": max(*sweep.values(), *(v["max_abs_err"] for v in (k1_20k, k1_map, *k1_pair.values(),
                                                                            *scan_fields.values()))),
         "ms": k1_map["ms"], "plain_ms": k1_map["plain_ms"], "bound_ms": k1_bound, "bound_by": k1_bound_by,
         "library_ms": None},
        {"name": "nearest_neighbor", "route": "cuda", "source": "pointcloud_slam_tpu_torch/csrc/bf_knn.cu",
         "replaces": "pointcloud_slam_tpu/ops/pallas/bf_knn.py:25", "launches": launches["nearest_neighbor"],
         "max_abs_err": nn_err, "ms": nn_ms, "plain_ms": nn_plain_ms, "bound_ms": nn_bound,
         "bound_by": nn_bound_by, "library_ms": None},
        {"name": "small_eigh", "route": "cuda", "source": "pointcloud_slam_tpu_torch/csrc/small_eigh.cu",
         "replaces": "pointcloud_slam_tpu/register/solver.py:107 (jnp.linalg.eigh; not a TPU kernel: it ends "
                     "torch.linalg.eigh's host read)", "launches": k6_main, "max_abs_err": k6_err,
         "ms": k6_t["batch_1_f32"]["ms"], "plain_ms": k6_t["batch_1_f32"]["plain_ms"],
         "bound_ms": k6_t["batch_1_f32"]["bound_ms"], "bound_by": k6_t["batch_1_f32"]["bound_by"],
         "library_ms": k6_t["batch_1_f32"]["library_ms"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
