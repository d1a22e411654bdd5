"""Prior-map NDT localization (`models/localization/pipeline.localize_ndt`)
as a deployed robot's localization node runs it: one deskewed sweep in,
matched against the prior map from the previous frame's pose, one pose and
its fitness gate out.

Set-up: the prior map is drawn from the hall's surfaces and baked into the
port's NDT map and point map (as the localization app builds them, at the
configuration's NDT resolution), the kernel library is built or loaded, the
lap's sweeps are cast, and the first sweeps are localized from the true
start pose. The window replays the lap, lap after lap; each frame starts
from the previous frame's result, and a lost frame restarts from the start
pose, as the app does.

Correctness: the plain reference (`reference/localization.py`) builds its
own NDT and point maps from the same prior points, and repeats each of a
seed-drawn sample of the window's frames (and the set-up's first, from the
true start pose, which checks the start by itself) from the initial pose
the port used: the NDT align with its final eigenvalues (K6 in the port,
`torch.linalg.eigvalsh` here) and the fitness gate. Numbers: `pose_gap_m`,
`rot_gap_rad`, `fitness_gap_m2` (the gate's mean squared distance) and
`eig_rel_gap` (the largest Hessian eigenvalue, relative). A lost frame
counts as failed.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from portbench.harness import core
from portbench.harness import world as W
from portbench.pipelines.lio import _gaps, tf32
from portbench.reference import localization as ref_loc
from portbench.reference import ndt as ref_ndt
from portbench.reference import se3 as ref_se3
from portbench.reference import voxel_grid as ref_grid

CALL_NAME = "localize_ndt"
KERNELS = {"k6": "small_eigh_kernel"}    # metric key -> substring of the kernel's name in the trace
SAMPLES = 12


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device, impl: str = "program"):
        self.config, self.traffic, self.seed, self.dev, self.impl = config, traffic, seed, device, impl
        self.samples, self.sampling = [], False

    # ---- set-up -------------------------------------------------------
    def setup(self):
        from pointcloud_slam_tpu_torch import ops, register
        from pointcloud_slam_tpu_torch.geom import se3
        from pointcloud_slam_tpu_torch.models.localization import pipeline as loc

        cfg, tr, dev = self.config, self.traffic, self.dev
        t0 = time.perf_counter()
        loc_cfg, ndt_cfg = cfg["localization"], cfg["ndt"]
        G = core.load_module("generators", tr["generator"])
        self.world = G.world(tr)
        self.lap = G.path(tr, self.seed)
        self.sensor = W.sensor_from_config(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed % (1 << 63))
        pm = cfg["prior_map"]
        self.prior = G.prior_map(self.world, pm["density_per_m2"], pm["noise_m"], gen, dev)
        sweep = tr["sweep_s"]
        self.n_lap = round(G.period_s(self.lap) / sweep)
        t_start = torch.arange(self.n_lap, dtype=torch.float64, device=dev) * sweep
        chunks = [G.sweeps(self.world, self.lap, self.sensor, t, sweep, True, gen) for t in t_start.split(16)]
        pts, mask, _ = (torch.cat(c) for c in zip(*chunks))
        # the app's --n_points, as a fixed stride of columns over every ring
        per_ring = cfg["n_points"] // self.sensor.rings
        cols = (torch.arange(per_ring, device=dev) * self.sensor.columns) // per_ring
        idx = (torch.arange(self.sensor.rings, device=dev)[:, None] * self.sensor.columns + cols[None, :]).reshape(-1)
        self.pts, self.mask = pts[:, :, idx].contiguous(), mask[:, idx].contiguous()
        R, o = G.lidar_pose(self.lap, self.sensor, t_start + sweep)
        self.truth = o.cpu().numpy()
        self.start = (R[-1].to(torch.float32), o[-1].to(torch.float32))      # the end of the sweep before the first
        t1 = time.perf_counter()

        self.ref_cfg = ref_loc.LocalizationConfig(
            ndt=ref_ndt.NDTConfig(resolution=ndt_cfg["resolution"]),
            point_grid=ref_grid.GridConfig(**cfg["point_grid"]), **loc_cfg)
        if self.impl == "program":
            self.cfg = loc.LocalizationConfig(method="ndt", ndt=register.NDTConfig(resolution=ndt_cfg["resolution"]),
                                              **loc_cfg)
            pgrid = ops.GridConfig(**cfg["point_grid"])
            _, point_map = register.build_target_map(self.prior, grid_cfg=pgrid)
            ndt_grid, ndt_map = register.ndt.build_target(self.cfg.ndt, self.prior, capacity=ndt_cfg["capacity"],
                                                          baked=ndt_cfg["baked"])
            self.init = se3.Pose(*self.start)

            def step(init, pts, mask):
                res = loc.localize_ndt(self.cfg, ndt_grid, ndt_map, pgrid, point_map, pts, mask, init)
                return res, loc.relocalize(res, self.init)
        elif self.impl == "control":     # the reference with its float32 products in TF32
            point_map, ndt_grid, ndt_map = self._ref_maps()
            self.init = ref_se3.Pose(*self.start)

            def step(init, pts, mask):
                with tf32(True):
                    res = ref_loc.localize_ndt(self.ref_cfg, ndt_grid, ndt_map, point_map, pts, mask, init)
                return res, ref_loc.relocalize(res, self.init)
        else:
            raise ValueError(f"unknown impl {self.impl!r}")
        self.step = step
        self.pose = self.init
        t2 = time.perf_counter()
        self.k = 0
        self.start_item = None
        for _ in range(cfg["setup_sweeps"]):
            out = self.call()
            pose = self.pose_to_host(out)
            if self.start_item is None:
                self.start_item = self._last + (pose,)
            self.after(out, pose)
        self.setup_parts = {"traffic": t1 - t0, "maps": t2 - t1, "sweeps": time.perf_counter() - t2}

    def _ref_maps(self):
        """The reference's own point and NDT maps of the prior points."""
        nd = self.config["ndt"]
        point_map = ref_loc.build_target_map(self.ref_cfg.point_grid, self.prior)
        ndt_grid, ndt_map = ref_ndt.build_target(self.ref_cfg.ndt, self.prior, capacity=nd["capacity"],
                                                 baked=nd["baked"])
        return point_map, ndt_grid, ndt_map

    # ---- the frame loop -----------------------------------------------
    def call(self):
        init, k = self.pose, self.k
        i = k % self.n_lap
        res, self.pose = self.step(init, self.pts[i], self.mask[i])
        self.k += 1
        self._last = (k, init, res)
        return res

    def pose_to_host(self, res) -> np.ndarray:
        return torch.cat([res.pose.t, res.pose.R.reshape(9), res.fitness[None], res.lost[None].to(res.fitness.dtype),
                          res.max_eigen[None]]).cpu().numpy()

    def after(self, res, pose) -> bool:
        ok = bool(np.isfinite(pose).all()) and pose[13] == 0.0
        if self.sampling:
            self.seen += 1
            item = self._last + (pose,)
            if len(self.samples) < SAMPLES:
                self.samples.append(item)
            else:
                j = self.rng.randrange(self.seen)
                if j < SAMPLES:
                    self.samples[j] = item
            gt = self.truth[self._last[0] % self.n_lap]
            self.gt_err = max(self.gt_err, float(np.linalg.norm(pose[:3] - gt)))
        return ok

    def window_open(self, rng: random.Random):
        self.rng, self.seen, self.sampling, self.gt_err = rng, 0, True, 0.0

    def window_close(self):
        self.sampling = False

    def kernel_probes(self, calls: dict):
        """Record the shape of every K6 launch while the frames are traced:
        calls["k6"] gets (batch, n, bytes a value, with eigenvectors)."""
        from pointcloud_slam_tpu_torch.ops import small_eigh

        seen, launch = calls.setdefault("k6", []), small_eigh._launch

        def spy(A, vectors):
            n = A.shape[-1]
            seen.append((A.numel() // (n * n), n, A.element_size(), bool(vectors)))
            return launch(A, vectors)

        small_eigh._launch = spy

        def restore():
            small_eigh._launch = launch

        return restore

    # ---- the comparison with the reference ------------------------------
    def check(self) -> dict:
        self.pose = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        point_map, ndt_grid, ndt_map = self._ref_maps()
        gaps = dict(pose_gap_m=0.0, rot_gap_rad=0.0, fitness_gap_m2=0.0, eig_rel_gap=0.0)
        for k, init, _, pose in [self.start_item] + self.samples:
            i = k % self.n_lap
            ref_init = ref_se3.Pose(init.R, init.t)
            r = ref_loc.localize_ndt(self.ref_cfg, ndt_grid, ndt_map, point_map, self.pts[i], self.mask[i], ref_init)
            p, rot = _gaps(pose, r.pose.t, r.pose.R)
            eig = float(r.max_eigen)
            gaps["pose_gap_m"] = max(gaps["pose_gap_m"], p)
            gaps["rot_gap_rad"] = max(gaps["rot_gap_rad"], rot)
            gaps["fitness_gap_m2"] = max(gaps["fitness_gap_m2"], abs(float(pose[12]) - float(r.fitness)))
            gaps["eig_rel_gap"] = max(gaps["eig_rel_gap"], abs(float(pose[14]) - eig) / max(abs(eig), 1e-30))
        return gaps

    def info(self) -> dict:
        return {"gt_err_m": self.gt_err, "frames_compared": len(self.samples) + 1}

