"""The LIO odometry pipeline (`models/lio/pipeline.lio_step`) as a robot's
mapping node runs it: one sweep with its IMU samples in, one pose out.

Set-up: the lap's sweeps and IMU samples are cast on the run's device by the
traffic mix's generator, then the port's filter starts from a fresh state on
still sweeps (IMU initialization and the first scan's map) and walks one
lap, which builds the map the window localizes against. The window replays
the lap, lap after lap, from where set-up left it.

Correctness: once the window has closed, the plain reference
(`reference/lio.py`) walks the same sweeps from its own fresh state: the
still sweeps, the set-up lap and every window frame, each through the whole
frame step (propagation and undistortion, downsample, the map k-NN and plane
fits, the float64 iterated update, the map insert), so its map and state are
its own. The walk takes the window's first `check_sweeps` sweeps (a
number of the configuration, two laps), so that its time stays under the
window's however fast the port becomes. Every pose the port published on the
way is compared with the reference's (`pose_gap_m`, `rot_gap_rad`, worst
sweep); at a seed-drawn sample of those window sweeps, and at the still
sweeps, so is the published covariance (`cov_rel_gap`) and the whole map
(`map_mismatch`: the share of map points that only one side holds, bit for
bit).
"""

from __future__ import annotations

import contextlib
import math
import random
import time

import numpy as np
import torch

from portbench.harness import core
from portbench.harness import world as W
from portbench.reference import lio as ref_lio
from portbench.reference import voxel_grid as ref_grid

CALL_NAME = "lio_step"
KERNELS = {}                # no hand-written kernel lies on this path
SAMPLES = 12                # window frames compared with the reference


@contextlib.contextmanager
def tf32(on: bool):
    """float32 matrix products in TF32 (the precision control) or not."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def lio_kwargs(config: dict) -> dict:
    """LIOConfig's fields from the configuration file (grid apart)."""
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in config["lio"].items() if k != "grid"}
    return kw


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device, impl: str = "program"):
        self.config, self.traffic, self.seed, self.dev, self.impl = config, traffic, seed, device, impl
        self.samples, self.sampling, self.recording = [], False, True
        self.walk_end = math.inf           # set-up: every sweep is walked

    # ---- set-up -------------------------------------------------------
    def setup(self):
        from pointcloud_slam_tpu_torch import ops
        from pointcloud_slam_tpu_torch.models.lio import pipeline as lp

        cfg, tr, dev = self.config, self.traffic, self.dev
        t0 = time.perf_counter()
        self.cfg = lp.LIOConfig(grid=ops.GridConfig(**cfg["lio"]["grid"]), **lio_kwargs(cfg))
        self.ref_cfg = ref_lio.LIOConfig(grid=ref_grid.GridConfig(**cfg["lio"]["grid"]), **lio_kwargs(cfg))
        G = self.gen_mod = core.load_module("generators", tr["generator"])
        self.world = G.world(tr)
        self.lap = G.path(tr, self.seed)
        self.sensor = W.sensor_from_config(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed % (1 << 63))
        sweep, m = tr["sweep_s"], cfg["imu_per_sweep"]
        self.n_lap = round(G.period_s(self.lap) / sweep)
        t_start = torch.arange(self.n_lap, dtype=torch.float64, device=dev) * sweep
        chunks = [G.sweeps(self.world, self.lap, self.sensor, t, sweep, False, gen) for t in t_start.split(16)]
        pts, mask, t_offs = (torch.cat(c) for c in zip(*chunks))
        acc, gyro, dt, offs = G.imu_samples(self.lap, t_start, sweep, m)
        imu_mask = torch.ones(m, dtype=torch.bool, device=dev)
        self.lap_frames = [lp.LIOFrame(pts[i], mask[i], t_offs[i], acc[i], gyro[i], dt[i], offs[i], imu_mask)
                           for i in range(self.n_lap)]
        # still sweeps: the robot stands at the lap's start pose before it walks
        n_still = tr["still_sweeps"]
        sp, sm, so = G.sweeps(self.world, self.lap, self.sensor,
                              torch.full((n_still,), -sweep, dtype=torch.float64, device=dev), sweep, True, gen)
        R0, _, _, _ = G.imu_state(self.lap, torch.zeros((), dtype=torch.float64, device=dev))
        g_body = (R0.T @ torch.tensor([0.0, 0.0, W.GRAVITY], dtype=torch.float64, device=dev)).to(torch.float32)
        self.still_frames = [lp.LIOFrame(sp[i], sm[i], so[i], g_body.expand(m, 3).contiguous(),
                                         torch.zeros((m, 3), device=dev), dt[0], offs[0], imu_mask)
                             for i in range(n_still)]
        self.truth = self._truth(t_start + sweep, R0)
        t1 = time.perf_counter()
        if self.impl == "program":
            self.state = lp.create_state(self.cfg, device=dev)
            self.step = lambda s, f: lp.lio_step(self.cfg, s, f)
        elif self.impl == "control":      # the reference with its float32 products in TF32
            self.state = ref_lio.create_state(self.ref_cfg, device=dev)

            def step(s, f):
                with tf32(True):
                    return ref_lio.lio_step(self.ref_cfg, s, f)
            self.step = step
        elif self.impl == "control_f32_update":   # the reference, its 23x23 update in float32
            ccfg = ref_lio.LIOConfig(grid=self.ref_cfg.grid, update_dtype=torch.float32, **lio_kwargs(cfg))
            self.state = ref_lio.create_state(ccfg, device=dev)
            self.step = lambda s, f: ref_lio.lio_step(ccfg, s, f)
        else:
            raise ValueError(f"unknown impl {self.impl!r}")
        self.k = -n_still                 # negative: still sweeps; then lap sweeps k % n_lap
        self.poses = {}                   # k -> the pose published for sweep k (set-up and window)
        self.start_items = []             # (k, state after, pose) of the still sweeps
        n_setup = cfg.get("setup_laps", 0) * self.n_lap + cfg.get("setup_sweeps", 0)
        for i in range(n_still + n_setup):
            out = self.call()
            pose = self.pose_to_host(out)
            if i < n_still:
                self.start_items.append(self._last + (pose,))
            self.after(out, pose)
        self.setup_parts = {"traffic": t1 - t0, "sweeps": time.perf_counter() - t1}

    def _truth(self, t_end, R0):
        """The IMU's true position at each lap sweep's end, in the filter's
        frame (the IMU frame at the start, where initialization leaves it):
        (n, 3) float64 on the host."""
        _, p, _, _ = self.gen_mod.imu_state(self.lap, t_end)
        _, p0, _, _ = self.gen_mod.imu_state(self.lap, torch.zeros((), dtype=torch.float64, device=self.dev))
        return (R0.T @ (p - p0)[..., None])[..., 0].cpu().numpy()

    def _frame(self, k):
        return self.still_frames[k + len(self.still_frames)] if k < 0 else self.lap_frames[k % self.n_lap]

    # ---- the frame loop -----------------------------------------------
    def call(self):
        k = self.k
        self.state, out = self.step(self.state, self._frame(k))
        self.k += 1
        self._last = (k, self.state)
        return out

    def pose_to_host(self, out) -> np.ndarray:
        return torch.cat([out.pos, out.rot.reshape(9)]).cpu().numpy()

    def after(self, out, pose) -> bool:
        ok = bool(np.isfinite(pose).all())
        k, post = self._last
        if self.sampling:
            gt = self.truth[k % self.n_lap]
            self.gt_err = max(self.gt_err, float(np.linalg.norm(pose[:3] - gt)))
        if self.recording and k <= self.walk_end:
            self.poses[k] = pose
            if self.sampling:
                self.seen += 1
                item = (k, post, pose)
                if len(self.samples) < SAMPLES:
                    self.samples.append(item)
                else:
                    j = self.rng.randrange(self.seen)
                    if j < SAMPLES:
                        self.samples[j] = item
        return ok

    def window_open(self, rng: random.Random):
        self.rng, self.seen, self.sampling, self.gt_err = rng, 0, True, 0.0
        self.walk_end = self.k + self.config["check_sweeps"] - 1

    def window_close(self):
        self.sampling = self.recording = False
        self.last_k = min(self.k - 1, self.walk_end)    # the last sweep the reference walks to

    def kernel_probes(self, calls: dict):
        return lambda: None

    # ---- the comparison with the reference ------------------------------
    def check(self) -> dict:
        """The reference walks every sweep from its own fresh state to the
        last one recorded; the port's published poses are compared at every
        sweep, its covariance and map at the still sweeps and the sampled
        window sweeps."""
        self.state = None          # the port's live state goes; the samples keep theirs
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        cfg = self.ref_cfg
        at = {k: (post, pose) for k, post, pose in self.start_items + self.samples}
        ks = sorted(k for k in self.poses if k <= self.last_k)
        s = ref_lio.create_state(cfg, device=self.dev)
        ref_pos, ref_rot = [], []
        cov_gap, mismatch = 0.0, 0.0
        for k in range(ks[0], self.last_k + 1):
            s, o = ref_lio.lio_step(cfg, s, self._frame(k))
            ref_pos.append(o.pos)
            ref_rot.append(o.rot)
            if k in at:
                post, _ = at[k]
                cov_gap = max(cov_gap, float(((torch.diagonal(post.P) - o.P_diag).abs() / o.P_diag.abs()).max()))
                mismatch = max(mismatch, map_mismatch(post.grid, s.grid))
        ref_pos = torch.stack(ref_pos).double().cpu().numpy()
        ref_rot = torch.stack(ref_rot).double().cpu().numpy()
        port = np.stack([self.poses[k] for k in ks]).astype(np.float64)
        d_pos = np.linalg.norm(port[:, :3] - ref_pos, axis=1)
        d_rot = np.linalg.norm(port[:, 3:12].reshape(-1, 3, 3) - ref_rot, axis=(1, 2)) / math.sqrt(2.0)
        self.gaps = [(k, float(d_pos[i])) for i, k in enumerate(ks) if k in at]
        self.walked = len(ks)
        return {"pose_gap_m": float(d_pos.max()), "rot_gap_rad": float(d_rot.max()), "cov_rel_gap": cov_gap,
                "map_mismatch": mismatch}

    def info(self) -> dict:
        return {"gt_err_m": self.gt_err, "frames_compared": getattr(self, "walked", 0),
                "maps_compared": len(self.samples) + len(self.start_items), "gaps_m": getattr(self, "gaps", None)}


def map_mismatch(a, b) -> float:
    """Share of the points of two voxel maps that only one of them holds, bit
    for bit: 0 where both hold the same points, whatever slots they sit in."""
    def bits(g):
        K = g.pts.shape[1]
        live = (torch.arange(K, device=g.pts.device)[:, None] < g.npts[None, :]) & g.occupied[None, :]
        return torch.unique(g.pts.permute(1, 2, 0)[live].contiguous().view(torch.int32), dim=0)

    x, y = bits(a), bits(b)
    n = x.shape[0] + y.shape[0]
    _, c = torch.unique(torch.cat([x, y]), dim=0, return_counts=True)
    return int((c == 1).sum()) / n if n else 0.0


def _gaps(pose: np.ndarray, pos: torch.Tensor, rot: torch.Tensor):
    """(position gap m, rotation gap rad) of a host pose (position, row-major
    rotation) against a reference pose. The rotation gap is |Ra - Rb|_F / sqrt 2,
    the angle between two rotations to first order, and exactly 0 for equal
    matrices (an arccos of the trace loses float32's last bits)."""
    p = float(np.linalg.norm(pose[:3] - pos.detach().cpu().numpy().astype(np.float64)))
    Ra = pose[3:12].reshape(3, 3).astype(np.float64)
    Rb = rot.detach().cpu().numpy().astype(np.float64)
    return p, float(np.linalg.norm(Ra - Rb) / math.sqrt(2.0))
