"""2-D occupancy-grid mapping with log-odds updates and vectorized ray casting
(port of `pointcloud_slam_tpu/maps/occupancy.py`).

Behavioral parity target, as in the JAX package: reference
`src/tool/occupancy_mapping/` — `getScan` (mapping_server.cc:99-136, the
cloud -> virtual 360 degree scan with a z band and a per-angle minimum
range), `TraceLine` (:42-97, here a fixed-step DDA sampled along every beam
at once), `processScan` / `updateGrid` (occupancy_map.hpp:151-188, log-odds
accumulation, clamped), `getGridMap` / `publishMap` (:153-250, the trinary
-1/0/100 convention) and `saveMap` (:252-344, PGM + YAML with map_server's
0.196 / 0.65 thresholds).

The grid is one dense (size, size) tensor. The per-beam minimum is a
`scatter_reduce_("amin")` and the log-odds updates are `index_add_`s into a
flat buffer with one extra sink slot that takes the dropped samples (JAX's
`mode="drop"`). Every addend of one scatter has the same value, so the
order in which the card's atomics land does not change a cell's sum. Cell
and beam indices multiply by float32 reciprocals (`ops.downsample.recip32`)
as the card does for a division by a host scalar, so the card and the CPU
put every sample in the same cell. Pose and tile origin may be tensors or
Python floats; floats keep host-to-device copies (each a wait on the
stream) off the per-scan path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.downsample import recip32


@dataclasses.dataclass(frozen=True)
class OccupancyConfig:
    size: int = 1024                 # cells per side (dense tile)
    resolution: float = 0.1          # m / cell (map_resolution)
    origin: float = -51.2            # world coord of cell (0, 0)
    n_beams: int = 720               # angle_increment = 2 pi / n_beams
    max_range: float = 20.0
    min_range: float = 0.3
    min_z: float = 0.2               # z band (occupancy_mapping config)
    max_z: float = 1.2
    logodd_occ: float = 0.9          # log-odds increments (occupancy_map.hpp)
    logodd_free: float = -0.7
    logodd_min: float = -10.0
    logodd_max: float = 10.0
    occ_thresh: float = 0.65         # map_server occupied threshold
    free_thresh: float = 0.196       # map_server free threshold
    # white-fill beams with no return out to max_range (the reference's
    # use_nan option, mapping_server.cc processScan); False = skip them, so
    # unobserved directions never clear cells behind unseen geometry
    use_nan: bool = False


class OccupancyGrid(NamedTuple):
    logodds: torch.Tensor  # (size, size)


def create(cfg: OccupancyConfig, dtype=torch.float32, device="cuda") -> OccupancyGrid:
    """An empty grid, on the GPU unless `device` says otherwise."""
    return OccupancyGrid(logodds=torch.zeros((cfg.size, cfg.size), dtype=dtype, device=device))


def _xy(v):
    """A pose or origin pair as two scalars: 0-d tensors stay on their
    device, anything else becomes Python floats."""
    if torch.is_tensor(v):
        return v[0], v[1]
    return float(v[0]), float(v[1])


def cloud_to_scan(cfg: OccupancyConfig, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sensor-frame cloud (3, N) -> per-angle min range (n_beams,).

    Beams with no return in [min_range, max_range] carry +inf (the
    reference's NaN beams)."""
    x, y, z = points[0], points[1], points[2]
    rng = torch.sqrt(x * x + y * y)
    ang = torch.atan2(y, x)  # [-pi, pi)
    beam = torch.floor((ang + math.pi) * recip32(2 * math.pi) * cfg.n_beams).to(torch.int64)
    beam = torch.clamp(beam, 0, cfg.n_beams - 1)
    ok = mask & (z >= cfg.min_z) & (z <= cfg.max_z) & (rng >= cfg.min_range) & (rng <= cfg.max_range)
    tgt = torch.where(ok, beam, cfg.n_beams)
    ranges = torch.full((cfg.n_beams + 1,), math.inf, dtype=points.dtype, device=points.device)
    return ranges.scatter_reduce_(0, tgt, rng, "amin", include_self=True)[: cfg.n_beams]


def _add_drop(flat_lo: torch.Tensor, idx: torch.Tensor, value: float) -> torch.Tensor:
    """flat_lo (n + 1,) with `value` added at every idx (idx == n: the sink)."""
    return flat_lo.index_add_(0, idx.reshape(-1), torch.full((idx.numel(),), value, dtype=flat_lo.dtype,
                                                             device=flat_lo.device))


def insert_scan(cfg: OccupancyConfig, grid: OccupancyGrid, ranges: torch.Tensor, pose_xy, pose_yaw,
                origin=None) -> OccupancyGrid:
    """Log-odds update from a virtual scan at pose (x, y, yaw).

    Free cells along each beam (DDA at half-resolution steps, consecutive
    duplicate cells of a beam counted once), occupied cell at each hit.
    Matches processScan (mapping_server.cc:346-382). `origin` (2,)
    overrides cfg.origin: the tiled map passes each tile's world origin."""
    B = cfg.n_beams
    size, res = cfg.size, cfg.resolution
    dtype, dev = grid.logodds.dtype, grid.logodds.device
    ox, oy = (cfg.origin, cfg.origin) if origin is None else _xy(origin)
    px, py = _xy(pose_xy)
    angles = (torch.arange(B, dtype=dtype, device=dev) + 0.5) * (2 * math.pi / B) - math.pi + pose_yaw
    hit = torch.isfinite(ranges)
    r = torch.where(hit, ranges, cfg.max_range)
    beam_used = hit | cfg.use_nan
    dirx, diry = torch.cos(angles), torch.sin(angles)

    # DDA free-space sampling: steps at half-resolution up to just short of r
    n_steps = int(cfg.max_range / (res * 0.5)) + 1
    step = torch.arange(n_steps, dtype=dtype, device=dev)[None, :] * (res * 0.5)
    along = torch.minimum(step, (r - res)[:, None])
    fx = px + dirx[:, None] * along
    fy = py + diry[:, None] * along
    free_ok = (step <= (r - res)[:, None]) & beam_used[:, None]
    inv = recip32(res)
    ci = torch.floor((fx - ox) * inv).to(torch.int64)
    cj = torch.floor((fy - oy) * inv).to(torch.int64)
    inb = (ci >= 0) & (ci < size) & (cj >= 0) & (cj < size) & free_ok
    flat = torch.where(inb, ci * size + cj, size * size)
    # dedup per beam: consecutive duplicate cells add once (first occurrence)
    dup = torch.zeros_like(inb)
    dup[:, 1:] = flat[:, 1:] == flat[:, :-1]
    flat = torch.where(dup, size * size, flat)
    lo = torch.cat([grid.logodds.reshape(-1), grid.logodds.new_zeros(1)])
    lo = _add_drop(lo, flat, cfg.logodd_free)

    # occupied cells at hits
    hx = px + dirx * r
    hy = py + diry * r
    oi = torch.floor((hx - ox) * inv).to(torch.int64)
    oj = torch.floor((hy - oy) * inv).to(torch.int64)
    oin = hit & (oi >= 0) & (oi < size) & (oj >= 0) & (oj < size)
    lo = _add_drop(lo, torch.where(oin, oi * size + oj, size * size), cfg.logodd_occ)
    lo = torch.clamp(lo[: size * size], cfg.logodd_min, cfg.logodd_max)
    return OccupancyGrid(logodds=lo.reshape(size, size))


def insert_cloud(cfg: OccupancyConfig, grid: OccupancyGrid, points: torch.Tensor, mask: torch.Tensor, pose_xy,
                 pose_yaw, origin=None) -> OccupancyGrid:
    """World-frame cloud (3, N) seen from pose (x, y, yaw) -> scan -> log-odds update."""
    px, py = _xy(pose_xy)
    # rotate into the scan frame so beams line up with pose_yaw (a float
    # yaw: its float32 cos / sin on the host, passed as scalars)
    yaw = pose_yaw if torch.is_tensor(pose_yaw) else torch.tensor(pose_yaw, dtype=points.dtype)
    c, s = torch.cos(-yaw), torch.sin(-yaw)
    if not torch.is_tensor(pose_yaw):
        c, s = float(c), float(s)
    rel_x, rel_y = points[0] - px, points[1] - py
    rx = c * rel_x - s * rel_y
    ry = s * rel_x + c * rel_y
    ranges = cloud_to_scan(cfg, torch.stack([rx, ry, points[2]], dim=0), mask)
    return insert_scan(cfg, grid, ranges, pose_xy, pose_yaw, origin)


def to_probability(cfg: OccupancyConfig, grid: OccupancyGrid) -> torch.Tensor:
    """Sigmoid(logodds) (getGridMap)."""
    return torch.sigmoid(grid.logodds)


def to_ros_grid(cfg: OccupancyConfig, grid: OccupancyGrid) -> torch.Tensor:
    """Trinary int8 map: -1 unknown, 0 free, 100 occupied (publishMap)."""
    p = to_probability(cfg, grid)
    out = torch.where(p > cfg.occ_thresh, 100, torch.where(p < cfg.free_thresh, 0, -1))
    return torch.where(grid.logodds == 0.0, -1, out).to(torch.int8)


def load_pgm(path: str):
    """Load a PGM+YAML map pair back into (trinary int8 grid, meta dict) —
    the map_server image_loader role. Returns the grid in this module's
    axis convention (numpy)."""
    from ..utils import config as cfgio

    meta = cfgio.load_yaml(path + ".yaml")
    with open(path + ".pgm", "rb") as f:
        magic = f.readline().strip()
        if magic != b"P5":
            raise ValueError(f"unsupported PGM magic {magic!r}")
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = (int(v) for v in line.split())
        int(f.readline())  # maxval
        img = np.frombuffer(f.read(w * h), np.uint8).reshape(h, w)
    # undo the save transform: rows were flipud(img.T)
    raw = np.flipud(img).T
    occ_th = float(meta.get("occupied_thresh", 0.65))
    free_th = float(meta.get("free_thresh", 0.196))
    occ = (255 - raw) / 255.0  # map_server occupancy convention (negate=0)
    grid = np.full(raw.shape, -1, np.int8)
    grid[occ > occ_th] = 100
    grid[occ < free_th] = 0
    return grid, meta


def save_pgm(cfg: OccupancyConfig, grid: OccupancyGrid, path: str, origin=None):
    """PGM + YAML export, map_server conventions (saveMap :252-344). One
    read-back of the grid."""
    ox, oy = (cfg.origin, cfg.origin) if origin is None else (float(origin[0]), float(origin[1]))
    lo = grid.logodds
    lo = lo.detach().cpu().numpy() if torch.is_tensor(lo) else np.asarray(lo)
    p = torch.sigmoid(torch.from_numpy(lo)).numpy()
    unknown = lo == 0.0
    img = np.full(p.shape, 205, np.uint8)  # unknown gray
    img[(~unknown) & (p < cfg.free_thresh)] = 254
    img[(~unknown) & (p > cfg.occ_thresh)] = 0
    # PGM row 0 = top: flip the y (j) axis; our axes: i = x cell, j = y cell
    img = np.flipud(img.T)
    with open(path + ".pgm", "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())
    with open(path + ".yaml", "w") as f:
        f.write(
            f"image: {path}.pgm\nresolution: {cfg.resolution}\n"
            f"origin: [{ox}, {oy}, 0.0]\nnegate: 0\n"
            f"occupied_thresh: {cfg.occ_thresh}\nfree_thresh: {cfg.free_thresh}\n"
        )
