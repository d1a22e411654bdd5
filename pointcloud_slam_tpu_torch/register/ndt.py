"""Point-to-distribution NDT registration against a Gaussian voxel map
(port of `pointcloud_slam_tpu/register/ndt.py`).

Reference: `pointcloud_match/ndt_omp/include/pclomp/ndt_omp.h` /
`ndt_omp_impl.hpp` — Magnusson's NDT with the exponential score
s = -d1 exp(-d2/2 q^T S^-1 q), gauss_d1/d2 from the outlier ratio,
DIRECT1/7/27 stencil correspondences and the Hessian-eigenvalue export
(`getMaxEigen`, ndt_omp.h:209-223); and `fast_gicp/.../ndt_cuda.hpp`
(NDTCuda) for the P2D and D2D modes.

The More-Thuente line search of the reference is the shared
Levenberg-Marquardt-damped Gauss-Newton step (`solver._gn_update`), with
the Gauss-Newton approximation of the exponential score. The search
schedule is static (warm-up rounds of one iteration, then rounds of
`search_every`), so an align is a fixed sequence of launches with no host
read: the final eigenvalues are `ops.small_eigh.eigvalsh` (kernel K6 on the
card; `torch.linalg.eigvalsh` would check its info on the host).

On the card, `align` replays its schedule as one CUDA graph a call from
the second call with the same maps, shapes and configs on (`_graph_key`):
the same kernels in the same order, one launch from the host instead of
~5,400. The graphs are held in a small least-recently-used cache
(`GRAPH_CACHE`); a key seen once runs eagerly.

`align`'s spans (`utils/timer.Timer`): `ndt.align`, inside it `ndt.search`
each correspondence search, `ndt.linearize` and `ndt.solve` each
Gauss-Newton iteration (these three only where the schedule runs eagerly),
`ndt.linearize` the last linearization and `ndt.eig` the final eigenvalues
(always eager); counts `ndt.iterations` (the updates run),
`ndt.graph_captures` and `ndt.graph_replays`, and, from the result's
`iterations` without a read, `ndt.iterations_used` (those before `done`).

The unbaked correspondence search is one `gg.probe` of every (point,
stencil offset) pair and a gather of the matched voxels' statistics: the
JAX package's rolled probe-window tables (`_correspond`) suit TPU gather
rates and are not ported. The 6x6 normal equations are contractions of the
stacked Jacobian columns; the sums run in another order than the JAX
package's 27 scalar reductions.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from collections import OrderedDict
from typing import NamedTuple, Optional

import torch

from .. import ops
from ..geom import se3
from ..ops import gaussian_grid as gg
from ..ops import small_eigh
from ..ops.voxel_grid import _stencil_tensor
from ..utils.timer import Timer
from . import solver
from .vgicp import _check_bake_coverage, _point_jacobian, _src_cov_world, _sym3, _sym_inv3, _weighted_terms


@dataclasses.dataclass(frozen=True)
class NDTConfig:
    resolution: float = 1.0
    outlier_ratio: float = 0.55      # pclomp default
    min_points_per_voxel: int = 6
    nearby: int = 7                  # DIRECT1 / DIRECT7 / DIRECT27
    search_every: int = 5
    # one-iteration rounds before the regular cadence (see Scan2MapConfig)
    warmup_searches: int = 2
    solver: solver.SolverConfig = dataclasses.field(
        default_factory=lambda: solver.SolverConfig(max_iterations=35)
    )

    def gauss_coeffs(self):
        """(d1, d2) from resolution + outlier ratio (ndt_omp_impl.hpp init)."""
        c1 = 10.0 * (1.0 - self.outlier_ratio)
        c2 = self.outlier_ratio / (self.resolution ** 3)
        d3 = -math.log(c2)
        d1 = -math.log(c1 + c2) - d3
        d2 = -2.0 * math.log((-math.log(c1 * math.exp(-0.5) + c2) - d3) / d1)
        return d1, d2


class NDTResult(NamedTuple):
    pose: se3.Pose
    converged: torch.Tensor
    iterations: torch.Tensor
    score: torch.Tensor
    H: torch.Tensor          # (6, 6) final Hessian (getFinalHessian / getMaxEigen)
    max_eigen: torch.Tensor  # largest Hessian eigenvalue (degeneracy judge)


def build_target(cfg: NDTConfig, target: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 capacity: int = 1 << 16, baked: bool = False, baked_capacity: Optional[int] = None):
    """Voxelize the target cloud into Gaussian statistics (VoxelGridCovariance)
    on the target's device. baked=True expands the map with gg.bake: a search
    is then one probe and one wide gather per point instead of `nearby`
    probes — identical results; `baked_capacity` (default 4x) must exceed the
    voxels any stencil neighbourhood covers (a shortfall warns, the one host
    read of a baked build)."""
    if mask is None:
        mask = torch.ones(target.shape[1], dtype=torch.bool, device=target.device)
    grid_cfg = ops.GridConfig(capacity=capacity, resolution=cfg.resolution, nearby=cfg.nearby)
    g = gg.build(grid_cfg, target, mask, mode="ndt", min_points=cfg.min_points_per_voxel)
    if not baked:
        return grid_cfg, g
    baked_cfg = ops.GridConfig(capacity=baked_capacity or 4 * capacity, resolution=cfg.resolution,
                               nearby=cfg.nearby)
    baked_map = gg.bake(grid_cfg, g, baked_cfg)
    _check_bake_coverage(baked_map, baked_cfg)
    return baked_cfg, baked_map


def _correspond(cfg: NDTConfig, grid_cfg, g: gg.GaussianVoxelMap, pw, mask):
    """Per (point, stencil-voxel) Gaussians: means (3,S,N), icovs (6,S,N),
    valid (S,N); statistics are zero where not valid."""
    slot = gg.probe_stencil(grid_cfg, g, ops.point_to_voxel(pw, cfg.resolution), cfg.nearby)
    safe = torch.clamp(slot, min=0)
    valid = (slot >= 0) & g.valid[safe] & mask[None, :]
    return (torch.where(valid, g.mean[:, safe], 0.0), torch.where(valid, g.icov[:, safe], 0.0), valid)


def _correspond_baked(cfg: NDTConfig, baked_cfg, b: gg.BakedGaussianMap, pw, mask):
    """Stencil-baked correspondence: same outputs as _correspond from ONE
    fingerprint probe + ONE (S*10, C) column gather per query (gg.baked_probe)."""
    coords = ops.point_to_voxel(pw, cfg.resolution)
    ent, found = gg.baked_probe(baked_cfg, b, coords, b.entries)
    valid = (ent[:, 0] > 0.5) & found[None, :] & mask[None, :]
    return (torch.where(valid, ent[:, 1:4].transpose(0, 1), 0.0),
            torch.where(valid, ent[:, 4:10].transpose(0, 1), 0.0), valid)


def _linearize_cached(d1, d2, means, icovs, valid, pw, src):
    """GN linearization of the NDT exponential score at pose-transformed pw.

    Per correspondence: q = pw - mean; e = q^T S^-1 q; score contribution
    -d1 exp(-d2/2 e); weight w = -d1 d2 exp(-d2/2 e) > 0 (d1 < 0). The
    Jacobian depends only on the point, so the stencil axis collapses first:
    per point r = sum_s w S^-1 q and A = sum_s w S^-1, then
    b = sum_n J^T r and H = sum_n J^T A J. Returns (H, b, -score)."""
    q = pw[:, None, :] - means                                    # (3, S, N)
    Sq = torch.einsum("abpn,bpn->apn", _sym3(icovs), q)           # S^-1 q
    e = torch.clamp(torch.sum(q * Sq, dim=0), 0.0, 50.0)
    w = torch.where(valid, -d1 * d2 * torch.exp(-0.5 * d2 * e), 0.0)
    score = torch.sum(w) / d2
    r = torch.sum(w * Sq, dim=1)                                   # (3, N)
    A = _sym3(torch.sum(w * icovs, dim=1))                         # (3, 3, N)
    J = _point_jacobian(pw)
    AJ = torch.einsum("abn,bin->ain", A, J)
    H = torch.einsum("ain,ajn->ij", J, AJ)
    b = torch.einsum("ain,an->i", J, r)
    return 0.5 * (H + H.T), b, -score


def voxelize_source(cfg: NDTConfig, source: torch.Tensor, mask: Optional[torch.Tensor] = None,
                    capacity: int = 1 << 14, compact_to: int = 1 << 13):
    """Source-side Gaussian voxelization for D2D mode (NDTCuda's source
    voxelmap). Returns (means (3, C), covs (6, C), valid (C,), count (C,)).

    `compact_to` gathers the valid voxels to the front of a C=compact_to
    array, in slot order (a stable sort on the valid flag: the JAX package's
    `top_k` keeps the lowest index first among equal flags). Past
    `compact_to` valid voxels the rest are dropped silently, as in the JAX
    package. 0 keeps the raw capacity layout."""
    if mask is None:
        mask = torch.ones(source.shape[1], dtype=torch.bool, device=source.device)
    grid_cfg = ops.GridConfig(capacity=capacity, resolution=cfg.resolution, nearby=1)
    g = gg.build(grid_cfg, source, mask, mode="ndt", min_points=cfg.min_points_per_voxel)
    if not compact_to or compact_to >= capacity:
        return g.mean, g.cov, g.valid, g.count
    idx = torch.sort(g.valid.to(torch.int32), descending=True, stable=True).indices[:compact_to]
    return g.mean[:, idx], g.cov[:, idx], g.valid[idx], g.count[idx]


def _stencil_stats(cfg: NDTConfig, grid_cfg, target, coords):
    """Target Gaussians of every (stencil offset, source voxel): ok (S, C),
    mean (3, S, C), cov (6, S, C). A baked target answers all offsets from
    one probe and one (S*10)-row gather (gg.bake)."""
    if isinstance(target, gg.BakedGaussianMap):
        packed = torch.cat([target.entries[:, 0:4], target.covs], dim=1)   # (S, 10, C)
        ent, found = gg.baked_probe(grid_cfg, target, coords, packed)
        return (ent[:, 0] > 0.5) & found[None, :], ent[:, 1:4].transpose(0, 1), ent[:, 4:10].transpose(0, 1)
    slot = gg.probe_stencil(grid_cfg, target, coords, cfg.nearby)
    safe = torch.clamp(slot, min=0)
    return (slot >= 0) & target.valid[safe], target.mean[:, safe], target.cov[:, safe]


def align_d2d(
    grid_cfg: ops.GridConfig,
    target,
    src_means: torch.Tensor,   # (3, C) source voxel means (sensor frame)
    src_covs: torch.Tensor,    # (6, C)
    src_valid: torch.Tensor,   # (C,)
    init_pose: Optional[se3.Pose] = None,
    cfg: NDTConfig = NDTConfig(),
) -> NDTResult:
    """Distribution-to-distribution NDT (NDTCuda D2D mode,
    fast_gicp/.../ndt_compute_derivatives.cu): source voxel Gaussians matched
    against target voxel Gaussians with combined covariance
    M = (C_tgt + R C_src R^T)^-1 under the same exponential score. The
    correspondences are searched at every iteration, as in the JAX package."""
    if init_pose is None:
        init_pose = se3.identity(src_means.dtype, device=src_means.device)
    d1, d2 = cfg.gauss_coeffs()
    scfg = cfg.solver

    def linearize(pose):
        pw = pose.apply(src_means)
        t6 = _src_cov_world(src_covs, pose.R)
        ok, mean, cov = _stencil_stats(cfg, grid_cfg, target, ops.point_to_voxel(pw, cfg.resolution))
        ok = ok & src_valid[None, :]
        m = _sym_inv3(*(cov[c] + t6[c] for c in range(6)))
        p = pw[:, None, :]
        q = p - mean
        Mq = torch.einsum("abpn,bpn->apn", _sym3(torch.stack(m)), q)
        ex = torch.exp(-0.5 * d2 * torch.clamp(torch.sum(q * Mq, dim=0), 0.0, 50.0))
        w = torch.where(ok, -d1 * d2 * ex, 0.0)
        err = torch.sum(torch.where(ok, d1 * ex, 0.0))
        H, b, _ = _weighted_terms(w, p, q, m)
        return H, b, err

    pose = init_pose
    done, iters = solver._start(init_pose)
    H = src_means.new_zeros((6, 6))
    err = src_means.new_zeros(())
    for _ in range(scfg.max_iterations):
        H, b, err = linearize(pose)
        pose, done, iters, _ = solver._gn_update(H, b, pose, done, iters, scfg, lam=1e-6 * H.diagonal().abs().amax())
    return NDTResult(pose, done, iters, -err, H, small_eigh.eigvalsh(H)[-1])


def _search(cfg: NDTConfig, grid_cfg, target, source, source_mask, pose):
    with Timer.span("ndt.search"):
        pw = pose.apply(source)
        if isinstance(target, gg.BakedGaussianMap):
            return _correspond_baked(cfg, grid_cfg, target, pw, source_mask)
        return _correspond(cfg, grid_cfg, target, pw, source_mask)


def _linearize(d1, d2, cache, pose, source):
    with Timer.span("ndt.linearize"):
        return _linearize_cached(d1, d2, *cache, pose.apply(source), source)


def _chunks(cfg: NDTConfig):
    """The updates between searches: `warmup_searches` rounds of one, then
    rounds of `search_every` up to the solver's `max_iterations`."""
    warmup = min(cfg.warmup_searches, cfg.solver.max_iterations)
    rest = cfg.solver.max_iterations - warmup
    return [1] * warmup + [cfg.search_every] * (-(-rest // cfg.search_every) if rest > 0 else 0)


def _schedule(cfg: NDTConfig, grid_cfg, target, source, source_mask, init_pose):
    """`align`'s Gauss-Newton schedule: every search and masked update of
    `_chunks`, a fixed sequence of launches with no host read. Returns
    (pose, done, iters, the last search's correspondences or None)."""
    d1, d2 = cfg.gauss_coeffs()
    scfg = cfg.solver
    pose = init_pose
    done, iters = solver._start(init_pose)
    cache = None
    for chunk in _chunks(cfg):
        cache = _search(cfg, grid_cfg, target, source, source_mask, pose)
        done = done | (iters >= scfg.max_iterations)
        for _ in range(chunk):
            H, b, _ = _linearize(d1, d2, cache, pose, source)
            with Timer.span("ndt.solve"):
                pose, done, iters, _ = solver._gn_update(H, b, pose, done, iters, scfg,
                                                         lam=1e-6 * H.diagonal().abs().amax())
    return pose, done, iters, cache


# CUDA graphs of `_schedule`, one a key, the least recently used dropped past this many
GRAPH_CACHE = 4
_graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()


def _engages(source: torch.Tensor) -> bool:
    return source.is_cuda


def _graph_key(cfg: NDTConfig, grid_cfg, target, source, source_mask, init_pose) -> tuple:
    """What a captured schedule depends on: the device, the inputs' layouts
    and which were given, the configs, and the address and layout of every
    target tensor (the graph reads the map by address, so an update of the
    map in place is seen and a new map is a new key)."""
    def layout(t):
        return None if t is None else (tuple(t.shape), t.stride(), t.dtype)

    return (source.device, torch.cuda.current_device() if source.is_cuda else None, cfg, grid_cfg, type(target),
            layout(source), layout(source_mask), init_pose is None or (layout(init_pose.R), layout(init_pose.t)),
            tuple((t.data_ptr(), layout(t)) for t in target if torch.is_tensor(t)))


def _sighting(key: tuple, targets) -> "Optional[_Graph]":
    """The key's entry from its second sighting on (the entry holds the
    target tensors once it has a graph); None on a first sighting, which is
    recorded with weak references: a map freed since is seen anew."""
    entry = _graphs.get(key)
    if entry is None or not entry.alive():
        entry = None
        _graphs[key] = _Graph(targets)
    _graphs.move_to_end(key)
    while len(_graphs) > GRAPH_CACHE:
        _graphs.popitem(last=False)
    return entry


def _capture(fn):
    """fn() captured in a CUDA graph on a side stream, after one eager run
    there (per-stream library state, such as cuBLAS's workspace, stays out of
    the graph's private memory pool). Returns (graph, fn's outputs, which
    each replay overwrites). A refused operation raises."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    return graph, out


class _Graph:
    """A key's schedule as a graph: static inputs, captured on the second
    sighting, replayed on every later one (one caller at a time)."""

    def __init__(self, targets):
        self.targets = [weakref.ref(t) for t in targets]
        self.graph = None

    def alive(self) -> bool:
        return self.graph is not None or all(r() is not None for r in self.targets)

    def run(self, cfg: NDTConfig, grid_cfg, target, source, source_mask, init_pose):
        """Copy the inputs in (or capture on them), replay: the static outputs."""
        if self.graph is None:
            self.source = source.clone()
            self.mask = (torch.ones(source.shape[1], dtype=torch.bool, device=source.device) if source_mask is None
                         else source_mask.clone())
            init = se3.identity(source.dtype, device=source.device) if init_pose is None else init_pose
            self.pose = se3.Pose(init.R.clone(), init.t.clone())
            self.graph, self.out = _capture(lambda: _schedule(cfg, grid_cfg, target, self.source, self.mask,
                                                              self.pose))
            self.targets = [t for t in target if torch.is_tensor(t)]
            Timer.count("ndt.graph_captures", 1)
        else:
            self.source.copy_(source)
            if source_mask is not None:
                self.mask.copy_(source_mask)
            if init_pose is not None:
                self.pose.R.copy_(init_pose.R)
                self.pose.t.copy_(init_pose.t)
        self.graph.replay()
        Timer.count("ndt.graph_replays", 1)
        return self.out


def align(
    grid_cfg: ops.GridConfig,
    target,
    source: torch.Tensor,
    source_mask: Optional[torch.Tensor] = None,
    init_pose: Optional[se3.Pose] = None,
    cfg: NDTConfig = NDTConfig(),
) -> NDTResult:
    """Align source (3, N) to the NDT target map (a GaussianVoxelMap with its
    grid config, or a BakedGaussianMap with its baked config).

    On CUDA tensors the schedule (`_schedule`) runs eagerly the first time a
    key (`_graph_key`) is seen, is captured as a CUDA graph the second time
    and replayed from then on; the last linearization and K6 stay eager. A
    replay returns copies of the pose, `done` and `iters`, so no result
    aliases the next replay's outputs."""
    entry = _sighting(_graph_key(cfg, grid_cfg, target, source, source_mask, init_pose),
                      [t for t in target if torch.is_tensor(t)]) if _engages(source) else None
    with Timer.span("ndt.align"):
        if entry is None:
            if source_mask is None:
                source_mask = torch.ones(source.shape[1], dtype=torch.bool, device=source.device)
            if init_pose is None:
                init_pose = se3.identity(source.dtype, device=source.device)
            pose, done, iters, cache = _schedule(cfg, grid_cfg, target, source, source_mask, init_pose)
        else:
            pose, done, iters, cache = entry.run(cfg, grid_cfg, target, source, source_mask, init_pose)
            source = entry.source
        # Gauss-Newton updates run, and (read only when the frames are) those before `done`
        Timer.count("ndt.iterations", sum(_chunks(cfg)))
        if cache is None:  # max_iterations = 0: no correspondences, zero terms
            S, N = _stencil_tensor(cfg.nearby, source.device).shape[1], source.shape[1]
            cache = (source.new_zeros((3, S, N)), source.new_zeros((6, S, N)),
                     torch.zeros((S, N), dtype=torch.bool, device=source.device))
        H, b, err = _linearize(*cfg.gauss_coeffs(), cache, pose, source)
        if entry is not None:
            pose, done, iters = se3.Pose(pose.R.clone(), pose.t.clone()), done.clone(), iters.clone()
        Timer.count_lazy("ndt.iterations_used", iters)
        with Timer.span("ndt.eig"):
            max_eigen = small_eigh.eigvalsh(H)[-1]
        return NDTResult(pose, done, iters, -err, H, max_eigen)
