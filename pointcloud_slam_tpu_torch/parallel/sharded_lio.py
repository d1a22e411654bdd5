"""Point-axis-sharded LIO iterated-ESKF update over a device mesh (port of
`pointcloud_slam_tpu/parallel/sharded_lio.py`).

The odometry front end's per-point work (the k-NN search, plane fit and
Jacobian rows of laser_mapping.cc:592-701) runs on each rank's shard of the
downsampled scan; the 12x12 HTH and 12 HTh sums are all-reduced over the
axis inside every iteration (`eskf.update_iterated`'s `reduce` hook). The
23-dim state algebra and the voxel-hash map are replicated. The port probes
the hash directly: JAX's `knn_table` is not ported.
"""

from __future__ import annotations

import torch

from ..models.lio import eskf
from ..models.lio import pipeline as lio_pipeline
from . import mesh as mesh_mod


def sharded_lio_update(mesh, cfg, grid, x0, P0, pts_body: torch.Tensor, mask: torch.Tensor, axis: str = "sp"):
    """Iterated ESKF update with the scan's point axis sharded on `axis`.

    pts_body (3, N) / mask (N,): the same on every rank, N divisible by the
    axis size; grid, x0 and P0 replicated. Returns (x, P, iterations,
    converged), the same on every rank."""
    pts = mesh_mod.shard(pts_body, mesh, axis, 1)
    m = mesh_mod.shard(mask, mesh, axis, 0)
    body_norm = torch.sqrt(torch.sum(pts * pts, dim=0))
    obs = lio_pipeline._obs_model(cfg, grid, pts, body_norm, m)
    upd = eskf.update_iterated(x0, P0, obs, cfg.laser_point_cov, cfg.max_iterations, cfg.epsi,
                               reduce=mesh_mod.psum(mesh, axis))
    return upd.x, upd.P, upd.iterations, upd.converged
