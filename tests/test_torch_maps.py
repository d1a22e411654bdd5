"""The port's map products (`pointcloud_slam_tpu_torch/maps/`) on the CPU:
the JAX package's map tests (tests/test_maps.py, tests/test_tiled_maps.py)
mirrored on the port, then each function beside the JAX one on the same
inputs — scans to 1e-6 m, log-odds to 1e-5 with edge cells counted, hit
volumes exactly, 3-D maps by voxel (never by slot), stitched tiles, `.bt`
files and the map states `convert.py` carries across."""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu.maps import occupancy as occ_j
from pointcloud_slam_tpu.maps import pcd2map as p2m_j
from pointcloud_slam_tpu.maps import tiled as tiled_j
from pointcloud_slam_tpu_torch import convert
from pointcloud_slam_tpu_torch.maps import occupancy as occ
from pointcloud_slam_tpu_torch.maps import octomap_io, pcd2map, tiled
from pointcloud_slam_tpu_torch.ops.downsample import recip32
from pointcloud_slam_tpu_torch.ops.voxel_grid import _fingerprint

torch.set_num_threads(2)
CFG = occ.OccupancyConfig(size=256, resolution=0.1, origin=-12.8, n_beams=360, max_range=10.0)
TILE_CFG = occ.OccupancyConfig(size=128, resolution=0.25, max_range=10.0, min_z=-1.0, max_z=2.0)
EDGE_SHARE = 1e-3   # cells whose trinary value may differ, as a share of the observed cells


def soa(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).T))


def ones(n):
    return torch.ones(n, dtype=torch.bool)


def square_room_cloud(half=5.0, n_per_wall=400, z=0.7, seed=0):
    rng = np.random.default_rng(seed)
    pts = []
    for axis, sign in [(0, 1), (0, -1), (1, 1), (1, -1)]:
        u = rng.uniform(-half, half, n_per_wall)
        p = np.zeros((n_per_wall, 3), np.float32)
        p[:, axis] = sign * half
        p[:, 1 - axis] = u
        p[:, 2] = z
        pts.append(p)
    return np.concatenate(pts)


def corridor_scan(pose_x, half_w=6.0, n=2880):
    """Scan of a fixed infinite corridor (walls at y = +-half_w) seen from (pose_x, 0)."""
    ang = np.linspace(-np.pi, np.pi, n, endpoint=False)
    c, s = np.cos(ang), np.sin(ang)
    with np.errstate(divide="ignore"):
        r = half_w / np.maximum(np.abs(s), 1e-9)
    keep = r < 1e6
    pts = np.stack([pose_x + r * c, np.sign(s) * half_w * np.ones(n), np.full(n, 0.5)], axis=0)
    return pts.astype(np.float32), keep


def wall_map(cfg, insert=3):
    m = tiled.create_3d(cfg, device="cpu")
    n = 256
    ys = np.linspace(-2, 2, n)
    pts = torch.from_numpy(np.stack([np.full(n, 5.0), ys, np.full(n, 0.5)], 0).astype(np.float32))
    for _ in range(insert):
        m = tiled.insert_cloud_3d(cfg, m, pts, ones(n), torch.zeros(3))
    return m


def random_cloud(n, seed, span=15.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-span, span, (3, n)).astype(np.float32)
    pts[2] = rng.uniform(-0.5, 2.0, n)
    return pts, rng.uniform(size=n) < 0.9


def by_voxel(fp, keys, lo):
    """{voxel key: log-odds} of a 3-D map's filled slots (numpy leaves)."""
    fp, keys, lo = (np.asarray(a) for a in (fp, keys, lo))
    sel = fp != 0
    return dict(zip(map(tuple, keys[:, sel].T.tolist()), lo[sel].tolist()))


def assert_same_voxels(mj, mt):
    a = by_voxel(mj.fp, mj.keys, mj.logodds)
    b = by_voxel(mt.fp, mt.keys, mt.logodds)
    assert a.keys() == b.keys() and len(a) > 0
    np.testing.assert_allclose([b[k] for k in a], [a[k] for k in a], atol=1e-5)


def assert_grids_agree(lo_j, lo_t, cfg):
    """Log-odds within 1e-5 but for edge cells, whose count is held to
    EDGE_SHARE of the observed cells; trinary grids likewise. Returns the
    number of edge cells."""
    lo_j, lo_t = np.asarray(lo_j), np.asarray(lo_t)
    edge = np.abs(lo_j - lo_t) > 1e-5
    observed = (lo_j != 0) | (lo_t != 0)
    assert observed.sum() > 100
    assert edge.sum() <= EDGE_SHARE * observed.sum(), (int(edge.sum()), int(observed.sum()))
    tri_j = np.asarray(occ_j.to_ros_grid(cfg, occ_j.OccupancyGrid(jnp.asarray(lo_j))))
    tri_t = occ.to_ros_grid(cfg, occ.OccupancyGrid(torch.from_numpy(lo_t))).numpy()
    assert ((tri_j != tri_t) & ~edge).sum() == 0
    return int(edge.sum())


# ---- the JAX package's map tests, on the port ----


class TestOccupancy:
    def _grid(self, n_scans=1):
        cloud = square_room_cloud()
        grid = occ.create(CFG, device="cpu")
        for _ in range(n_scans):
            grid = occ.insert_cloud(CFG, grid, soa(cloud), ones(len(cloud)), torch.zeros(2), torch.zeros(()))
        return grid

    def test_walls_occupied_interior_free(self):
        p = occ.to_probability(CFG, self._grid()).numpy()
        res, org = CFG.resolution, CFG.origin

        def cell_max(x, y):
            i, j = int((x - org) / res), int((y - org) / res)
            return p[i - 1 : i + 2, j - 1 : j + 2].max()

        def cell(x, y):
            return p[int((x - org) / res), int((y - org) / res)]

        assert cell_max(5.0, 0.0) > 0.6 and cell_max(0.0, 5.0) > 0.6
        assert cell(2.0, 0.0) < 0.4 and cell(0.0, 0.0) < 0.4

    def test_repeated_scans_harden(self):
        p = occ.to_probability(CFG, self._grid(4)).numpy()
        assert (p > 0.65).mean() > 0.001 and (p < 0.196).mean() > 0.05

    def test_ros_grid_trinary(self):
        g = occ.to_ros_grid(CFG, self._grid()).numpy()
        assert set(np.unique(g)).issubset({-1, 0, 100})
        assert (g == -1).any() and (g == 0).any() and (g == 100).any()

    def test_save_and_load_pgm(self, tmp_path):
        grid = self._grid()
        path = str(tmp_path / "map")
        occ.save_pgm(CFG, grid, path)
        with open(path + ".pgm", "rb") as f:
            assert f.readline().strip() == b"P5"
        back, meta = occ.load_pgm(path)
        np.testing.assert_array_equal(back, occ.to_ros_grid(CFG, grid).numpy())
        assert meta["resolution"] == CFG.resolution


class TestVolume:
    def test_insert_and_project(self):
        cfg = pcd2map.VolumeConfig(nx=64, ny=64, nz=16, resolution=0.2, origin=(-6.4, -6.4, -1.6))
        pts = np.array([[1.0, 1.0, 0.0]] * 3 + [[-2.0, 3.0, 0.5]] * 3, np.float32)
        vol = pcd2map.insert_volume(cfg, pcd2map.create_volume(cfg, device="cpu"), soa(pts), ones(6))
        proj = pcd2map.project_2d(cfg, vol, min_hits=2).numpy()

        def cell(v):
            # float32 arithmetic, as the port's (a product by the float32
            # reciprocal of the resolution): y = 3.0 lies on a cell bound,
            # 9.4 / 0.2 exactly, and lands in cell 47 as in jitted XLA (a
            # float32 division would give 46)
            return int(np.floor((np.float32(v) - np.float32(-6.4)) * np.float32(recip32(0.2))))

        assert proj[cell(1.0), cell(1.0)]
        assert proj[cell(-2.0), cell(3.0)]
        assert proj.sum() == 2

    def test_nav_cloud(self):
        pts = np.random.default_rng(0).uniform(-3, 3, (2000, 3)).astype(np.float32)
        out, mask = pcd2map.pcd_to_nav_cloud(soa(pts), ones(2000), leaf=0.5, z_min=0.0, z_max=1.0)
        out, mask = out.numpy(), mask.numpy()
        assert mask.sum() > 0
        assert (out[2, mask] >= 0).all() and (out[2, mask] <= 1.0).all()


class TestTiledOccupancy:
    def test_trajectory_leaves_initial_tile(self):
        m = tiled.TiledOccupancyMap(TILE_CFG, device="cpu")
        xs = np.arange(0.0, 80.0, 4.0)
        for x in xs:
            pts, keep = corridor_scan(x)
            m.insert_cloud(torch.from_numpy(pts), torch.from_numpy(keep), np.asarray([x, 0.0], np.float32), 0.0)
        assert len({k[0] for k in m.tiles}) >= 3
        lo, origin = m.stitch()
        hits = 0
        for x in xs[::4]:
            gi = int((x - origin[0]) / TILE_CFG.resolution)
            gj = int((6.0 - origin[1]) / TILE_CFG.resolution)
            hits += bool((lo[gi - 2 : gi + 3, gj - 2 : gj + 3] > 0).any())
        assert hits >= len(xs[::4]) - 1
        assert lo[int((40.0 - origin[0]) / TILE_CFG.resolution), int(-origin[1] / TILE_CFG.resolution)] < 0

    def test_save_stitched_pgm(self, tmp_path):
        m = tiled.TiledOccupancyMap(TILE_CFG, device="cpu")
        for x in [0.0, 30.0, 60.0]:
            pts, keep = corridor_scan(x)
            m.insert_cloud(torch.from_numpy(pts), torch.from_numpy(keep), np.asarray([x, 0.0], np.float32), 0.0)
        path = str(tmp_path / "bigmap")
        m.save_pgm(path)
        grid, _ = occ.load_pgm(path)
        assert (grid == 100).sum() > 100 and (grid == 0).sum() > 1000


class Test3DOccupancy:
    def test_insert_and_project(self):
        cfg = tiled.VoxelOccConfig(capacity=1 << 16, resolution=0.25, n_free_steps=16)
        vox = tiled.occupied_voxels(cfg, wall_map(cfg))
        assert len(vox) > 0 and np.all(np.abs(vox[:, 0] - 5.0) < 0.5)
        img = tiled.project_2d(cfg, wall_map(cfg), 0.0, 1.0, size=64, res2d=0.25, origin_xy=(-8.0, -8.0))
        assert (img == 100).sum() > 10

    def test_unbounded_extent(self):
        cfg = tiled.VoxelOccConfig(capacity=1 << 14, resolution=0.5, n_free_steps=8)
        far = torch.tensor([[5000.0], [5000.0], [3.0]])
        m = tiled.insert_cloud_3d(cfg, tiled.create_3d(cfg, device="cpu"), far, ones(1), (4990.0, 5000.0, 0.0))
        vox = tiled.occupied_voxels(cfg, m)
        assert len(vox) == 1
        np.testing.assert_allclose(vox[0, :2], [5000.25, 5000.25], atol=0.5)


class TestOctomapBt:
    def test_roundtrip(self, tmp_path):
        cfg = tiled.VoxelOccConfig(capacity=1 << 16, resolution=0.25, n_free_steps=16)
        m = wall_map(cfg)
        p = str(tmp_path / "map.bt")
        assert octomap_io.save_bt(p, cfg, convert.to_numpy(m)) > 1
        res, occ_pts, free_pts = octomap_io.load_bt(p)
        vox = tiled.occupied_voxels(cfg, m)
        assert res == cfg.resolution and len(occ_pts) == len(vox)
        as_set = (lambda q: set(map(tuple, np.round(q / res - 0.5).astype(int))))
        assert as_set(vox) == as_set(occ_pts)
        assert len(free_pts) > 0 and free_pts[:, 0].min() < 4.0
        assert open(p, "rb").read(80).split(b"\n")[0] == b"# Octomap OcTree binary file"

    def test_empty_map_writes_size_zero(self, tmp_path):
        cfg = tiled.VoxelOccConfig(capacity=1 << 10, resolution=0.1)
        p = str(tmp_path / "empty.bt")
        assert octomap_io.save_bt(p, cfg, convert.to_numpy(tiled.create_3d(cfg, device="cpu"))) == 0
        raw = open(p, "rb").read()
        assert b"size 0\n" in raw and raw.endswith(b"data\n")
        _, occ_pts, free_pts = octomap_io.load_bt(p)
        assert len(occ_pts) == 0 and len(free_pts) == 0

    def test_bt_bytes_match_jax(self, tmp_path):
        """The same map written by both packages' save_bt: identical files."""
        from pointcloud_slam_tpu.maps import octomap_io as oio_j

        cfg = tiled.VoxelOccConfig(capacity=1 << 16, resolution=0.25, n_free_steps=16)
        m = convert.to_numpy(wall_map(cfg))
        oio_j.save_bt(str(tmp_path / "j.bt"), tiled_j.VoxelOccConfig(capacity=1 << 16, resolution=0.25), m)
        octomap_io.save_bt(str(tmp_path / "t.bt"), cfg, m)
        assert open(tmp_path / "j.bt", "rb").read() == open(tmp_path / "t.bt", "rb").read()


# ---- each function beside the JAX one ----


def test_cloud_to_scan_matches_jax():
    cfg_j = occ_j.OccupancyConfig()
    pts, mask = random_cloud(30_000, 1)
    rj = np.asarray(occ_j.cloud_to_scan(cfg_j, jnp.asarray(pts), jnp.asarray(mask)))
    rt = occ.cloud_to_scan(occ.OccupancyConfig(), torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(np.isfinite(rt), np.isfinite(rj))
    assert np.isfinite(rj).sum() > 600
    np.testing.assert_allclose(rt[np.isfinite(rj)], rj[np.isfinite(rj)], atol=1e-6)


@pytest.mark.parametrize("yaw", [0.0, 0.7])
def test_insert_cloud_matches_jax(yaw):
    """Default 1,024^2 grid and 720 beams, three scans from three poses,
    through insert_cloud (which runs cloud_to_scan and insert_scan)."""
    cfg_j, cfg = occ_j.OccupancyConfig(), occ.OccupancyConfig()
    gj, gt = occ_j.create(cfg_j), occ.create(cfg, device="cpu")
    for k in range(3):
        pts, mask = random_cloud(20_000, 10 + k)
        xy = np.array([0.4 * k - 0.3, 0.25 * k + 0.1], np.float32)
        gj = occ_j.insert_cloud(cfg_j, gj, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(xy),
                                jnp.asarray(yaw, jnp.float32))
        gt = occ.insert_cloud(cfg, gt, torch.from_numpy(pts), torch.from_numpy(mask), xy, yaw)
    edge = assert_grids_agree(gj.logodds, gt.logodds.numpy(), cfg)
    print(f"insert_cloud yaw {yaw}: {edge} edge cells")


def test_insert_scan_matches_jax():
    """insert_scan alone, on a scan with no-return beams, with use_nan on and
    off, against a tile origin passed at run time."""
    rng = np.random.default_rng(4)
    ranges = rng.uniform(0.5, 25.0, 720).astype(np.float32)
    ranges[rng.uniform(size=720) < 0.2] = np.inf
    origin = np.array([-30.0, -40.0], np.float32)
    for use_nan in (False, True):
        cfg_j, cfg = occ_j.OccupancyConfig(use_nan=use_nan), occ.OccupancyConfig(use_nan=use_nan)
        gj = occ_j.insert_scan(cfg_j, occ_j.create(cfg_j), jnp.asarray(ranges), jnp.asarray([1.5, -2.0]),
                               jnp.asarray(0.3, jnp.float32), origin=jnp.asarray(origin))
        gt = occ.insert_scan(cfg, occ.create(cfg, device="cpu"), torch.from_numpy(ranges), (1.5, -2.0), 0.3,
                             origin=origin)
        assert_grids_agree(gj.logodds, gt.logodds.numpy(), cfg)


def test_volume_matches_jax():
    cfg_j = p2m_j.VolumeConfig(nx=96, ny=80, nz=24)
    cfg = pcd2map.VolumeConfig(nx=96, ny=80, nz=24)
    pts, mask = random_cloud(20_000, 5, span=12.0)
    vj = p2m_j.insert_volume(cfg_j, p2m_j.create_volume(cfg_j), jnp.asarray(pts), jnp.asarray(mask))
    vt = pcd2map.insert_volume(cfg, pcd2map.create_volume(cfg, device="cpu"), torch.from_numpy(pts),
                               torch.from_numpy(mask))
    np.testing.assert_array_equal(vt.hits.numpy(), np.asarray(vj.hits).astype(np.int32))
    for h in (1, 2):
        np.testing.assert_array_equal(pcd2map.project_2d(cfg, vt, h).numpy(),
                                      np.asarray(p2m_j.project_2d(cfg_j, vj, h)))


@pytest.mark.parametrize("n_points", [40, 1500])
def test_insert_cloud_3d_matches_jax_by_voxel(n_points):
    """The key -> log-odds map equal to JAX's: with 40 points a cloud the
    2^20 slots see no collision; with 1,500 (~50k voxels) hundreds of slots
    are fought over within a batch, and the CPU's winner, the last valid
    writer, is XLA's on the CPU too."""
    cfg_j = tiled_j.VoxelOccConfig(capacity=1 << 20, n_free_steps=16)
    cfg = tiled.VoxelOccConfig(capacity=1 << 20, n_free_steps=16)
    mj, mt = tiled_j.create_3d(cfg_j), tiled.create_3d(cfg, device="cpu")
    collisions = torch.zeros((), dtype=torch.int64)
    for k in range(2):
        pts, mask = random_cloud(n_points, 20 + k, span=6.0)
        o = np.array([0.3 * k, -0.2, 0.9], np.float32)
        mj = tiled_j.insert_cloud_3d(cfg_j, mj, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(o))
        mt = tiled.insert_cloud_3d(cfg, mt, torch.from_numpy(pts), torch.from_numpy(mask), o, collisions)
    assert (int(collisions) == 0) == (n_points == 40), int(collisions)
    assert_same_voxels(mj, mt)


def test_forced_collisions_keep_slots_consistent():
    """A 64-slot map under ~1,000 voxels: every filled slot's fingerprint is
    its own coordinates', and the collision count is positive."""
    cfg = tiled.VoxelOccConfig(capacity=1 << 6, resolution=0.25, n_free_steps=8)
    m = tiled.create_3d(cfg, device="cpu")
    collisions = torch.zeros((), dtype=torch.int64)
    for k in range(3):
        pts, mask = random_cloud(400, 30 + k, span=5.0)
        m = tiled.insert_cloud_3d(cfg, m, torch.from_numpy(pts), torch.from_numpy(mask), (0.0, 0.0, 1.0), collisions)
    filled = m.fp != 0
    assert int(filled.sum()) > 32 and int(collisions) > 0
    fp = _fingerprint(m.keys[0], m.keys[1], m.keys[2])
    assert bool((fp[filled] == m.fp[filled]).all())


def test_tiled_map_matches_jax():
    """A trajectory that leaves its first tile: stitched grid and origin."""
    cfg_j = occ_j.OccupancyConfig(size=128, resolution=0.25, max_range=10.0, min_z=-1.0, max_z=2.0)
    mj, mt = tiled_j.TiledOccupancyMap(cfg_j), tiled.TiledOccupancyMap(TILE_CFG, device="cpu")
    for x in np.arange(0.0, 48.0, 6.0):
        pts, keep = corridor_scan(x)
        xy = np.asarray([x, 0.3], np.float32)
        mj.insert_cloud(jnp.asarray(pts), jnp.asarray(keep), xy, 0.2)
        mt.insert_cloud(torch.from_numpy(pts), torch.from_numpy(keep), xy, 0.2)
    assert sorted(mj.tiles) == sorted(mt.tiles) and len({k[0] for k in mt.tiles}) >= 2
    (lo_j, org_j), (lo_t, org_t) = mj.stitch(), mt.stitch()
    np.testing.assert_array_equal(org_t, org_j)
    assert lo_t.shape == lo_j.shape
    assert_grids_agree(lo_j, lo_t, TILE_CFG)


def test_convert_carries_map_states():
    """Maps built in JAX, carried across, one more cloud inserted on both
    sides: the same maps (grid and volume exactly, 3-D by voxel); and back."""
    cfg_j = occ_j.OccupancyConfig(size=256, origin=-12.8, n_beams=360)
    cfg = occ.OccupancyConfig(size=256, origin=-12.8, n_beams=360)
    vcfg_j, vcfg = tiled_j.VoxelOccConfig(capacity=1 << 18, n_free_steps=8), tiled.VoxelOccConfig(capacity=1 << 18,
                                                                                                  n_free_steps=8)
    bcfg_j, bcfg = p2m_j.VolumeConfig(nx=64, ny=64, nz=16), pcd2map.VolumeConfig(nx=64, ny=64, nz=16)
    (p0, m0), (p1, m1) = random_cloud(4000, 40, span=8.0), random_cloud(4000, 41, span=8.0)
    j0, j1 = (jnp.asarray(p0), jnp.asarray(m0)), (jnp.asarray(p1), jnp.asarray(m1))
    t1 = (torch.from_numpy(p1), torch.from_numpy(m1))
    o = np.array([0.5, 0.5, 1.0], np.float32)

    gj = occ_j.insert_cloud(cfg_j, occ_j.create(cfg_j), *j0, jnp.zeros(2), jnp.zeros(()))
    gt = convert.occupancy_grid_from_numpy(occ_j.OccupancyGrid(np.asarray(gj.logodds)), device="cpu")
    gj = occ_j.insert_cloud(cfg_j, gj, *j1, jnp.asarray(o[:2]), jnp.zeros(()))
    gt = occ.insert_cloud(cfg, gt, *t1, o[:2], 0.0)
    assert_grids_agree(gj.logodds, gt.logodds.numpy(), cfg)
    np.testing.assert_array_equal(convert.to_numpy(gt).logodds, gt.logodds.numpy())

    vj = tiled_j.insert_cloud_3d(vcfg_j, tiled_j.create_3d(vcfg_j), *j0, jnp.asarray(o))
    vt = convert.voxel_occ3d_from_numpy(tiled_j.VoxelOccupancy3D(*(np.asarray(a) for a in vj)), device="cpu")
    assert vt.fp.dtype == torch.int64
    vj = tiled_j.insert_cloud_3d(vcfg_j, vj, *j1, jnp.asarray(o))
    vt = tiled.insert_cloud_3d(vcfg, vt, *t1, o)
    assert_same_voxels(vj, vt)
    back = convert.to_numpy(vt)
    assert back.fp.dtype == np.uint32 and back.keys.dtype == np.int32
    assert_same_voxels(vj, back)

    bj = p2m_j.insert_volume(bcfg_j, p2m_j.create_volume(bcfg_j), *j0)
    bt = convert.occupancy_volume_from_numpy(p2m_j.OccupancyVolume(np.asarray(bj.hits)), device="cpu")
    bj = p2m_j.insert_volume(bcfg_j, bj, *j1)
    bt = pcd2map.insert_volume(bcfg, bt, *t1)
    back = convert.to_numpy(bt)
    assert back.hits.dtype == np.uint32
    np.testing.assert_array_equal(back.hits, np.asarray(bj.hits))


def test_octomap_io_is_the_jax_module():
    """The port's copy keeps the JAX module's functions, line for line but
    for its docstring."""
    import inspect

    from pointcloud_slam_tpu.maps import octomap_io as oio_j

    for name in ("_build_tree", "_write_node", "save_bt", "_parse_bt", "iter_bt_leaves", "load_bt"):
        assert inspect.getsource(getattr(octomap_io, name)) == inspect.getsource(getattr(oio_j, name)), name
    assert os.path.basename(octomap_io.__file__) == "octomap_io.py"
