"""Parity of the port's host-side readers and writers with the JAX
package's: `io.pcd`, `io.rosbag` (uncompressed and LZ4-chunked bags),
`io.lz4`, `io.converters`, `io.odom_feed` and `models.lio.preprocess`.
Files written by one package are read by the other with bit-equal arrays,
and both write the same bytes for the same input; `apply_masks` on torch
tensors gives the JAX package's masks."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu.io import converters as jconv, lz4 as jlz4, odom_feed as jodom, pcd as jpcd
from pointcloud_slam_tpu.io import rosbag as jbag
from pointcloud_slam_tpu.models.lio import preprocess as jpre
from pointcloud_slam_tpu_torch.io import converters as tconv, lz4 as tlz4, odom_feed as todom, pcd as tpcd
from pointcloud_slam_tpu_torch.io import rosbag as tbag
from pointcloud_slam_tpu_torch.models.lio import preprocess as tpre

PACKAGES = {"jax": (jpcd, jbag, jlz4), "torch": (tpcd, tbag, tlz4)}
DIRECTIONS = [("jax", "torch"), ("torch", "jax")]


def _assert_same(a, b):
    """Equal dicts / tuples / arrays, dtypes included."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _cloud(rng, n=300):
    return {
        "x": rng.normal(size=n).astype(np.float32),
        "y": rng.normal(size=n).astype(np.float32),
        "z": rng.normal(size=n).astype(np.float32),
        "intensity": rng.uniform(0, 255, n).astype(np.float32),
        "ring": rng.integers(0, 16, n).astype(np.uint16),
        "time": np.sort(rng.uniform(0, 0.1, n)).astype(np.float32),
    }


# ------------------------------------------------------------------ pcd

@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_pcd_round_trip(tmp_path, rng, writer, reader, binary):
    pts = rng.normal(size=(400, 3)).astype(np.float32)
    inten = rng.uniform(0, 255, 400).astype(np.float32)
    extra = {"ring": rng.integers(0, 16, 400).astype(np.float32), "time": rng.uniform(0, 0.1, 400)}
    paths = {}
    for name, (pcd, _, _) in PACKAGES.items():
        paths[name] = str(tmp_path / f"{name}.pcd")
        pcd.write_pcd(paths[name], pts, intensity=inten, binary=binary, extra_fields=extra)
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()
    path = paths[writer]
    rpcd = PACKAGES[reader][0]
    _assert_same(rpcd.read_pcd(path), PACKAGES[writer][0].read_pcd(path))
    _assert_same(rpcd.read_pcd_xyz(path), PACKAGES[writer][0].read_pcd_xyz(path))
    if binary:
        np.testing.assert_array_equal(rpcd.read_pcd_xyz(path), pts)


def test_arealist_tiles(tmp_path):
    path = str(tmp_path / "arealist.csv")
    with open(path, "w") as f:
        f.write("tile_0.pcd,0,0,0,50,50,10\ntile_1.pcd,50,0,0,100,50,10\nbad,1,2\n")
    a_j, a_t = jpcd.read_arealist(path), tpcd.read_arealist(path)
    _assert_same(a_j, a_t)
    for x, y, margin in ((25.0, 25.0, 0.0), (49.0, 25.0, 5.0), (200.0, 0.0, 10.0)):
        hits_j = [a["path"] for a in jpcd.tiles_for_position(a_j, x, y, margin=margin)]
        assert hits_j == [a["path"] for a in tpcd.tiles_for_position(a_t, x, y, margin=margin)]


# ------------------------------------------------------------------ lz4

@pytest.mark.parametrize("layer", ["block", "frame"])
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_lz4_round_trip(rng, layer, writer, reader):
    data = (bytes(rng.integers(0, 4, 5000).astype(np.uint8)) + b"abcabcabc" * 300
            + bytes(rng.integers(0, 256, 3000).astype(np.uint8)))
    comp = {name: getattr(m[2], f"{layer}_compress")(data) for name, m in PACKAGES.items()}
    assert comp["jax"] == comp["torch"]
    assert getattr(PACKAGES[reader][2], f"{layer}_decompress")(comp[writer]) == data
    assert jlz4.xxh32(data, seed=7) == tlz4.xxh32(data, seed=7)


# ------------------------------------------------------------------ rosbag

def _write_bag(bag_mod, path, rng, compression):
    """IMU, PointCloud2 and Livox CustomMsg messages on three topics."""
    with bag_mod.BagWriter(path, chunk_compression=compression, chunk_size=4096) as bw:
        for k in range(12):
            bw.write_imu("/imu/data", 1700000000.0 + 0.01 * k, rng.normal(0, 1, 3), rng.normal(0, 0.1, 3))
        bw.write_pointcloud2("/rslidar_points", 1700000000.02, _cloud(rng))
        pts = rng.uniform(-5, 5, (200, 3)).astype(np.float32)
        bw.write_livox("/livox/lidar", 1700000000.05, pts, (np.linspace(0, 0.1, 200) * 1e9).astype(np.uint32),
                       reflectivity=rng.integers(0, 255, 200).astype(np.uint8),
                       line=rng.integers(0, 6, 200).astype(np.uint8))


@pytest.mark.parametrize("compression", [None, "lz4"])
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_bag_round_trip(tmp_path, writer, reader, compression):
    paths = {}
    for name, (_, bag, _) in PACKAGES.items():
        paths[name] = str(tmp_path / f"{name}.bag")
        _write_bag(bag, paths[name], np.random.default_rng(3), compression)
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()
    got = list(PACKAGES[reader][1].read_bag(paths[writer]))
    want = list(PACKAGES[writer][1].read_bag(paths[writer]))
    assert len(got) == 14 and {m[1] for m in got} == {"sensor_msgs/Imu", "sensor_msgs/PointCloud2",
                                                       "livox_ros_driver/CustomMsg"}
    _assert_same(got, want)
    _assert_same(list(PACKAGES[reader][1].read_bag(paths[writer], topics=["/livox/lidar"])),
                 [m for m in want if m[0] == "/livox/lidar"])


def test_message_serializers_match(rng):
    cloud = _cloud(rng)
    assert jbag.serialize_imu(3.25, (1, 2, 3), (4, 5, 6)) == tbag.serialize_imu(3.25, (1, 2, 3), (4, 5, 6))
    raw = jbag.serialize_pointcloud2(3.25, cloud)
    assert raw == tbag.serialize_pointcloud2(3.25, cloud)
    _assert_same(tbag.parse_pointcloud2(raw), jbag.parse_pointcloud2(raw))
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    offs = np.arange(50, dtype=np.uint32) * 1000
    raw = jbag.serialize_livox(1.5, pts, offs)
    assert raw == tbag.serialize_livox(1.5, pts, offs)
    _assert_same(tbag.parse_livox(raw), jbag.parse_livox(raw))
    raw = jbag.serialize_imu(2.0, (0.5, 0, 9.8), (0, 0.1, 0))
    _assert_same(tbag.parse_imu(raw), jbag.parse_imu(raw))


# ------------------------------------------------------------------ converters

def _with_nans(c):
    c = dict(c)
    c["x"] = c["x"].copy()
    c["x"][[3, 17]] = np.nan
    return c


def _u8(c, k):
    return ((c["intensity"] + 37 * k) % 255).astype(np.uint8)


def _conv_cases(rng):
    c = _cloud(rng)
    cam = {k: rng.uniform(-3, 3, 120).astype(np.float32) for k in "xyz"}
    cam["z"] = np.abs(cam["z"]) + 0.5
    T = np.eye(4)
    T[3, :3] = [0.1, -0.2, 0.3]
    ts = {k: c[k] for k in "xyz"}
    return {
        "livox_custom_to_xyzirt": lambda m: m.livox_custom_to_xyzirt(
            c["x"], c["y"], c["z"], _u8(c, 0), _u8(c, 1) % 6, (c["time"] * 1e9).astype(np.uint32)),
        "rs_to_velodyne_16": lambda m: m.rs_to_velodyne(_with_nans(c), n_rings=16),
        "rs_to_velodyne_128": lambda m: m.rs_to_velodyne(dict(c, ring=(c["ring"] * 8).astype(np.uint16)),
                                                          n_rings=128),
        "hesai_to_velodyne": lambda m: m.hesai_to_velodyne(_with_nans(c)),
        "ouster64_to_xyzirt": lambda m: m.ouster64_to_xyzirt(dict(ts, t=(c["time"] * 1e9), ring=c["ring"])),
        "livox_pc2_to_xyzirt": lambda m: m.livox_pc2_to_xyzirt(dict(ts, timestamp=100.0 + c["time"])),
        "point_times_time": lambda m: m.point_times_from_cloud(c),
        "point_times_t": lambda m: m.point_times_from_cloud(dict(ts, t=c["time"] * 1e9)),
        "point_times_timestamp": lambda m: m.point_times_from_cloud(dict(ts, timestamp=50.0 + c["time"])),
        "point_times_curvature": lambda m: m.point_times_from_cloud(dict(ts, curvature=c["time"] * 1e3)),
        "point_times_ring": lambda m: m.point_times_from_cloud(dict(ts, ring=c["ring"])),
        "point_times_ramp": lambda m: m.point_times_from_cloud(ts, scan_duration=0.05),
        "depth_camera_to_velodyne": lambda m: m.depth_camera_to_velodyne(cam, T.reshape(-1), depth_filter=2.0,
                                                                          stamp=0.5),
        "fuse_lidar_cameras": lambda m: m.fuse_lidar_cameras(c, [cam, cam], [T, T], stamp=0.25),
        "merge_clouds": lambda m: m.merge_clouds([c, cam], extrinsics=[(np.eye(3), np.zeros(3)),
                                                                       (np.eye(3), np.ones(3))]),
    }


@pytest.mark.parametrize("case", sorted(_conv_cases(np.random.default_rng(0))))
def test_converters_match(case):
    fn = _conv_cases(np.random.default_rng(5))[case]
    _assert_same(fn(tconv), fn(jconv))


def test_approximate_time_sync_matches():
    feeds = [(0, 0.00), (1, 0.02), (0, 0.10), (1, 0.19), (1, 0.30), (0, 0.31), (0, 0.50), (1, 0.70)]
    outs = []
    for mod in (jconv, tconv):
        sync = mod.ApproximateTimeSync(2, slop=0.03, queue_size=3)
        outs.append([sync.add(s, t, (s, t)) for s, t in feeds])
    assert outs[0] == outs[1] and sum(o is not None for o in outs[0]) >= 2


# ------------------------------------------------------------------ odom_feed

def test_odom_feed_matches():
    rows = np.array([[1.0, 4.0, 5.0, 0.5, np.cos(np.pi / 4), 0.0, 0.0, np.sin(np.pi / 4)],
                     [0.0, 1.0, 2.0, 0.5, 1.0, 0.0, 0.0, 0.0]])
    for r in (rows, rows[:, :4]):                 # position-only rows get the identity attitude
        fj, ft = (m.UkfOdomFeed(r, lever_arm=(1.0, 0.0, 0.0)) for m in (jodom, todom))
        for stamp in (-0.5, 0.0, 0.5, 1.0, 1.5, 10.0):
            _assert_same(ft.initial_pose_at(stamp), fj.initial_pose_at(stamp))
    q = (np.cos(np.pi / 4), 0.0, 0.0, np.sin(np.pi / 4))
    for xyz, cov, quat in (((10.0, 20.0, 1.0), (0.001, 0.001), None), ((10.0, 20.0, 1.0), (0.003, 0.001), None),
                           ((0.0, 0.0, 1.0), (0.001, 0.001), None), ((10.0, 20.0, 1.0), (0.001, 0.002), q)):
        got = todom.gps_init_position(xyz, cov, quat=quat, lever_arm=(1.0, 0.0, 0.0))
        _assert_same(got, jodom.gps_init_position(xyz, cov, quat=quat, lever_arm=(1.0, 0.0, 0.0)))
    assert todom.GPS_COV_GATE == jodom.GPS_COV_GATE == 0.003


def test_odom_feed_from_csv(tmp_path):
    path = str(tmp_path / "ukf.csv")
    np.savetxt(path, np.array([[0.5, 1.0, 2.0, 0.0, 1.0, 0.0, 0.0, 0.0]]), delimiter=",")
    _assert_same(todom.UkfOdomFeed.from_csv(path).initial_pose_at(1.0),
                 jodom.UkfOdomFeed.from_csv(path).initial_pose_at(1.0))


# ------------------------------------------------------------------ preprocess

@pytest.mark.parametrize("filter_num", [1, 3])
def test_apply_masks_matches_jax(rng, filter_num):
    pts = rng.uniform(-200, 200, (3, 500)).astype(np.float32)
    pts[:, :40] *= 1e-3                        # inside the blind range
    mask = rng.uniform(size=500) < 0.8
    kw = dict(blind=0.5, point_filter_num=filter_num, max_range=150.0)
    want = np.asarray(jpre.apply_masks(jpre.PreprocessConfig(**kw), jnp.asarray(pts), jnp.asarray(mask)))
    got = tpre.apply_masks(tpre.PreprocessConfig(**kw), torch.from_numpy(pts), torch.from_numpy(mask))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_preprocess_host_helpers_match(rng):
    tags = rng.integers(0, 256, 1000).astype(np.uint8)
    np.testing.assert_array_equal(tpre.avia_tag_filter(tags), jpre.avia_tag_filter(tags))
    xyz = rng.normal(size=(600, 3)).astype(np.float32)
    rings = rng.integers(0, 16, 600)
    _assert_same(tpre.synthesize_velodyne_times(xyz, rings, 20.0), jpre.synthesize_velodyne_times(xyz, rings, 20.0))
