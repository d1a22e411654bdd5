"""The port's native loader (`pointcloud_slam_tpu_torch.native`): where and
how it builds, the C++ oracle against the port's plane fit, eigenvalues,
voxel-grid k-NN and point-to-plane ICP (at tests/test_native.py's
tolerances), and the ingest shim, live driver and bag reader beside the JAX
package's loader on the same inputs."""

import os

import numpy as np
import pytest
import torch

from pointcloud_slam_tpu import native as jnative
from pointcloud_slam_tpu.io import rosbag as jbag
from pointcloud_slam_tpu_torch import native, ops, register
from pointcloud_slam_tpu_torch.geom import fit, so3
from pointcloud_slam_tpu_torch.io import synthetic

torch.set_num_threads(2)


def _soa(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32).T))


def test_library_lives_under_build_torch_native():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and native.BUILD_DIR.parts[-2:] == ("build", "torch_native")
    assert os.path.realpath(native.lib()._name) == os.path.realpath(path)
    assert "native/build" not in str(path)


def test_build_is_atomic_and_named_by_digest(tmp_path, monkeypatch):
    """A build writes one library named by the digest of its sources and
    flags, leaves no temporary file, and is not rebuilt while they hold;
    another flag is another library."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "torch_native")
    monkeypatch.setattr(native, "SOURCES", ("oracle.cpp",))
    first = native._build()
    assert first.parent == tmp_path / "torch_native" and first.name.startswith("libpcs_native_")
    assert [p.name for p in first.parent.iterdir()] == [first.name]
    mtime = first.stat().st_mtime_ns
    assert native._build() == first and first.stat().st_mtime_ns == mtime
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-DPCS_UNUSED=1"])
    assert native.library_path() != first


@pytest.mark.parametrize("seed", range(8))
def test_plane_fit_matches_oracle(seed):
    r = np.random.default_rng(seed)
    pts = r.normal(size=(5, 3))
    pts[:, 2] = pts[:, :2] @ [0.1, -0.2] + 1.5 + r.normal(scale=0.01, size=5)
    coef_o, ok_o = native.esti_plane(pts, threshold=0.1)
    coef_t, ok_t = fit.plane_fit(torch.from_numpy(pts.T[:, :, None].astype(np.float32)),
                                 torch.ones((5, 1), dtype=torch.bool), 0.1, 3)
    assert bool(ok_t[0]) == ok_o
    if ok_o:
        ct = coef_t[:, 0].numpy()
        np.testing.assert_allclose(ct, np.sign(ct[:3] @ coef_o[:3]) * coef_o, atol=5e-4)


def test_eigh3_matches_oracle(rng):
    A = rng.normal(size=(16, 3, 3))
    A = A + A.transpose(0, 2, 1)
    a6 = np.stack([A[:, 0, 0], A[:, 0, 1], A[:, 0, 2], A[:, 1, 1], A[:, 1, 2], A[:, 2, 2]], 1)
    vals, _ = fit.eigh3x3_soa(*torch.from_numpy(a6.T.astype(np.float32)))
    for i in range(len(A)):
        want = native.eigh3(a6[i])
        np.testing.assert_allclose(want, np.linalg.eigvalsh(A[i]), atol=1e-9)
        np.testing.assert_allclose(vals[:, i].numpy(), want, atol=1e-4 * max(1.0, np.abs(want).max()))


def test_knn_matches_oracle(rng):
    """tests/test_voxel_grid.py / test_native.py's fixture: the 27-voxel
    stencil at 1.5 m covers the 1.5 m range, so the voxel-grid answer is
    the exact one."""
    db = rng.uniform(-3, 3, size=(400, 3)).astype(np.float32)
    q = rng.uniform(-2, 2, size=(50, 3)).astype(np.float32)
    cfg = ops.GridConfig(capacity=1 << 12, pts_per_voxel=32, resolution=1.5, nearby=27)
    grid = ops.insert(cfg, ops.create(cfg, device="cpu"), _soa(db), torch.ones(len(db), dtype=torch.bool))
    nbrs, d2_t, cnt, _ = ops.knn(cfg, grid, _soa(q), k=5, max_range=1.5)
    idx_o, d2_o = native.knn(db, q, 5, max_range=1.5)
    d2_t = np.sort(d2_t.numpy().T, axis=1)
    for i in range(len(q)):
        want = d2_o[i][d2_o[i] < 1e30]
        got = d2_t[i][: int(cnt[i])]
        assert len(got) == len(want)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        # the neighbours are the oracle's points
        np.testing.assert_allclose(np.sort(nbrs[:, : len(want), i].numpy().T, axis=0),
                                   np.sort(db[idx_o[i, : len(want)]], axis=0), atol=1e-6)


def test_icp_matches_oracle():
    world = synthetic.make_room_cloud(1500, seed=3)
    R, t = synthetic.random_pose(seed=4, rot_scale=0.03, trans_scale=0.15)
    src = ((world - t) @ R).astype(np.float32)
    R_o, t_o, ok = native.icp_point_to_plane(world, src, iters=30, max_corr=5.0)
    assert ok and np.linalg.norm(t_o - t) < 0.05
    grid_cfg = ops.GridConfig(capacity=1 << 14, pts_per_voxel=16, resolution=0.5, nearby=7)
    _, grid = register.build_target_map(_soa(world), grid_cfg=grid_cfg)
    res = register.point_to_plane_icp(grid_cfg, grid, _soa(src))
    np.testing.assert_allclose(res.pose.t.numpy(), t_o, atol=0.03)
    rot_err = np.degrees(float(so3.log(torch.from_numpy(R_o.T.astype(np.float32)) @ res.pose.R).norm()))
    assert rot_err < 0.5


def test_ingest_shim_matches_jax():
    rng = np.random.default_rng(5)
    t_imu = np.arange(0.0, 0.3, 0.01)
    acc = rng.normal(0, 1, (len(t_imu), 3)).astype(np.float32)
    gyro = rng.normal(0, 0.1, (len(t_imu), 3)).astype(np.float32)
    shims = [m.IngestShim(n_points=128, n_imu=16) for m in (jnative, native)]
    for s in shims:
        s.push_imu(t_imu, acc, gyro)
    assert shims[0].pending_imu == shims[1].pending_imu
    xyz = rng.uniform(-5, 5, (100, 3)).astype(np.float32)
    for t0, t1, blind, fnum in ((0.1, 0.2, 0.5, 1), (0.2, 0.28, 0.1, 3), (0.25, 0.4, 0.1, 1)):
        tp = np.linspace(t0, t1, 100)
        fj, ft = (s.make_frame(xyz, tp, t0, t1, blind=blind, filter_num=fnum) for s in shims)
        if fj is None:
            assert ft is None    # IMU does not cover the scan yet
            continue
        assert sorted(fj) == sorted(ft) and fj["n_valid"] == ft["n_valid"] > 0
        for key in fj:
            np.testing.assert_array_equal(ft[key], fj[key], err_msg=key)


def test_live_driver_matches_ingest():
    """The threaded live replay delivers the frames the offline ingest shim
    assembles (tests/test_native.py's check, on the port's loader)."""
    rng = np.random.default_rng(5)
    scans = []
    for f in range(4):
        t0 = 0.1 * f
        scans.append((rng.uniform(-5, 5, (100, 3)).astype(np.float32),
                      np.linspace(t0, t0 + 0.1, 100, endpoint=False), t0, t0 + 0.1))
    t_imu = np.arange(0.0, 0.45, 0.01)
    acc = rng.normal(0, 1, (len(t_imu), 3)).astype(np.float32)
    gyro = rng.normal(0, 0.1, (len(t_imu), 3)).astype(np.float32)
    ref = native.IngestShim(n_points=128, n_imu=16)
    ref.push_imu(t_imu, acc, gyro)
    drv = native.LiveDriverShim(n_points=128, n_imu=16, time_scale=0.05, blind=0.5)
    for x, tp, t0, t1 in scans:
        drv.load_scan(x, tp, t0, t1)
    drv.load_imu(t_imu, acc, gyro)
    drv.run()
    for x, tp, t0, t1 in scans:
        want = ref.make_frame(x, tp, t0, t1, blind=0.5)
        got = drv.pop_frame(timeout_ms=3000)
        assert got not in (None, False)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert drv.pop_frame(timeout_ms=3000) is False


@pytest.mark.parametrize("compression", [None, "lz4"])
def test_native_bag_reader_matches_jax(tmp_path, compression):
    rng = np.random.default_rng(7)
    path = str(tmp_path / "a.bag")
    with jbag.BagWriter(path, chunk_compression=compression, chunk_size=2048) as bw:
        for k in range(20):
            bw.write_imu("/imu/data", 1700000000.0 + 0.01 * k, rng.normal(0, 1, 3), rng.normal(0, 0.1, 3))
        bw.write_livox("/livox/lidar", 1700000000.0, rng.uniform(-5, 5, (300, 3)).astype(np.float32),
                       (np.linspace(0, 0.1, 300) * 1e9).astype(np.uint32), line=np.zeros(300, np.uint8))
        n = 200
        bw.write_pointcloud2("/points", 1700000000.1, {
            "x": rng.normal(size=n).astype(np.float32), "y": rng.normal(size=n).astype(np.float32),
            "z": rng.normal(size=n).astype(np.float32), "intensity": rng.uniform(0, 255, n).astype(np.float32),
            "ring": rng.integers(0, 16, n).astype(np.uint16), "time": np.linspace(0, 0.1, n).astype(np.float32)})
    for topics in (("", ""), ("/points", "/imu/data")):
        with jnative.NativeBagReader(path, *topics) as bj, native.NativeBagReader(path, *topics) as bt:
            assert len(bj) == len(bt)
            got, want = [], []
            for out, reader in ((want, bj), (got, bt)):
                for kind, payload in reader:
                    out.append((kind, payload, reader.cloud_time_source if kind == "cloud" else None))
        assert len(got) == len(want) and sum(k == "cloud" for k, _, _ in got) == (2 if not topics[0] else 1)
        for (kt, pt, st), (kj, pj, sj) in zip(got, want):
            assert kt == kj and st == sj
            for a, b in zip(pt, pj):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_native_bag_reader_refuses_bz2(tmp_path):
    path = str(tmp_path / "b.bag")
    with jbag.BagWriter(path, chunk_compression="bz2") as bw:
        bw.write_imu("/imu/data", 1.0, (0, 0, 9.8), (0, 0, 0))
    with pytest.raises(ValueError):
        native.NativeBagReader(path)
