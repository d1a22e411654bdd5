"""The port's recorded-data apps on the CPU: `tools/make_dataset_torch.py`
writes the JAX tool's files byte for byte; the mapping app's directory,
native-bag and Python-bag replays build the same frames as each other and
as the JAX app's on the same files; the mapping, SLAM and localization
apps run end to end on that dataset, each mapping replay tracks the
ground truth of a denser one; `run_localization_torch.py
--synthetic 3` runs in each mode; and the localization front end's
fixed-size selection is pinned against the JAX app's own `fixed`."""

import ast
import filecmp
import importlib.util
import os
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from pointcloud_slam_tpu_torch.io import pcd
from pointcloud_slam_tpu_torch.models.liosam import features

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A 6-frame LIO dataset directory and its bag, written by the port's
    tool, and the same written by the JAX package's."""
    root = tmp_path_factory.mktemp("seq")
    for rel, name in (("tools/make_dataset_torch.py", "t"), ("tools/make_dataset.py", "j")):
        tool = _load(rel, f"make_dataset_{name}")
        tool.gen_lio(types.SimpleNamespace(out=str(root / name), frames=6, points=500, seed=3, bag=True))
    return root


@pytest.fixture(scope="module")
def lio_dataset(tmp_path_factory):
    """A 10-frame LIO dataset of 10,000 points a frame and its bag: dense
    enough for the LIO to track (chip_smoke.py phase 11 replays 20 frames of
    30,000 points of the same seed)."""
    root = tmp_path_factory.mktemp("lio_seq")
    tool = _load("tools/make_dataset_torch.py", "make_dataset_t")
    tool.gen_lio(types.SimpleNamespace(out=str(root), frames=10, points=10_000, seed=0, bag=True))
    return root


def _replay_args(dataset, **kw):
    return types.SimpleNamespace(data_dir=str(dataset / "t"), bag_file=str(dataset / "t" / "data.bag"),
                                 lidar_topic="", imu_topic="", n_points=600, n_imu=32, **kw)


def test_make_dataset_matches_jax_tool(dataset):
    cmp = filecmp.dircmp(dataset / "t", dataset / "j")
    assert sorted(cmp.common) == sorted(os.listdir(dataset / "j")) and not cmp.left_only
    assert "data.bag" in cmp.common and len([f for f in cmp.common if f.startswith("frame_")]) == 6
    _, mismatch, errors = filecmp.cmpfiles(dataset / "t", dataset / "j", cmp.common, shallow=False)
    assert mismatch == [] and errors == []


@pytest.mark.parametrize("bag_reader", ["native", "python"])
def test_bag_and_directory_replays_match(dataset, bag_reader):
    """Both bag readers give the directory replay's frames (bag offsets are
    whole nanoseconds, hence 1e-6 s), and each replay gives the JAX app's
    frames on the same files exactly."""
    app_t = _load("apps/run_mapping_offline_torch.py", "rmo_torch")
    app_j = _load("apps/run_mapping_offline.py", "rmo_jax")
    args = _replay_args(dataset, bag_reader=bag_reader)
    dir_t = list(app_t.frames_from_dir(args, device="cpu"))
    bag_t = list(app_t.frames_from_bag(args, device="cpu"))
    assert len(dir_t) == len(bag_t) == 6
    for (fd, td), (fb, tb) in zip(dir_t, bag_t):
        assert abs(td - tb) < 1e-6
        for name in fd._fields:
            a, b = getattr(fd, name).numpy(), getattr(fb, name).numpy()
            if a.dtype == bool:
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                np.testing.assert_allclose(a, b, atol=1e-5 if name == "pts" else 1e-6, err_msg=name)
    for ours, theirs in ((dir_t, app_j.frames_from_dir(args)), (bag_t, app_j.frames_from_bag(args))):
        for (ft, tt), (fj, tj) in zip(ours, theirs):
            assert tt == tj
            for name in ft._fields:
                np.testing.assert_array_equal(getattr(ft, name).numpy(), np.asarray(getattr(fj, name)), err_msg=name)


def test_recorded_replays_end_to_end(dataset, tmp_path, capsys):
    """Mapping from the bag (writing the map PCD), SLAM from the bag with
    keyframe artifacts, and localization on the dataset against that map."""
    mapping = _load("apps/run_mapping_offline_torch.py", "rmo_torch")
    slam = _load("apps/run_slam_offline_torch.py", "rso_torch")
    loc = _load("apps/run_localization_torch.py", "rl_torch")
    seq = str(dataset / "t")
    traj, map_file = str(tmp_path / "traj.txt"), str(tmp_path / "map.pcd")
    mapping.main(["--bag_file", os.path.join(seq, "data.bag"), "--bag_reader", "native", "--n_points", "600",
                  "--n_imu", "32", "--device", "cpu", "--traj_log_file", traj, "--map_file", map_file])
    rows = np.loadtxt(traj)
    assert rows.shape == (6, 8) and np.isfinite(rows).all()
    assert len(pcd.read_pcd_xyz(map_file)) > 500
    slam.main(["--bag_file", os.path.join(seq, "data.bag"), "--device", "cpu", "--out_dir", str(tmp_path / "slam"),
               "--save_artifacts"])
    rows = np.loadtxt(tmp_path / "slam" / "traj_tum.txt")
    assert rows.shape == (6, 8) and np.isfinite(rows).all()
    assert os.path.exists(tmp_path / "slam" / "Scans" / "000000.pcd")
    assert os.path.exists(tmp_path / "slam" / "SCDs" / "000000.scd")
    loc.main(["--map_pcd", map_file, "--data_dir", seq, "--n_points", "600", "--device", "cpu",
              "--out_dir", str(tmp_path / "loc")])
    status = np.loadtxt(tmp_path / "loc" / "status.csv", delimiter=",", skiprows=1)
    assert status.shape == (6, 5) and np.isfinite(status).all()
    assert "frames: 6" in capsys.readouterr().out


@pytest.mark.parametrize("source", ["dir", "native", "python"])
def test_replays_track_ground_truth(lio_dataset, tmp_path, source):
    """Each of the mapping app's three replays keeps its LIO trajectory
    within 0.05 m of the dataset's ground truth at every frame (as
    chip_smoke.py phase 11 holds it on the card). The replays are not held to
    each other: their point times differ by up to one float32 ulp, which
    moves the trajectory by millimetres (ROADMAP.md §3)."""
    mapping = _load("apps/run_mapping_offline_torch.py", "rmo_torch")
    seq = str(lio_dataset)
    src = (["--data_dir", seq] if source == "dir"
           else ["--bag_file", os.path.join(seq, "data.bag"), "--bag_reader", source])
    traj = str(tmp_path / "traj.txt")
    mapping.main([*src, "--n_points", "4096", "--n_imu", "32", "--device", "cpu", "--traj_log_file", traj])
    rows, gt = np.loadtxt(traj), np.loadtxt(os.path.join(seq, "gt_traj.txt"))
    assert rows.shape == (10, 8) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows[:, 0], gt[:, 0], atol=1e-6)
    err = np.linalg.norm(rows[:, 1:4] - gt[:, 1:4], axis=1)
    assert err.max() < 0.05, np.round(err, 4)


def _feature_tiles(root):
    """Corner and surface tile maps of the synthetic room (one tile each)."""
    from pointcloud_slam_tpu_torch.io import synthetic

    world = synthetic.make_room_cloud(60_000, seed=0)
    os.makedirs(root, exist_ok=True)
    for fam, cloud in (("corner", world[::10]), ("surf", world)):
        pcd.write_pcd(os.path.join(root, f"{fam}.pcd"), cloud)
        with open(os.path.join(root, f"{fam}_arealist.csv"), "w") as f:
            f.write(f"{fam}.pcd,-20,-20,-5,20,20,5\n")


@pytest.mark.parametrize("mode", ["ndt", "loam", "feature_loam"])
def test_localization_app_modes(tmp_path, capsys, mode):
    loc = _load("apps/run_localization_torch.py", "rl_torch")
    argv = ["--synthetic", "3", "--n_points", "2000", "--device", "cpu", "--out_dir", str(tmp_path)]
    if mode == "feature_loam":
        _feature_tiles(str(tmp_path / "features"))
        argv += ["--feature_map_dir", str(tmp_path / "features"), "--n_corner", "128", "--n_surf", "512"]
    else:
        argv += ["--method", mode]
    loc.main(argv)
    out = capsys.readouterr().out
    assert "frames: 3" in out
    status = np.loadtxt(tmp_path / "status.csv", delimiter=",", skiprows=1)
    assert status.shape == (3, 5) and np.isfinite(status).all()
    traj = np.loadtxt(tmp_path / "traj_tum.txt")
    if mode != "feature_loam":      # NDT and raw-tile LOAM track the scans' true offsets (0.1 k, 0.05 k, 0)
        assert "lost: 0" in out
        want = np.array([[0.1 * k, 0.05 * k, 0.0] for k in range(3)])
        np.testing.assert_allclose(traj[:, 1:4], want, atol=0.02)


def _jax_app_fixed():
    """The nested `fixed` of apps/run_localization.py's main, compiled on its own."""
    src = open(os.path.join(ROOT, "apps", "run_localization.py")).read()
    node = next(n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.FunctionDef) and n.name == "fixed")
    ns = {"np": np, "jnp": jnp}
    exec(compile(ast.Module(body=[node], type_ignores=[]), "run_localization.py", "exec"), ns)
    return ns["fixed"]


@pytest.mark.parametrize("frac", [0.01, 0.1])
def test_fixed_size_matches_jax_app_as_sets(frac):
    """Same count of points and, while every masked point fits, the same
    set. With more masked points than slots the JAX app's numpy argsort
    (not stable) keeps another subset; the port keeps the first n in index
    order (ROADMAP §3)."""
    fixed_j = _jax_app_fixed()
    rng = np.random.default_rng(2)
    N, n = 16 * 1800, 2048
    pts = rng.normal(size=(3, N)).astype(np.float32)
    mask = rng.uniform(size=N) < frac
    out_j, m_j = (np.asarray(a) for a in fixed_j(pts, mask, n))
    out_t, m_t = features.fixed_size(torch.from_numpy(pts), torch.from_numpy(mask), n)
    out_t, m_t = out_t.numpy(), m_t.numpy()
    assert out_t.shape == out_j.shape == (3, n)
    np.testing.assert_array_equal(m_t, m_j)
    np.testing.assert_array_equal(out_t[:, ~m_t], 0.0)
    np.testing.assert_array_equal(out_t[:, m_t], pts[:, np.flatnonzero(mask)[:n]])
    if mask.sum() <= n:
        assert {tuple(c) for c in out_t[:, m_t].T} == {tuple(c) for c in out_j[:, m_j].T}


RING_BAG_FRAMES = 30
RING_BAG_MAX_ERR_M = 0.10   # PERF.md §2's localization bound; measured 0.045 m on the CPU


@pytest.fixture(scope="module")
def ring_slam(tmp_path_factory):
    """A bag of 30 sweeps of a 16 x 1,800 spinning LiDAR ray-cast in a hall of
    walls, pillars and crates (`io.synthetic.write_ring_bag`: each ring an
    ordered azimuth sweep, so the LOAM front end picks real edges and
    planes), replayed by apps/run_slam_offline_torch.py --bag_file
    --save_artifacts. Returns (SLAM output dir, ground truth R, t)."""
    from pointcloud_slam_tpu_torch.io import synthetic

    root = tmp_path_factory.mktemp("ring")
    bag, out = root / "ring.bag", root / "slam"
    _, Rs, ts = synthetic.write_ring_bag(str(bag), n_frames=RING_BAG_FRAMES)
    _load("apps/run_slam_offline_torch.py", "slam_app_ring").main(
        ["--bag_file", str(bag), "--device", "cpu", "--save_artifacts", "--out_dir", str(out)])
    return out, Rs, ts


def test_slam_app_tracks_a_ring_structured_bag(ring_slam):
    """SLAM on recorded input, held to the ground truth: every frame's pose
    and every keyframe's pose of the ring bag's replay lie within
    RING_BAG_MAX_ERR_M of the ground truth (in the first sweep's frame)."""
    out, Rs, ts = ring_slam
    gt = np.einsum("ji,nj->ni", Rs[0], ts - ts[0])
    est = np.loadtxt(out / "traj_tum.txt")[:, 1:4]
    assert est.shape == gt.shape
    err = np.linalg.norm(est - gt, axis=1)
    assert err.max() < RING_BAG_MAX_ERR_M, np.round(err, 4)
    kf = np.loadtxt(out / "poses_kitti.txt").reshape(-1, 3, 4)[:, :, 3]
    frame = [int(np.argmin(np.linalg.norm(est - p, axis=1))) for p in kf]
    kf_err = np.linalg.norm(kf - gt[frame], axis=1)
    assert len(kf) >= 5 and kf_err.max() < RING_BAG_MAX_ERR_M, np.round(kf_err, 4)


def test_feature_localization_tracks_the_ring_bag(ring_slam, tmp_path, capsys):
    """The feature-LOAM localization app (`--feature_map_dir`) on the ring
    bag's sweeps against the corner / surface tiles that
    apps/construct_full_map_torch.py builds from the SLAM replay's
    keyframes: every frame within RING_BAG_MAX_ERR_M of the ground truth,
    none lost. Its front end keeps `spread_size`'s features over all rings."""
    from pointcloud_slam_tpu_torch.io import synthetic

    out, Rs, ts = ring_slam
    _load("apps/construct_full_map_torch.py", "full_map_ring").main(
        [str(out), "--out", str(tmp_path / "full.pcd"), "--feature_maps", str(tmp_path / "tiles"), "--device", "cpu"])
    frames = tmp_path / "frames"
    frames.mkdir()
    world = synthetic.make_box_world(0)
    for k in range(RING_BAG_FRAMES):   # the bag's sweeps (write_ring_bag's seeds), sensor frame
        pts, _, _ = synthetic.spinning_scan(world, Rs[k], ts[k], seed=k)
        pcd.write_pcd(str(frames / f"frame_{k:06d}.pcd"), pts)
    _load("apps/run_localization_torch.py", "loc_ring").main(
        ["--feature_map_dir", str(tmp_path / "tiles"), "--data_dir", str(frames), "--device", "cpu",
         "--n_points", str(pts.shape[0]), "--out_dir", str(tmp_path / "loc")])
    assert "lost: 0" in capsys.readouterr().out
    gt = np.einsum("ji,nj->ni", Rs[0], ts - ts[0])
    est = np.loadtxt(tmp_path / "loc" / "traj_tum.txt")[:, 1:4]
    assert est.shape == gt.shape
    err = np.linalg.norm(est - gt, axis=1)
    assert err.max() < RING_BAG_MAX_ERR_M, np.round(err, 4)


def test_spread_size_covers_every_ring():
    """Up to n masked points it is fixed_size; past n it takes n points evenly
    spread over all of them in index order."""
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.normal(size=(3, 1000)).astype(np.float32))
    few = torch.from_numpy(rng.random(1000) < 0.05)
    for a, b in zip(features.spread_size(pts, few, 64), features.fixed_size(pts, few, 64)):
        assert torch.equal(a, b)
    many = torch.from_numpy(rng.random(1000) < 0.6)
    out, m = features.spread_size(pts, many, 100)
    src = np.flatnonzero(many.numpy())
    want = src[(np.arange(100) * len(src)) // 100]
    assert bool(m.all()) and torch.equal(out, pts[:, want])
