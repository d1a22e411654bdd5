"""The port's `apps/construct_full_map_torch.py --device cpu` against the JAX
package's `apps/construct_full_map.py --platform cpu` on the same three
keyframes (Scans/%06d.pcd + %06d_corner.pcd + poses_kitti.txt, the layout
`run_slam_offline_torch.py --save_artifacts` writes): the full-map PCD
(sorted, 1e-5 m), the feature tiles and arealists (byte-identical), the
PGM/YAML grids of two floors (equal but for a counted number of edge
cells, at most 0.1 % of the observed ones) and the `.bt` octree (occupied
and free leaves equal as sets)."""

import filecmp
import os
import subprocess
import sys

import numpy as np
import pytest

from pointcloud_slam_tpu.maps import occupancy as occ_j
from pointcloud_slam_tpu_torch.io import pcd
from pointcloud_slam_tpu_torch.maps import octomap_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _keyframes(root, n=3, seed=3):
    """n keyframes of 400 surface and 100 corner points each, in front of a
    sensor that moves 0.5 m a keyframe and turns 0.2 rad, and their floors."""
    rng = np.random.default_rng(seed)
    (root / "Scans").mkdir(parents=True)
    poses = []
    for k in range(n):
        surf = rng.uniform(-2, 2, (400, 3)).astype(np.float32) + [5.0, 0, 1]
        pcd.write_pcd(str(root / "Scans" / f"{k:06d}.pcd"), surf)
        pcd.write_pcd(str(root / "Scans" / f"{k:06d}_corner.pcd"), surf[::4] + [0.0, 30.0, 0.0])
        yaw = 0.2 * k
        R = np.array([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        poses.append(np.hstack([R, [[0.5 * k], [0.0], [0.0]]]).reshape(-1))
    np.savetxt(str(root / "poses_kitti.txt"), np.stack(poses))
    (root / "floors.txt").write_text("0\n1\n0\n")
    return root


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Both apps on the same keyframes, every product on: {"jax": dir, "torch": dir}."""
    kd = _keyframes(tmp_path_factory.mktemp("kf"))
    out = {}
    for name, app, extra in (("jax", "construct_full_map.py", ["--platform", "cpu"]),
                             ("torch", "construct_full_map_torch.py", ["--device", "cpu"])):
        d = tmp_path_factory.mktemp(name)
        r = subprocess.run(
            [sys.executable, os.path.join(ROOT, "apps", app), str(kd), "--out", str(d / "full.pcd"),
             "--feature_maps", str(d / "features"), "--occupancy", str(d / "grid"),
             "--floor_labels", str(kd / "floors.txt"), "--bt", str(d / "map.bt"), *extra],
            capture_output=True, text=True, timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert r.returncode == 0, r.stderr[-3000:]
        out[name] = d
    return out


def test_full_map_points(outputs):
    a, b = (pcd.read_pcd_xyz(str(outputs[n] / "full.pcd")) for n in ("jax", "torch"))
    assert a.shape == b.shape and len(a) > 100
    order = (lambda p: p[np.lexsort(p.T[::-1])])
    np.testing.assert_allclose(order(b), order(a), atol=1e-5)


def test_feature_tiles_byte_identical(outputs):
    names = sorted(os.listdir(outputs["jax"] / "features"))
    assert names == sorted(os.listdir(outputs["torch"] / "features"))
    assert {"surf_arealist.csv", "corner_arealist.csv"} <= set(names) and len(names) > 3
    for n in names:
        assert filecmp.cmp(outputs["jax"] / "features" / n, outputs["torch"] / "features" / n, shallow=False), n


@pytest.mark.parametrize("floor", ["", "1"])
def test_occupancy_grids(outputs, floor):
    """Each floor's PGM decodes to trinary grids that agree but for edge
    cells (a beam's last free cell moves when cos / sin differ by an ulp:
    counted, at most 0.1 % of the observed cells), and the YAMLs agree but
    for the image path."""
    (gj, mj), (gt, mt) = (occ_j.load_pgm(str(outputs[n] / f"grid{floor}")) for n in ("jax", "torch"))
    observed = (gj != -1) | (gt != -1)
    differ = gj != gt
    assert observed.sum() > 100
    assert differ.sum() <= 1e-3 * observed.sum(), (int(differ.sum()), int(observed.sum()))
    # an edge cell is free on one side and unknown on the other
    assert set(zip(gj[differ].tolist(), gt[differ].tolist())) <= {(0, -1), (-1, 0)}
    assert {k: v for k, v in mj.items() if k != "image"} == {k: v for k, v in mt.items() if k != "image"}


def test_bt_leaves(outputs):
    (rj, oj, fj), (rt, ot, ft) = (octomap_io.load_bt(str(outputs[n] / "map.bt")) for n in ("jax", "torch"))
    assert rj == rt == 0.2 and len(oj) > 0 and len(fj) > 0
    as_set = (lambda p: set(map(tuple, np.round(p / rj - 0.5).astype(int))))
    assert as_set(oj) == as_set(ot)
    assert as_set(fj) == as_set(ft)
