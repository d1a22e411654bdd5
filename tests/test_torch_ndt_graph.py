"""When `register/ndt.align` replays its Gauss-Newton schedule as a CUDA
graph, tested on the CPU: CPU tensors never engage; a key is captured on its
second sighting and replayed after; a new source layout, config or target
address is a new key; a freed map is seen anew; the cache drops the least
recently used key. The capture itself runs only on a card
(`tests/test_torch_cuda.py`): here a stand-in "graph" reruns the schedule into
the outputs of its capture, as a replay overwrites them, so the plumbing
(static inputs, copies out, counts) is checked bit for bit against the eager
align. Small sizes, no JAX: a few seconds."""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from pointcloud_slam_tpu_torch import register
from pointcloud_slam_tpu_torch.geom import se3
from pointcloud_slam_tpu_torch.io import synthetic
from pointcloud_slam_tpu_torch.register import ndt
from pointcloud_slam_tpu_torch.utils.timer import Timer

torch.set_num_threads(2)
N_SCAN = 300


@pytest.fixture(autouse=True)
def fresh():
    ndt._graphs.clear()
    Timer.reset()
    Timer.enable()
    yield
    Timer.enable(False)
    Timer.reset()
    ndt._graphs.clear()


@pytest.fixture(scope="module")
def room():
    """A 3,000-point room as a baked NDT target, and three scans of it from
    poses a few centimetres apart, with initial poses near them."""
    world = synthetic.make_room_cloud(3000, seed=0)
    cfg = register.NDTConfig(resolution=1.0)
    grid_cfg, target = ndt.build_target(cfg, torch.from_numpy(np.ascontiguousarray(world.T)), baked=True)
    frames = []
    for k in range(3):
        R, t = synthetic.random_pose(seed=10 + k, rot_scale=0.02, trans_scale=0.1)
        sel = np.random.default_rng(k).choice(len(world), N_SCAN, replace=False)
        scan = torch.from_numpy(np.ascontiguousarray(((world[sel] - t) @ R).astype(np.float32).T))
        mask = torch.from_numpy(np.arange(N_SCAN) % 7 != k)
        init = se3.Pose(torch.eye(3), torch.tensor([0.01 * k, -0.02, 0.0]))
        frames.append((scan, mask, init))
    return cfg, grid_cfg, target, frames


class _Replay:
    """CPU stand-in of a captured graph: a replay runs the schedule again and
    writes into the outputs of its capture."""

    captures = 0

    def __init__(self, fn):
        self.fn, self.out = fn, fn()
        _Replay.captures += 1

    def replay(self):
        Timer.enable(False)            # a replay runs no Python, so no span
        try:
            new = self.fn()
        finally:
            Timer.enable()
        for o, n in zip(torch.utils._pytree.tree_leaves(self.out), torch.utils._pytree.tree_leaves(new)):
            o.copy_(n)


@pytest.fixture
def stand_in(monkeypatch):
    """align engages on CPU tensors, and captures with `_Replay`."""
    _Replay.captures = 0
    monkeypatch.setattr(ndt, "_engages", lambda source: True)

    def capture(fn):
        r = _Replay(fn)
        return r, r.out

    monkeypatch.setattr(ndt, "_capture", capture)


def _align(room, k, defaults=False):
    cfg, grid_cfg, target, frames = room
    scan, mask, init = frames[k]
    if defaults:
        return ndt.align(grid_cfg, target, scan, cfg=cfg)
    return ndt.align(grid_cfg, target, scan, mask, init, cfg=cfg)


def _equal(a, b):
    la, lb = torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_cpu_tensors_never_engage(room):
    for k in (0, 0, 0, 1):
        _align(room, k)
    assert not ndt._graphs
    assert all("ndt.graph_captures" not in f.counts and "ndt.graph_replays" not in f.counts for f in Timer.frames())


@pytest.mark.parametrize("defaults", [False, True], ids=["mask_and_pose", "defaults"])
def test_capture_on_the_second_sighting_then_replays_with_the_eager_bits(room, stand_in, monkeypatch, defaults):
    """Frames 0, 0, 1, 2, 1 of one key: eager, captured and replayed, then
    replays; each result equal to the eager align's bit for bit, also after
    the later replays (no result aliases the static outputs)."""
    order = [0, 0, 1, 2, 1] if not defaults else [0, 0, 0]
    got = [_align(room, k, defaults) for k in order]
    counts = [f.counts for f in Timer.frames()]
    assert [c.get("ndt.graph_captures", 0) for c in counts] == [0, 1] + [0] * (len(order) - 2)
    assert [c.get("ndt.graph_replays", 0) for c in counts] == [0] + [1] * (len(order) - 1)
    assert _Replay.captures == 1 and len(ndt._graphs) == 1
    spans = [{s.name for s in f.spans} for f in Timer.frames()]
    assert {"ndt.search", "ndt.solve"} <= spans[0] and {"ndt.linearize", "ndt.eig"} <= spans[-1]
    assert not {"ndt.search", "ndt.solve"} & spans[-1]
    assert [c["ndt.iterations_used"] for c in counts] == [int(r.iterations) for r in got]
    monkeypatch.setattr(ndt, "_engages", lambda source: False)
    for k, res in zip(order, got):
        _equal(res, _align(room, k, defaults))


def test_a_captured_entry_holds_its_map_and_a_seen_one_does_not(room, stand_in):
    cfg, grid_cfg, target, frames = room
    seen = [t.clone() for t in target]
    refs = [weakref.ref(t) for t in seen]
    ndt.align(grid_cfg, type(target)(*seen), *frames[0], cfg=cfg)
    del seen
    gc.collect()
    assert all(r() is None for r in refs)
    held = type(target)(*(t.clone() for t in target))
    refs = [weakref.ref(t) for t in held]
    for _ in range(2):
        ndt.align(grid_cfg, held, *frames[0], cfg=cfg)
    del held
    gc.collect()
    assert all(r() is not None for r in refs) and _Replay.captures == 1


def _key(room, **change):
    cfg, grid_cfg, target, frames = room
    scan, mask, init = frames[0]
    args = dict(cfg=cfg, grid_cfg=grid_cfg, target=target, source=scan, source_mask=mask, init_pose=init)
    args.update(change)
    return ndt._graph_key(**args)


@pytest.mark.parametrize("change", ["source_points", "source_shape", "source_dtype", "no_mask", "no_init", "cfg",
                                    "grid_cfg", "target_address", "target_type"])
def test_what_makes_a_new_key(room, change):
    cfg, grid_cfg, target, frames = room
    scan, mask, init = frames[0]
    other = {
        "source_points": dict(source=frames[1][0]),
        "source_shape": dict(source=scan[:, :-1], source_mask=mask[:-1]),
        "source_dtype": dict(source=scan.double(), init_pose=se3.Pose(init.R.double(), init.t.double())),
        "no_mask": dict(source_mask=None),
        "no_init": dict(init_pose=None),
        "cfg": dict(cfg=dataclasses.replace(cfg, search_every=4)),
        "grid_cfg": dict(grid_cfg=dataclasses.replace(grid_cfg, probe=4)),
        "target_address": dict(target=type(target)(*(t.clone() for t in target))),
        "target_type": dict(target=ndt.build_target(cfg, scan)[1]),
    }[change]
    same = change == "source_points"         # other points of the same layout: the same graph
    assert (_key(room, **other) == _key(room)) == same
    assert hash(_key(room)) == hash(_key(room))


def test_a_freed_map_is_seen_anew():
    key, t = ("k",), torch.zeros(4)
    assert ndt._sighting(key, [t]) is None and ndt._sighting(key, [t]) is not None
    key2, t2 = ("k2",), torch.zeros(4)
    assert ndt._sighting(key2, [t2]) is None
    del t2
    gc.collect()
    assert ndt._sighting(key2, [torch.zeros(4)]) is None


def test_the_cache_drops_the_least_recently_used_key():
    maps = [torch.zeros(2) for _ in range(ndt.GRAPH_CACHE + 2)]
    for i in range(ndt.GRAPH_CACHE):
        ndt._sighting((i,), [maps[i]])
    ndt._sighting((0,), [maps[0]])                   # key 0 becomes the most recent
    ndt._sighting((ndt.GRAPH_CACHE,), [maps[-2]])    # drops key 1
    assert list(ndt._graphs) == [(k,) for k in range(2, ndt.GRAPH_CACHE)] + [(0,), (ndt.GRAPH_CACHE,)]
    assert ndt._sighting((1,), [maps[1]]) is None    # seen anew; drops key 2
    assert len(ndt._graphs) == ndt.GRAPH_CACHE and (2,) not in ndt._graphs
    assert ndt._sighting((0,), [maps[0]]) is not None
