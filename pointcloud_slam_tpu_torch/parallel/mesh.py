"""Process groups, the (dp, sp) device mesh and the collectives of the
sharded paths (port of `pointcloud_slam_tpu/parallel/mesh.py`).

The parallel axes are the JAX package's:
  * `dp`: independent registration problems (data parallel);
  * `sp`: the point axis of one frame, or the factor slots of a pose graph:
    each rank linearizes its shard and the partial sums are combined with
    an all-reduce over the `sp` ranks.

The functions follow `shard_map`'s SPMD style: every rank calls the same
function with the same global inputs, takes its own shard (`shard`), sums
its partial reductions where JAX has `jax.lax.psum` (`psum`), and gathers
`dp`-sharded outputs by an all-reduce of a zero-filled global tensor into
which each rank writes its rows (`gather_rows`). Only `all_reduce` and
`broadcast` are used: they are the collectives gloo runs on CUDA tensors,
and ranks that share one card cannot use NCCL.

JAX gets devices from the runtime; here each rank is a process. `launch`
spawns the ranks and initializes their group, and `replicate` broadcasts
inputs that must be identical on every rank (the card settles voxel-insert
claim races differently from run to run, so maps built on each rank can
differ; JAX's `P()` in_specs guarantee one copy).
"""

from __future__ import annotations

import math
import os
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


def mesh_shape(n: int, dp: Optional[int] = None) -> tuple:
    """(dp, sp) for n ranks: dp defaults to the largest power of two <= sqrt(n)
    that divides n, so both axes are populated when possible (4 -> (2, 2),
    8 -> (2, 4))."""
    if dp is None:
        dp = 1
        while dp * 2 <= int(math.sqrt(n)) and n % (dp * 2) == 0:
            dp *= 2
    if n % dp != 0:
        raise ValueError(f"dp={dp} does not divide {n} ranks")
    return dp, n // dp


def make_mesh(n_devices: Optional[int] = None, axes: Sequence[str] = ("dp", "sp"), dp: Optional[int] = None,
              device_type: str = "cuda"):
    """A (dp, sp) `DeviceMesh` over the initialized world (rank r at
    (r // sp, r % sp)). `n_devices`, when given, must be the world size."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}: the mesh spans the whole world")
    return DeviceMesh(device_type, torch.arange(n).reshape(mesh_shape(n, dp)), mesh_dim_names=tuple(axes))


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def shard(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's contiguous block of x along `dim` for mesh axis `axis`
    (the `P(..., axis, ...)` of a JAX in_spec). The size must divide."""
    n, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of size {size} does not divide over the {n} ranks of '{axis}'")
    c = size // n
    return x.narrow(dim, r * c, c)


def all_reduce_sum(tensors, group=None):
    """Sum a tensor or a tuple of tensors over `group`: one all-reduce for
    each dtype among them (the tensors of a dtype are packed into one
    buffer). Returns new tensors in the same structure. Counts its calls and
    bytes in `all_reduce_sum.calls` / `.bytes`."""
    single = isinstance(tensors, torch.Tensor)
    ts = (tensors,) if single else tuple(tensors)
    out = list(ts)
    for dtype in dict.fromkeys(t.dtype for t in ts):
        pos = [i for i, t in enumerate(ts) if t.dtype == dtype]
        buf = torch.cat([ts[i].reshape(-1) for i in pos])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        all_reduce_sum.calls += 1
        all_reduce_sum.bytes += buf.numel() * buf.element_size()
        for i, part in zip(pos, torch.split(buf, [ts[i].numel() for i in pos])):
            out[i] = part.view(ts[i].shape)
    return out[0] if single else tuple(out)


all_reduce_sum.calls = 0
all_reduce_sum.bytes = 0


def psum(mesh, axis: str) -> Callable:
    """The reduce hook of the sharded paths: `jax.lax.psum(t, axis)` over the
    ranks of `axis` (a tensor or a tuple of tensors)."""
    group = mesh.get_group(axis)
    return lambda tensors: all_reduce_sum(tensors, group)


def gather_rows(parts, mesh, axis: str):
    """Inverse of `shard(x, mesh, axis, 0)` for every tensor of `parts`: each
    rank writes its rows into a zero-filled global tensor and one
    all-reduce over `axis` sums them (every rank ends with all rows). Each
    row's value is added only to zeros, so it arrives exactly. Bool parts
    are carried as int32."""
    n, r = axis_size(mesh, axis), mesh.get_local_rank(axis)
    full = []
    for p in parts:
        dtype = torch.int32 if p.dtype == torch.bool else p.dtype
        g = torch.zeros((p.shape[0] * n,) + tuple(p.shape[1:]), dtype=dtype, device=p.device)
        g[r * p.shape[0]:(r + 1) * p.shape[0]] = p
        full.append(g)
    full = all_reduce_sum(tuple(full), mesh.get_group(axis))
    return tuple(g.to(p.dtype) for g, p in zip(full, parts))


def replicate(tree, src: int = 0, group=None):
    """Broadcast every tensor of a (nested) tuple / NamedTuple from rank
    `src`: returns the same structure holding rank src's values on every
    rank. Every rank must pass tensors of the same shapes and dtypes.
    Contiguous tensors receive in place; others (expanded views) are
    copied first, so use the returned tree."""
    if isinstance(tree, torch.Tensor):
        t = tree.contiguous()
        dist.broadcast(t, src, group=group)
        return t
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(replicate(t, src, group) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(t, src, group) for t in tree)
    return tree


def _rank_main(rank, world_size, backend, device, root, fn):
    """One spawned rank: set its card (or one intra-op thread on the CPU,
    where the ranks share the cores), join the group, run fn on the
    arguments saved under `root`, save what it returns (on the host) or its
    traceback there."""
    try:
        args = torch.load(os.path.join(root, "args.pt"), weights_only=False)
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        # the ranks of one host talk over the loopback interface
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(root, "store"), world_size),
                                rank=rank, world_size=world_size)
        out = fn(*args)
        torch.save(_to_host(out), os.path.join(root, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(root, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    return x


def launch(fn: Callable, world_size: int, *, device: str = "cuda", backend: Optional[str] = None,
           args: tuple = (), timeout: float = 600.0) -> list:
    """Run `fn(*args)` on `world_size` ranks, each a spawned process whose
    default group is initialized (a FileStore under a temporary directory,
    so concurrent launches never collide on a port). Returns what each rank
    returned, in rank order, with tensors on the host.

    device "cuda": rank r uses card r % device_count; device "cpu": each
    rank runs one intra-op thread. backend defaults to
    NCCL when every rank has a card of its own, else gloo (ranks that share
    a card); asking for NCCL with ranks that share a card raises, as does
    device "cuda" without a card. device "cpu" uses gloo. `fn` must be
    importable by name (a module-level function). Raises if a rank fails,
    or if the ranks are not all done within `timeout` seconds; every rank
    is ended then."""
    import torch.multiprocessing as mp

    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("launch(device='cuda'): no CUDA device is available")
        shared = world_size > torch.cuda.device_count()
        backend = backend or ("gloo" if shared else "nccl")
        if backend == "nccl" and shared:
            raise ValueError(f"NCCL needs a card per rank: {world_size} ranks, "
                             f"{torch.cuda.device_count()} card(s); use backend='gloo'")
    else:
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"device 'cpu' runs on gloo, not {backend!r}")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="pcs_launch_") as root:
        # the arguments go through a file: a process's start blocks until it
        # has read what it was handed, which it does only after its imports
        torch.save(args, os.path.join(root, "args.pt"))
        procs = [ctx.Process(target=_rank_main, args=(r, world_size, backend, device, root, fn))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if bad:
                    failed = f"rank(s) {bad} failed"
                    break
                if time.monotonic() > deadline:
                    failed = f"ranks not done within {timeout} s"
                    break
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed or bad:
            errs = []
            for r in range(world_size):
                path = os.path.join(root, f"rank{r}.err")
                if os.path.exists(path):
                    errs.append(f"--- rank {r}:\n" + open(path).read())
            raise RuntimeError(f"launch of {world_size} ranks ({backend}, {device}): {failed or f'ranks {bad} failed'}"
                               f", exit codes {[p.exitcode for p in procs]}\n" + "\n".join(errs))
        return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(world_size)]
