"""Process-group setup: one process per rank, over `torch.distributed`.

Counterpart of `multi_orb_slam_tpu/parallel/multihost.py`.  A JAX program
sees every device of every host and shards over a mesh of them; a torch
program is one process per rank, joined in a process group.  `Mesh` carries
what the sharded code needs of that group: the group, this process's rank,
the world size, its device and the axis name.

    from multi_orb_slam_tpu_torch.parallel import multihost, dist_ba
    mesh = multihost.init_and_mesh()          # under torchrun, or one process
    run = dist_ba.make_dist_ba_step(mesh)

Under `torchrun` the settings come from its environment (`MASTER_ADDR`,
`MASTER_PORT`, `WORLD_SIZE`, `RANK`, `LOCAL_RANK`); with no such environment
(or `WORLD_SIZE=1`) `initialize` does nothing and the mesh is one process with
no group, on which every collective is the identity.  `spawn_local` starts N
ranks on this host without a launcher (the counterpart of the JAX tests'
virtual 8-device CPU mesh), joined through a file store, so no TCP port is
needed.

Backends: NCCL for CUDA devices, gloo for the CPU.  NCCL refuses two ranks on
one GPU, so on a one-card machine the ranks of a world above 1 share the card
through gloo, which carries `all_reduce` of CUDA tensors by staging them
through the host: such runs exercise the sharded code, they measure no
scaling.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

# a collective or a rank start-up that takes longer than this fails
TIMEOUT_S = 300.0


class Mesh(NamedTuple):
    """One rank's view of a 1-D mesh: `group` is None for a single process
    with no process group."""

    group: object
    rank: int
    world_size: int
    device: torch.device
    axis: str


def default_backend(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _int_env(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def _rank_device(device, local_rank: int) -> torch.device:
    """The device of the rank with this local index: `device` as given if it
    names an index or is not CUDA; else this host's card `local_rank` modulo
    the number of cards (ranks share a card when there are more ranks than
    cards)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def initialize(device=None, backend: str | None = None) -> None:
    """`init_process_group` from torchrun's environment; a no-op for a single
    process (no `WORLD_SIZE`, or 1) and when a group exists already.  The
    device is the CUDA device `LOCAL_RANK` unless named (`device="cpu"`)."""
    world = _int_env("WORLD_SIZE")
    if dist.is_initialized() or world in (None, 1):
        return
    dev = _rank_device(device, _int_env("LOCAL_RANK") or 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or default_backend(dev), init_method="env://", world_size=world,
        rank=int(os.environ["RANK"]), timeout=datetime.timedelta(seconds=TIMEOUT_S))


def global_mesh(axis: str = "data", device=None) -> Mesh:
    """This process's place in the default process group (world 1 and no
    group when none is initialised)."""
    if dist.is_initialized():
        dev = _rank_device(device, _int_env("LOCAL_RANK") or 0)
        return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), dev, axis)
    return Mesh(None, 0, 1, resolve_device(device), axis)


def init_and_mesh(axis: str = "data", device=None, backend: str | None = None) -> Mesh:
    initialize(device, backend)
    return global_mesh(axis, device)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`psum` over the mesh, in place: the tensor summed over every rank,
    the same bits on each.  The identity without a group."""
    if mesh.group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def rank_block(a, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the rows of `a` (numpy or a tensor), split into
    `world_size` equal blocks, on the rank's device."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    n = t.shape[0]
    if n % mesh.world_size:
        raise ValueError(f"{n} rows do not divide into {mesh.world_size} blocks")
    b = n // mesh.world_size
    return t[mesh.rank * b:(mesh.rank + 1) * b].contiguous().to(mesh.device)


def run_all(mesh: Mesh, calls) -> list:
    """Rank body that runs several `(fn, args)` in turn on one mesh:
    `[fn(mesh, *args) ...]`.  It exists so that the CPU tests start one set
    of ranks for a world size and reuse it across their calls (a rank's body
    must be importable from the package, not from a test file)."""
    return [fn(mesh, *args) for fn, args in calls]


def _rank_main(rank, world_size, backend, device, tmp, out):
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)   # the ranks share the host's cores
        store = dist.FileStore(os.path.join(tmp, "store"), world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            mesh = Mesh(dist.group.WORLD, rank, world_size, dev, "data")
            out.put((rank, True, fn(mesh, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def spawn_local(fn, world_size: int, backend: str, device, *args) -> list:
    """Run `fn(mesh, *args)` on `world_size` ranks of this host, each a
    process of its own (the `spawn` start method), joined in a process group
    of `backend` through a file store in a temporary directory.  Returns the
    ranks' results in rank order; they travel back pickled, so `fn` should
    return numpy arrays and plain values, and `fn` must be importable by name.

    Each rank's device is `device` (with `"cuda"` and no index: card
    `rank % cards`).  A rank that raises, or a run that is not done within
    `TIMEOUT_S`, stops every rank and raises here; nothing falls back."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="most_ranks_")
    # the call goes through a file: a process's arguments travel through a
    # pipe that `start` fills before it returns, so large ones would start
    # the ranks one after another
    with open(os.path.join(tmp, "call.pkl"), "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, backend, str(device), tmp, out))
             for r in range(world_size)]
    results = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + TIMEOUT_S
        # drain the queue before joining: a rank blocks on a full pipe
        while len(results) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn_local: {world_size} ranks of {backend} not done "
                                   f"in {TIMEOUT_S:.0f} s (ranks {sorted(results)} finished)")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn_local: rank(s) {dead} exited with "
                                       f"{[procs[r].exitcode for r in dead]} and no result")
                continue
            if not ok:
                raise RuntimeError(f"spawn_local: rank {rank} of {world_size} ({backend}) "
                                   f"failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world_size)]
