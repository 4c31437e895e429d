"""Process-group helpers for the (data, kf) parallelism axes — what
``stereo_svo_tpu/parallel/mesh.py`` is to JAX, on ``torch.distributed``.

JAX runs one program over a device mesh and shards arrays across it; here
the program is SPMD: one process per device, each holding its own shard,
joined by a process group per mesh axis (``nccl`` for tensors on a card,
``gloo`` on the CPU).

Axes:
  "data" — independent sequences (one or more per rank, no collective)
  "kf"   — the keyframe/map axis: landmarks and map blocks sharded for
           distributed BA / mapping; the pose-side blocks are all-reduced
           over it

Nothing tells a process of its cluster: the caller passes the rendezvous
address, the world size and the rank to :func:`initialize_multihost`.
:func:`spawn_local` starts n CPU ranks on this machine for a dry run.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve


class Mesh(NamedTuple):
    """This rank's view of a mesh: for each axis name, the process group
    of the ranks that differ from this one along that axis only (None for
    a rank outside the mesh)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    groups: Dict[str, Optional[dist.ProcessGroup]]

    def group(self, axis: str) -> dist.ProcessGroup:
        g = self.groups[axis]
        if g is None:
            raise RuntimeError(f"rank {dist.get_rank()} is outside the "
                               f"mesh {self.shape}")
        return g

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return dist.get_rank(self.group(axis))


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: int = 1, rank: int = 0,
                         device="cuda", timeout_s: float = 300.0) -> None:
    """Bring up the default process group: ``nccl`` when ``device`` is a
    card (``cuda:i`` becomes this process's current device; plain ``cuda``
    keeps the current one), ``gloo`` on the CPU. ``init_method``: the
    rendezvous every rank shares (``tcp://host:port`` or ``file://path``);
    a single-rank world may omit it. A second call in one process does
    nothing."""
    import datetime

    if dist.is_initialized():
        return
    device = resolve(device)
    if init_method is None:
        if world_size != 1:
            raise ValueError("init_method is required when world_size > 1")
        init_method = "file://" + os.path.join(
            tempfile.mkdtemp(prefix="svo_rendezvous_"), "store")
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend="nccl" if device.type == "cuda" else "gloo",
        init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Tear the default process group down (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make(n: int, axis_name: str = "data") -> Mesh:
    """1-D mesh over the first n ranks. Every rank of the default group
    must call it (creating a group is a collective)."""
    group = dist.new_group(ranks=list(range(n)))
    inside = dist.get_rank() < n
    return Mesh((axis_name,), (n,), {axis_name: group if inside else None})


def make_2d(n_data: int, n_kf: int) -> Mesh:
    """(data, kf) mesh over the first n_data·n_kf ranks: sequences × map
    shards, rank = data index · n_kf + kf index. Every rank must call it."""
    me = dist.get_rank()
    groups: Dict[str, Optional[dist.ProcessGroup]] = {"data": None,
                                                      "kf": None}
    for d in range(n_data):                  # one kf group per data row
        ranks = [d * n_kf + k for k in range(n_kf)]
        g = dist.new_group(ranks=ranks)
        if me in ranks:
            groups["kf"] = g
    for k in range(n_kf):                    # one data group per kf column
        ranks = [d * n_kf + k for d in range(n_data)]
        g = dist.new_group(ranks=ranks)
        if me in ranks:
            groups["data"] = g
    return Mesh(("data", "kf"), (n_data, n_kf), groups)


def _local_rank(rank: int, n: int, init_method: str, out_dir: str,
                fn: Callable, args: tuple) -> None:
    torch.set_num_threads(1)
    initialize_multihost(init_method, n, rank, device="cpu")
    try:
        # every rank has joined the group before any can leave it: a rank
        # whose fn returns at once would otherwise tear its side down while
        # a slower rank is still connecting, and that rank fails with gloo's
        # "Connection closed by peer" in place of its own result or error
        dist.barrier()
        result = fn(rank, n, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        shutdown()


def spawn_local(fn: Callable, n: int, args: tuple = (),
                timeout_s: float = 180.0) -> List:
    """Run ``fn(rank, n, *args)`` in n CPU processes of this machine,
    joined in one ``gloo`` group (one torch thread each), and return the
    ranks' results in rank order.

    The rendezvous is a file in a temporary directory, so concurrent
    callers cannot collide on a port. ``fn`` must be importable by the
    child processes (a module-level function) and its result picklable.
    A rank that fails raises here; ranks still running after ``timeout_s``
    are killed and a TimeoutError is raised.
    """
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="svo_spawn_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        ctx = mp.spawn(_local_rank, args=(n, init_method, tmp, fn, args),
                       nprocs=n, join=False)
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"spawn_local: {n} ranks of {fn.__name__} still "
                        f"running after {timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
