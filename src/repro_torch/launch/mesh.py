"""Process meshes over ``torch.distributed`` (the port of the JAX package's
``launch/mesh.py``).

A ``Mesh(data, model)`` lays the ``data * model`` processes of an
initialised world out as ``jax.make_mesh((data, model), ("data",
"model"))`` lays out devices: rank ``r`` sits at ``(r // model, r %
model)``. The ``model`` axis carries the EP ranks: a rank's
``model_group`` holds the ranks that share its data index, and its
``comm`` (``moe.dispatch.ProcessGroupRanks``) runs the dispatch's
collectives over that group. The ``data`` axis shards the batch: its
``data_group`` holds the ranks that share its model index, and its
``data_comm`` reduces over it (the serving forward's statistics and
logits; in training, ``train.steps``, the gradients and metrics). Its
``world_comm`` spans every rank, in global rank order: expert-TP decode
sums its partial outputs over the whole ``(data, model)`` world there.

``init_process`` joins the world through a ``file://`` init method, so
test workers that start worlds side by side never race for a TCP port.
The backend is ``"nccl"`` (one card per rank) unless the caller names
``"gloo"``, which runs on the CPU or, given CUDA tensors, stages every
collective through the host (``ProcessGroupRanks.host_staging``): there
is no fallback from one to the other. ``spawn`` starts a world of
processes and returns what each one's function returned; a rank that
fails or outlives the timeout fails the call.

``make_production_mesh`` is the reference's production mesh, ``(data=16,
model=16)`` or ``(pod=2, data=16, model=16)``, as an abstract mesh
(``ProductionMesh``): its axes and sizes and the coordinates of the one rank
the dry run traces (``launch.dryrun``), with ``moe.dispatch.DryRanks`` as
its collectives. It has no processes and no devices (its device is
``meta``), so it can describe 256 or 512 cards anywhere. Its batch axis is
``pod`` x ``data``: its ``data``, ``data_index`` and ``data_comm`` span
both, as ``sharding.batch_axes`` shards the batch and the FSDP storage over
both.

Importing this module initialises neither ``torch.distributed`` nor CUDA.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.moe.dispatch import DryRanks, ProcessGroupRanks

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 600.0


def init_process(rank: int, world: int, *, init_file: str,
                 backend: str = "nccl",
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the world of ``world`` processes as ``rank`` through
    ``file://init_file``. Under ``"nccl"`` each rank takes card ``rank``
    (a world of one host): fewer visible cards than ranks raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < world:
            raise RuntimeError(f"backend nccl needs a card a rank: {world} "
                               f"ranks, {cards} visible cards (name "
                               "backend gloo to share one card or run on "
                               "the CPU)")
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))


class Mesh:
    """The ``(data, model)`` mesh over the initialised world. Every rank
    must build it, in the same order as every other mesh, since it makes
    the axes' process groups. ``device``: the torch device this rank
    computes on (``cuda:<rank>`` under NCCL; under gloo the caller's
    choice, the CPU or a card the ranks share)."""

    def __init__(self, data: int, model: int, *, device=None):
        world, rank = dist.get_world_size(), dist.get_rank()
        if data * model != world:
            raise ValueError(f"mesh {data}x{model} over a world of {world}")
        self.data, self.model = data, model
        self.rank = rank
        self.data_index, self.model_index = rank // model, rank % model
        self.backend = dist.get_backend()
        if device is None:
            device = (torch.device("cuda", rank) if self.backend == "nccl"
                      else torch.device("cpu"))
        self.device = torch.device(device)
        self.model_ranks = [self.data_index * model + m for m in range(model)]
        self.data_ranks = [d * model + self.model_index for d in range(data)]
        self.model_group = self.data_group = None
        for d in range(data):               # every rank makes every group
            g = dist.new_group([d * model + m for m in range(model)])
            if d == self.data_index:
                self.model_group = g
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if m == self.model_index:
                self.data_group = g
        staging = self.backend == "gloo" and self.device.type == "cuda"
        self.comm = ProcessGroupRanks(self.model_group, ranks=model,
                                      rank=self.model_index,
                                      global_ranks=self.model_ranks,
                                      host_staging=staging)
        self.data_comm = ProcessGroupRanks(self.data_group, ranks=data,
                                           rank=self.data_index,
                                           global_ranks=self.data_ranks,
                                           host_staging=staging)
        self.world_comm = ProcessGroupRanks(dist.group.WORLD, ranks=world,
                                            rank=rank,
                                            global_ranks=range(world),
                                            host_staging=staging)

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def coords(self) -> dict:
        """{axis: this rank's index on it} (``sharding.shard_tensor``)."""
        return {"data": self.data_index, "model": self.model_index}

    @property
    def key(self) -> str:
        return f"{self.data}x{self.model}"

    def batch_rows(self, batch: int) -> Optional[slice]:
        """This rank's rows of a batch of ``batch`` rows sharded over the
        data axis, or None when the batch stays whole on every rank: no
        data axis, or a batch the data ranks do not divide (a one-slot
        prefill), which the JAX package then replicates over them."""
        if self.data == 1 or batch % self.data:
            return None
        n = batch // self.data
        return slice(self.data_index * n, (self.data_index + 1) * n)

    def agree_max(self, *values: float):
        """The largest of each value over the world: host decisions that
        read a wall clock (an admission time, an overlap window) then take
        the same branch on every rank."""
        dev = self.device if self.backend == "nccl" else "cpu"
        t = torch.tensor(values, dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        out = t.tolist()
        return out[0] if len(values) == 1 else tuple(out)

    def all_gather_object(self, obj) -> list:
        """Every rank's ``obj``, in rank order (host objects)."""
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, obj)
        return out


def rank_device(backend: str, device="cuda"):
    """(the ranks' device for ``spawn``, their intra-op threads) of an
    entry point's ``--backend`` and ``--device``: under nccl None (card
    ``rank`` each; ``device`` must be cuda); under gloo the CPU, one thread
    a rank, or card 0 shared by every rank. A card asked for without one
    raises (``device.resolve_device``)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    dev = resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend nccl runs on cards (device cuda)")
        return None, 0
    if dev.type == "cuda":
        return torch.device("cuda", 0), 0
    return dev, 1


class ProductionMesh:
    """An abstract ``(data, model)`` or ``(pod, data, model)`` mesh and one
    rank of it, ``rank`` in row-major order over the axes: what ``Mesh``
    is to a process, without processes. ``data`` is the batch axis's size
    (``pod * data``), ``data_index`` this rank's index on it; ``comm``,
    ``data_comm`` and ``world_comm`` are ``DryRanks`` over the same groups
    as ``Mesh``'s. Its device is ``meta``."""

    backend = "dry"

    def __init__(self, axes: dict, rank: int = 0):
        self.axes = dict(axes)
        if list(self.axes)[-1] != "model" or not set(self.axes) <= {
                "pod", "data", "model"}:
            raise ValueError(f"axes {self.axes}: (pod,) data, model")
        sizes = list(self.axes.values())
        world = int(np.prod(sizes))
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} of a mesh of {world}")
        self.rank, self.world = rank, world
        self.model = self.axes["model"]
        self.data = world // self.model
        self.data_index, self.model_index = rank // self.model, \
            rank % self.model
        idx = np.unravel_index(rank, sizes)
        self._coords = {a: int(i) for a, i in zip(self.axes, idx)}
        self.device = torch.device("meta")
        self.model_ranks = [self.data_index * self.model + m
                            for m in range(self.model)]
        self.data_ranks = [d * self.model + self.model_index
                           for d in range(self.data)]
        self.comm = DryRanks(ranks=self.model, rank=self.model_index,
                             global_ranks=self.model_ranks)
        self.data_comm = DryRanks(ranks=self.data, rank=self.data_index,
                                  global_ranks=self.data_ranks)
        self.world_comm = DryRanks(ranks=world, rank=rank,
                                   global_ranks=range(world))

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def coords(self) -> dict:
        return dict(self._coords)

    @property
    def key(self) -> str:
        return "x".join(str(n) for n in self.axes.values())

    batch_rows = Mesh.batch_rows


def make_production_mesh(*, multi_pod: bool = False,
                         rank: int = 0) -> ProductionMesh:
    """The reference's production mesh, (data=16, model=16) or (pod=2,
    data=16, model=16), at ``rank``."""
    axes = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    return ProductionMesh(axes, rank)


def make_dev_mesh(data: int = 2, model: int = 4, *, device=None) -> Mesh:
    """The mesh over an initialised world of ``data * model`` ranks."""
    return Mesh(data, model, device=device)


def model_axis_size(mesh) -> int:
    return mesh.shape["model"]


def batch_shards(mesh) -> int:
    """The ranks the batch splits over: ``pod`` x ``data``."""
    return int(np.prod([n for a, n in mesh.shape.items()
                        if a in ("pod", "data")]))


# ---------------------------------------------------------------------------
# a world of processes
# ---------------------------------------------------------------------------

def _worker(rank, world, data, model, backend, device, init_file, timeout_s,
            threads, fn, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_process(rank, world, init_file=init_file, backend=backend,
                     timeout_s=timeout_s)
        mesh = Mesh(data, model, device=device)
        # pickled here: the queue's own reducers would share a tensor's
        # storage with the parent by a handle that dies with this process
        out = pickle.dumps(fn(mesh, *args))
        dist.barrier()
        results.put((rank, True, out))
    except BaseException:                       # reported, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, args=(), *, data: int, model: int, backend: str = "nccl",
          device=None, timeout_s: float = DEFAULT_TIMEOUT_S,
          threads: int = 0) -> list:
    """Run ``fn(mesh, *args)`` in each of ``data * model`` new processes
    (``spawn`` start method) over a ``Mesh(data, model)``; ``fn`` and
    ``args`` must pickle, ``fn`` by its module path. ``device``: the
    ranks' torch device under gloo (default the CPU). ``threads``: intra-
    op threads a process (0: torch's default). Returns every rank's result
    in rank order. A rank that raises, exits or is still running after
    ``timeout_s`` (its collectives time out first) stops every process and
    raises ``RuntimeError`` with the failing rank's traceback."""
    world = data * model
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "init")
        procs = [ctx.Process(target=_worker, args=(
            rank, world, data, model, backend, device, init_file, timeout_s,
            threads, fn, args, results)) for rank in range(world)]
        for p in procs:
            p.start()
        out, failure = {}, None
        deadline = time.monotonic() + timeout_s + 60.0
        try:
            while len(out) < world and failure is None:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode}")
                    elif time.monotonic() > deadline:
                        failure = f"timed out after {timeout_s:.0f} s"
                    continue
                if ok:
                    out[rank] = pickle.loads(value)
                else:
                    failure = f"rank {rank} failed:\n{value}"
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.terminate()
                p.join(timeout=60.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failure is not None:
        raise RuntimeError(f"mesh {data}x{model} ({backend}): {failure}")
    return [out[r] for r in range(world)]
