"""Process groups, the rank grid and batch placement (counterpart of
``immunostruct_tpu/parallel/mesh.py``).

JAX places a batch on a named device mesh and lets XLA insert the
collectives. Here every rank is a process: ``initialize_distributed``
joins the ranks in one ``torch.distributed`` group, ``Mesh`` lays them out
on a grid of named axes ('data', 'model', 'pipe') with one process
subgroup per line of each axis, and ``shard_batch`` keeps a rank's rows of
the global batch, the rows ``NamedSharding(P("data"))`` would place on
its device.

The backend is chosen once, from facts, and printed: NCCL when the ranks
are on CUDA devices and every rank of a host has a card of its own, gloo
on the CPU or when ranks share a card (NCCL refuses two ranks on one
device). ``collectives.py`` moves through host memory what gloo cannot
take from a CUDA tensor.

``BatchShard`` is the data axis as the loss and the random draws see it.
JAX's sharded step is the global batch's step: its draws have the global
batch's shape and its batch statistics span every shard. Under
``batch_shard(...)`` ``ops/nnp.py::draw`` draws at the global shape from
the step's generator and keeps the rank's rows, the SSL term counts its
valid residues over the whole batch and the contrastive term sees the
gathered embeddings (``utils/losses.py``, ``utils/contrastive.py``), so a
seed gives the same step at any world size.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from immunostruct_tpu_torch.structs import first_tensor, map_tensors


def world() -> tuple:
    """(rank, world size) of this process; (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """Whether this process is rank 0 (the one that writes files)."""
    return world()[0] == 0


def barrier() -> None:
    """Wait for every rank; a no-op without a group."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def pick_backend(device, local_ranks: int) -> tuple:
    """(backend, reason) for ``local_ranks`` ranks of one host on
    ``device``'s type: NCCL when each has a CUDA device of its own, gloo
    otherwise."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo", f"ranks on the {device.type}"
    cards = torch.cuda.device_count()
    if local_ranks <= cards:
        return "nccl", f"{local_ranks} rank(s) a host, {cards} card(s): " \
                       "each rank has a card of its own"
    return "gloo", (f"{local_ranks} ranks a host share {cards} card(s) "
                    "(NCCL takes one rank a card)")


def rank_device(device, local_rank: int) -> torch.device:
    """The device of the rank with ``local_rank`` on its host: for CUDA,
    ``cuda:(local_rank % device_count)``."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for and torch finds "
                           "none; pass --device cpu to run on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device="cuda", local_ranks: Optional[int] = None,
                           timeout_s: Optional[float] = None,
                           verbose: bool = True) -> torch.device:
    """Join this process to the job's group and return its device.

    With ``coordinator_address`` ("host:port" or a URL such as
    ``file://...``) and ``num_processes``/``process_id`` the group is the
    one given (errors are fatal, as in JAX). Without them it reads
    torchrun's ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``LOCAL_WORLD_SIZE``
    and ``MASTER_ADDR``/``MASTER_PORT``; without those the process is a
    group of one (an in-process store). The rank's device is
    ``rank_device(device, local rank)``; ``local_ranks`` (ranks on this
    host) defaults to ``LOCAL_WORLD_SIZE`` or the world size;
    ``timeout_s`` bounds each collective's wait. A process already in a
    group returns its device."""
    env = os.environ
    if coordinator_address is not None or num_processes is not None:
        world_size, rank = int(num_processes), int(process_id)
        local_rank = int(env.get("LOCAL_RANK", rank))
        url = coordinator_address or ""
        init = dict(init_method=url if "://" in url else f"tcp://{url}")
    elif "RANK" in env and "WORLD_SIZE" in env:
        world_size, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
        local_rank = int(env.get("LOCAL_RANK", rank))
        init = dict(init_method="env://")
    else:
        world_size, rank, local_rank = 1, 0, 0
        init = dict(store=dist.HashStore())
    if local_ranks is None:
        local_ranks = int(env.get("LOCAL_WORLD_SIZE", world_size))
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend, reason = pick_backend(dev, local_ranks)
    if timeout_s is not None:
        init["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            **init)
    if verbose:
        print(f"distributed: backend {backend} ({reason}); rank {rank} of "
              f"{world_size} on {dev}", flush=True)
    return dev


def shutdown_distributed() -> None:
    """Leave the group (the end of a multi-rank entry point)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the rank grid
# --------------------------------------------------------------------------

_MESHES: list = []


class Mesh:
    """The world's ranks on a grid of named axes, in row-major order (as
    ``np.reshape`` lays out JAX's devices). For each axis, the ranks that
    differ only in that coordinate form one process subgroup; an axis that
    spans the world uses the default group. Every rank must build the same
    meshes in the same order (``new_group`` is collective).

    ``with mesh:`` makes it the mesh that ``collectives.py`` resolves axis
    names against, as ``shard_map`` binds them in JAX."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        rank, size = world()
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             "differ in length")
        if int(np.prod(shape)) != size:
            raise ValueError(f"a mesh of shape {shape} needs "
                             f"{int(np.prod(shape))} ranks; the world has "
                             f"{size}")
        grid = np.arange(size).reshape(shape)
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names
        self.coords = dict(zip(axis_names, np.argwhere(grid == rank)[0]))
        self._ranks, self._groups = {}, {}
        for ax, name in enumerate(axis_names):
            lines = np.moveaxis(grid, ax, -1).reshape(-1, shape[ax])
            for line in lines:
                ranks = [int(r) for r in line]
                if len(ranks) == size or not dist.is_initialized():
                    group = None            # the default group, or none
                else:
                    group = dist.new_group(ranks)
                if rank in ranks:
                    self._ranks[name], self._groups[name] = ranks, group

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return int(self.coords[axis])

    def group(self, axis: str):
        """The process group of this rank's line on ``axis`` (None: the
        default group)."""
        return self._groups[axis]

    def ranks(self, axis: str) -> list:
        """The global ranks of this rank's line on ``axis``, by
        coordinate."""
        return self._ranks[axis]

    def __enter__(self):
        _MESHES.append(self)
        return self

    def __exit__(self, *exc):
        _MESHES.pop()


def current_mesh() -> Mesh:
    """The innermost mesh entered with ``with mesh:``."""
    if not _MESHES:
        raise RuntimeError("no mesh is active: run under `with mesh:` or "
                           "pass mesh=")
    return _MESHES[-1]


def make_mesh(axis_names="data", shape: Optional[Sequence[int]] = None
              ) -> Mesh:
    """A mesh over every rank: 1-D ``axis_names`` over the world by
    default, or the grid ``shape`` (e.g. ``make_mesh(("data", "model"),
    (2, 2))``)."""
    if isinstance(axis_names, str):
        axis_names = (axis_names,)
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("a mesh of several axes needs its shape")
        shape = (world()[1],)
    return Mesh(shape, axis_names)


# --------------------------------------------------------------------------
# batch placement
# --------------------------------------------------------------------------

def shard_rows(size: int, index: int, n: int, microbatches: int = 1):
    """The rows of a global batch of ``size`` that rank ``index`` of ``n``
    keeps: its contiguous 1/n, or, when the batch is split into
    ``microbatches`` (gradient accumulation), its 1/n of each microbatch in
    turn, so that the rank's k-th local microbatch is its share of the
    global k-th. A size ``n`` does not divide raises."""
    if size % n:
        raise ValueError(f"a batch of {size} rows does not divide over {n} "
                         "ranks of the data axis; pick a batch size (and a "
                         "corpus split) that it divides")
    k = microbatches
    if k <= 1 or size % k:
        per = size // n
        return slice(index * per, (index + 1) * per)
    if (size // k) % n:
        raise ValueError(f"a microbatch of {size // k} rows ({size} rows in "
                         f"{k} microbatches) does not divide over {n} ranks "
                         "of the data axis")
    per = size // k // n
    return np.concatenate([np.arange(m * (size // k) + index * per,
                                     m * (size // k) + (index + 1) * per)
                           for m in range(k)])


def shard_batch(batch, mesh: Mesh, axis_name: str = "data",
                microbatches: int = 1):
    """This rank's rows of a global ``batch`` (every tensor's leading
    axis; ``shard_rows``)."""
    rows = shard_rows(first_tensor(batch).shape[0], mesh.index(axis_name),
                      mesh.size(axis_name), microbatches)
    if isinstance(rows, np.ndarray):
        rows = torch.from_numpy(rows).to(first_tensor(batch).device)
    return map_tensors(lambda t: t[rows], batch)


def replicate_tree(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Give every rank of the mesh (the world) rank 0's parameters and
    buffers, in place: a broadcast from rank 0."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                dist.broadcast(t.data, src=0)
    return model


def shard_indices_for_process(indices, process_index: Optional[int] = None,
                              process_count: Optional[int] = None):
    """Host-side data sharding for multi-process training: each process
    keeps a contiguous 1/process_count slice of the (already shuffled)
    index list; the remainder is dropped equally, and a list shorter than
    the process count is returned whole. The defaults are this process's
    rank and the world size."""
    rank, size = world()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    indices = np.asarray(indices)
    per = len(indices) // pc
    if per == 0:
        return indices
    return indices[pi * per:(pi + 1) * per]


# --------------------------------------------------------------------------
# the data axis as the loss and the draws see it
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchShard:
    """Rank ``index`` of ``size`` on the data axis, holding ``rows`` rows
    of each segment of the batch its forward sees (``shard_rows``'s rows
    of one microbatch; a stacked twin pass holds two segments)."""

    mesh: Mesh
    axis: str
    rows: int

    @property
    def index(self) -> int:
        return self.mesh.index(self.axis)

    @property
    def size(self) -> int:
        return self.mesh.size(self.axis)

    def global_rows(self, n_local: int):
        """(rows of the global tensor, this rank's rows of it) for a local
        leading axis of ``n_local`` rows."""
        segments, rem = divmod(n_local, self.rows)
        if rem or segments == 0:
            raise ValueError(f"a leading axis of {n_local} is not a whole "
                             f"number of the shard's {self.rows}-row "
                             "segments")
        seg = self.rows * self.size
        if segments == 1:
            return seg, slice(self.index * self.rows,
                              (self.index + 1) * self.rows)
        rows = np.concatenate([
            np.arange(s * seg + self.index * self.rows,
                      s * seg + (self.index + 1) * self.rows)
            for s in range(segments)])
        return segments * seg, torch.from_numpy(rows)

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global tensor (e.g. replayed VAE noise)."""
        n_global, rows = self.global_rows(t.shape[0] // self.size)
        assert n_global == t.shape[0], (n_global, t.shape)
        return t[rows.to(t.device) if torch.is_tensor(rows) else rows]

    def draw(self, fn, shape, generator: torch.Generator) -> torch.Tensor:
        """``fn`` at the global shape from ``generator``, this rank's
        rows (on the generator's device, f32)."""
        n_global, rows = self.global_rows(shape[0])
        t = fn((n_global,) + tuple(shape[1:]), generator=generator,
               device=generator.device, dtype=torch.float32)
        return t[rows.to(t.device) if torch.is_tensor(rows) else rows]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch's rows of ``x`` on every rank, in rank order;
        its gradient is the sum over the ranks' gradients, at this rank's
        rows."""
        from immunostruct_tpu_torch.parallel.collectives import gather_rows
        return gather_rows(x, self.axis, self.mesh)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data axis (no gradient)."""
        from immunostruct_tpu_torch.parallel.collectives import psum
        return psum(x.detach(), self.axis, self.mesh)


_SHARDS: list = []


@contextlib.contextmanager
def batch_shard(shard: Optional[BatchShard]):
    """Run the block with ``shard`` as the data axis the draws and the loss
    see (None: the batch is the whole batch)."""
    _SHARDS.append(shard)
    try:
        yield shard
    finally:
        _SHARDS.pop()


def current_batch_shard() -> Optional[BatchShard]:
    return _SHARDS[-1] if _SHARDS else None
