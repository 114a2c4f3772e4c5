"""The ranks of a run and their collectives (counterpart of
``leftrefill_tpu/parallel/mesh.py`` and ``make_view_mesh`` of
``leftrefill_tpu/parallel/context.py``).

A run is one process per rank, as ``torchrun`` starts it: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` in the environment,
``MASTER_ADDR`` and ``MASTER_PORT`` for the rendezvous.  The backend follows
from the device: NCCL when every local rank has a card of its own
(``cuda:LOCAL_RANK``), gloo otherwise, that is on the CPU and where ranks
share a card (``cuda:LOCAL_RANK % count``; NCCL refuses two ranks on one
device).  Gloo moves CUDA tensors through host memory."""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in the run: its global and node-local rank and
    their sizes, its node and the node count, its device and the group of
    all ranks (None when the run has one rank and no process group)."""

    rank: int
    world: int
    local_rank: int
    local_world: int
    node: int
    nodes: int
    device: torch.device
    group: Optional[dist.ProcessGroup]

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def backend_for(device, local_world: int) -> str:
    """NCCL when the ranks of a node each have a card of their own, gloo
    otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK`` (modulo the card count, where
    ranks share cards), or the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("the run is on the card and CUDA is not available (pass device='cpu' to run on the CPU)")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_from_env(device="cuda", init_method: str = "env://",
                  timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Ranks:
    """The rank of this process from torchrun's environment, with the
    default process group initialised over the backend the device calls for
    (or the one already initialised), at any world size torchrun gives.
    Without torchrun's variables and without a group the run has one rank.
    ``init_method``: the rendezvous (torchrun's ``env://``; tests use
    ``file://``)."""
    if os.environ.get("WORLD_SIZE") and not dist.is_initialized():
        world, rank = _env_int("WORLD_SIZE", 1), _env_int("RANK", 0)
        local_world = _env_int("LOCAL_WORLD_SIZE", world)
        dev = rank_device(device, _env_int("LOCAL_RANK", rank))
        backend = backend_for(dev, local_world)
        if backend == "nccl":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world, timeout=timeout)
        if rank == 0:
            print(f"torch.distributed: {world} ranks, {local_world} a node, backend {backend}, rank 0 on {dev}",
                  flush=True)
    grouped = dist.is_initialized()
    rank, world = (dist.get_rank(), dist.get_world_size()) if grouped else (0, 1)
    local_rank, local_world = _env_int("LOCAL_RANK", rank), _env_int("LOCAL_WORLD_SIZE", world)
    return Ranks(rank, world, local_rank, local_world, rank // local_world, max(world // local_world, 1),
                 rank_device(device, local_rank), dist.group.WORLD if grouped else None)


def group_rank(group: Optional[dist.ProcessGroup]) -> int:
    return 0 if group is None else dist.get_rank(group)


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def make_groups(n_data: int, n_view: int):
    """(data group, view group) of this rank in a (data, view) layout: the
    ranks in the order ``reshape(n_data, n_view)``, as JAX's
    ``make_view_mesh`` lays out devices, so a view group is n_view
    consecutive ranks and a data group the ranks n_view apart.  Every rank
    creates every group, in one order (``dist.new_group`` is collective)."""
    world = dist.get_world_size()
    if n_data * n_view != world:
        raise ValueError(f"a ({n_data} data, {n_view} view) layout needs {n_data * n_view} ranks, the run has {world}")
    rank = dist.get_rank()
    data_group = view_group = None
    for v in range(n_view):
        g = dist.new_group([d * n_view + v for d in range(n_data)])
        if rank % n_view == v:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_view + v for v in range(n_view)])
        if rank // n_view == d:
            view_group = g
    return data_group, view_group


def all_gather_cat(x: torch.Tensor, group: dist.ProcessGroup, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of the group, concatenated along ``dim`` in rank
    order (JAX's tiled ``all_gather``); every rank's x has one shape."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def replicate(module: torch.nn.Module, group: Optional[dist.ProcessGroup]) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from the group's
    first rank (JAX's ``replicate``: the same values on every device)."""
    if group is None:
        return module
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src, group=group)
    return module


def shard_rows(x, rank: int, world: int):
    """The ``rank``-th of ``world`` contiguous row blocks of ``x`` (JAX's
    ``P('data')``); the rows must divide."""
    if x.shape[0] % world:
        raise ValueError(f"{x.shape[0]} rows do not split over {world} ranks")
    n = x.shape[0] // world
    return x[rank * n: (rank + 1) * n]


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """The rank's contiguous rows of every array of a batch (numpy arrays
    and tensors; other entries as they are)."""
    return {k: shard_rows(v, rank, world) if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim else v
            for k, v in batch.items()}


def collective_device(group: dist.ProcessGroup) -> torch.device:
    """Where a host value must lie for a collective of ``group``: the
    current card under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_mean(tensors: list, group: dist.ProcessGroup) -> None:
    """Each tensor replaced in place by its mean over the group's ranks, one
    all-reduce a dtype over the tensors flattened into one buffer."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    size = dist.get_world_size(group)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat /= size
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))
