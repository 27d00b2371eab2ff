"""Multi-process bring-up for the sharded engine.

Port of ``riak_ensemble_tpu/parallel/distributed.py`` over
``torch.distributed`` in place of ``jax.distributed``.  The layout
contract of :mod:`.mesh` keeps traffic where it belongs:

- the **'ens' axis spans processes** — ensembles are independent, so it
  needs no collective at all;
- the **'peer' axis** stays inside a process where it can ('peer' is the
  innermost grid dim, so a row whose peer shards are all local runs its
  collectives in-process); a row whose peer shards sit one on each of
  several processes runs them as ``all_reduce`` (SUM / MAX) on a
  subgroup of those ranks (:class:`DistPeerAxis`).

:func:`initialize` picks NCCL when every rank has a card of its own and
gloo otherwise (several ranks on one card, or the CPU), and logs the
choice.  A single process needs no initialisation: :func:`global_mesh`
then shapes this process's devices.
"""

from __future__ import annotations

import logging
import os
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from riak_ensemble_tpu_torch.parallel.mesh import (
    Mesh, ShardedEngine, default_devices, make_mesh)

log = logging.getLogger(__name__)


def pick_backend(world_size: int) -> str:
    """NCCL when every rank can have a card of its own on this host,
    gloo otherwise."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "nccl" if n >= world_size and dist.is_nccl_available() \
        else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> Optional[str]:
    """``torch.distributed.init_process_group`` over
    ``tcp://<coordinator_address>`` with the given world size and rank;
    with no arguments it reads ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) when those are set.  A
    no-op when single-process or already initialised.  Returns the
    backend in use (None when there is no process group)."""
    if dist.is_initialized():
        return dist.get_backend()
    if coordinator_address is None:
        if "MASTER_ADDR" not in os.environ or \
                int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return None
        world = int(os.environ["WORLD_SIZE"])
        backend = pick_backend(world)
        log.info("distributed: %s backend over env://, world %d",
                 backend, world)
        dist.init_process_group(backend, init_method="env://")
        return backend
    if num_processes is None or process_id is None:
        raise ValueError("initialize: a coordinator address needs "
                         "num_processes and process_id")
    if num_processes <= 1:
        return None
    backend = pick_backend(num_processes)
    log.info("distributed: %s backend over tcp://%s, rank %d of %d",
             backend, coordinator_address, process_id, num_processes)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return backend


class DistPeerAxis:
    """A cross-process row's peer axis: ``sum`` / ``max`` are
    ``all_reduce`` SUM / MAX on the row's subgroup, ``index`` this
    process's peer shard.  Under gloo a card's tensor reduces through
    the host."""

    def __init__(self, group: Any, index: int) -> None:
        self.group = group
        self.index = index
        self._via_host = dist.get_backend(group) == "gloo"

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        y = x.cpu() if self._via_host else x.clone()
        dist.all_reduce(y, op=op, group=self.group)
        return y.to(x.device)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)


def global_mesh(n_peer: int = 1,
                devices: Optional[Sequence[Any]] = None) -> Mesh:
    """Mesh over EVERY process's devices: ens = total / n_peer, 'peer'
    innermost, processes in rank order.  ``devices`` are this process's
    (default: every card it sees); every process must bring as many.
    Call after :func:`initialize` on every process.  A row's peer shards
    are all in one process, or one in each of ``n_peer`` processes."""
    local = [torch.device(d) for d in
             (devices if devices is not None else default_devices())]
    if not dist.is_initialized() or dist.get_world_size() == 1:
        assert len(local) % n_peer == 0, (len(local), n_peer)
        return make_mesh(len(local) // n_peer, n_peer, devices=local)
    world, rank = dist.get_world_size(), dist.get_rank()
    if dist.get_backend() == "nccl":
        # NCCL's object collectives run on the current card
        torch.cuda.set_device(local[0])
    counts: List[Any] = [None] * world
    dist.all_gather_object(counts, len(local))
    if len(set(counts)) != 1:
        raise ValueError(f"global_mesh: processes bring {counts} devices; "
                         f"every process must bring as many")
    n_loc = counts[0]
    total = n_loc * world
    assert total % n_peer == 0, (total, n_peer)
    n_ens = total // n_peer
    flat = [(r, j) for r in range(world) for j in range(n_loc)]
    ranks = [[flat[i * n_peer + j][0] for j in range(n_peer)]
             for i in range(n_ens)]
    devs = [[local[flat[i * n_peer + j][1]]
             if flat[i * n_peer + j][0] == rank else None
             for j in range(n_peer)] for i in range(n_ens)]
    row_axis = {}
    for i in range(n_ens):
        row_ranks = ranks[i]
        if len(set(row_ranks)) == 1:
            continue
        if len(set(row_ranks)) != n_peer:
            raise ValueError(f"global_mesh: row {i} puts several peer "
                             f"shards on one of ranks {row_ranks}; give "
                             f"each process one device or a whole row")
        # every process creates every subgroup, in the same order
        group = dist.new_group(ranks=row_ranks)
        if rank in row_ranks:
            row_axis[i] = (lambda g: lambda j: DistPeerAxis(g, j))(group)
    return Mesh(devs, ranks=ranks, rank=rank, row_axis=row_axis)


def sharded_engine(n_peer: int = 1,
                   devices: Optional[Sequence[Any]] = None
                   ) -> ShardedEngine:
    """One-call engine over every device of the (multi-process) job."""
    return ShardedEngine(global_mesh(n_peer, devices))
