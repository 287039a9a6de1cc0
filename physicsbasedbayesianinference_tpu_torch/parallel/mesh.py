"""Walker groups, ensemble sharding and the collectives over them (port of
the JAX package's ``parallel/mesh.py``).

The JAX package lays one ``walkers`` mesh axis over devices that one
program addresses. Here each process owns one device and one block of
walkers, and a :class:`WalkerMesh` names what a process needs of its
``torch.distributed`` group: the group, its rank and size, its device and
the axis name. Walker ``j`` of an ensemble of ``W`` lives on rank
``j // (W / K)``; every block has ``W / K`` rows.

JAX's ``walker_sharding`` and ``replicated_sharding`` are sharding objects
that place one global array across devices. A process here holds its own
block and nothing else, so they have no counterpart: :func:`shard_ensemble`
takes this rank's block of a global tree, and :func:`gather_walkers` joins
the blocks again. The replica mesh of JAX's sharded parallel tempering
(``make_replica_mesh``, ``replica_sharding``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from .distributed import rank_device

Tensor = torch.Tensor

WALKER_AXIS = "walkers"


@dataclasses.dataclass(frozen=True)
class WalkerMesh:
    """One process's view of a walker group."""

    group: Any  # a torch.distributed process group; None is the default
    rank: int
    size: int
    device: torch.device
    axis_name: str = WALKER_AXIS

    def block(self, num: int) -> slice:
        """This rank's rows of ``num`` walkers (``num`` divisible by the
        size: :func:`check_divisible`)."""
        per = num // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def peer(self, rank: int) -> int:
        """The global rank of the group's rank ``rank``."""
        rank %= self.size
        return rank if self.group is None else dist.get_global_rank(
            self.group, rank)


def make_walker_mesh(group=None, *, device=None,
                     axis_name: str = WALKER_AXIS) -> WalkerMesh:
    """The walker group of ``group`` (the default group unless given),
    which must exist (:func:`.distributed.initialize_distributed`).
    ``device``: the rank's device, by default the group's
    (:func:`.distributed.rank_device`)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: launch with torchrun and call "
            "parallel.initialize_distributed(), or call "
            "torch.distributed.init_process_group, first")
    return WalkerMesh(group=group, rank=dist.get_rank(group),
                      size=dist.get_world_size(group),
                      device=torch.device(device) if device is not None
                      else rank_device(group),
                      axis_name=axis_name)


def check_divisible(num: int, mesh: WalkerMesh,
                    what: str = "num_walkers") -> None:
    if num % mesh.size != 0:
        raise ValueError(f"{what}={num} must be divisible by the mesh size "
                         f"{mesh.size}")


def _leading_count(tree) -> int:
    for leaf in _leaves(tree):
        if leaf.ndim >= 1:
            return leaf.shape[0]
    raise ValueError("no tensor leaves to shard")


def _leaves(tree):
    if isinstance(tree, Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def _map(fn, tree):
    if isinstance(tree, Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def shard_ensemble(tree, mesh: WalkerMesh):
    """This rank's block of a global ensemble tree (a tensor, a dict, list
    or tuple of them, an ``EnsembleState`` or an ``HMCState``), on the
    rank's device.

    States are split by their structure, as the JAX package's
    ``_specs_like`` splits an ``HMCState``: q, p, the log weights and the
    cached potential and gradient are walker-leading; the mass is split
    only when it is per walker (``[W, 1]`` or ``[W, D]``), so a ``[D]``
    metric stays whole even where D equals W. In any other tree every
    tensor whose leading dimension is the walker count (that of the first
    tensor leaf with one) is split and the rest kept whole."""
    from ..ensemble import EnsembleState
    from ..hmc import HMCState

    if isinstance(tree, HMCState):
        w = tree.ensemble.q.shape[0]
        return HMCState(ensemble=shard_ensemble(tree.ensemble, mesh),
                        potential_energy=_block(tree.potential_energy, w,
                                                mesh),
                        grad=_block(tree.grad, w, mesh))
    if isinstance(tree, EnsembleState):
        w = tree.q.shape[0]
        mass = torch.as_tensor(tree.mass)
        per_walker = mass.ndim >= 2 and mass.shape[0] == w
        return EnsembleState(
            q=_block(tree.q, w, mesh), p=_block(tree.p, w, mesh),
            mass=(_block(mass, w, mesh) if per_walker
                  else mass.to(mesh.device)),
            log_weight=_block(tree.log_weight, w, mesh))
    w = _leading_count(tree)
    return _map(lambda x: (_block(x, w, mesh)
                           if x.ndim >= 1 and x.shape[0] == w
                           else x.to(mesh.device)), tree)


def _block(x: Tensor, num: int, mesh: WalkerMesh) -> Tensor:
    check_divisible(num, mesh)
    return x[mesh.block(num)].to(mesh.device).contiguous()


def gather_rows(x: Tensor, mesh: WalkerMesh) -> Tensor:
    """``[K, *x.shape]``: every rank's ``x`` in rank order, on every rank.
    One all-reduce of a zero-padded buffer, each rank filling its own row:
    adding zeros is exact, so the rows are the ranks' values bit for bit
    and every rank can merge them in the same order."""
    buf = x.new_zeros((mesh.size, *x.shape))
    buf[mesh.rank] = x
    dist.all_reduce(buf, group=mesh.group)
    return buf


def gather_walkers(x: Tensor, mesh: WalkerMesh,
                   dst: Optional[int] = None) -> Optional[Tensor]:
    """The walker-leading blocks ``x`` of every rank joined in rank order
    (one all-gather): on every rank, or with ``dst`` on that rank only
    (None elsewhere), as the command-line driver gathers its samples for
    the summary."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    if dst is not None and mesh.rank != dst:
        return None
    return torch.cat(parts)


def ring_shift(tensors, mesh: WalkerMesh) -> list:
    """One hop of the ring: each rank sends ``tensors`` to rank - 1 and
    receives rank + 1's (the JAX package's ``ppermute`` with the
    permutation ``(j, j - 1)``), so after s hops rank r holds the blocks
    of rank ``r + s`` mod K."""
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(),
                              mesh.peer(mesh.rank - 1), mesh.group))
        ops.append(dist.P2POp(dist.irecv, o, mesh.peer(mesh.rank + 1),
                              mesh.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs
