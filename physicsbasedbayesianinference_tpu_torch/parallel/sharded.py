"""Sharded HMC: a built kernel bound to a walker group, and the multi-process
run (port of the JAX package's ``parallel/sharded.py``).

Each process runs the transition on its own block of walkers, so the fused
kernels (A and B) run unpartitioned on the rank's card, as the JAX
package's ``shard_map`` runs its Pallas kernels on each device's block.
Randomness is the port's counterpart of JAX's per-shard key
(``fold_in(key, axis_index)``):

* the fused kernels draw from the Philox stream by global walker index
  (``walker_offset``), so a rank draws exactly the bits that one launch on
  the whole ensemble draws for its rows, and a K-rank run differs from the
  one-process run only through the reduction order of its ensemble means
  (the JAX package's shards draw streams of their own instead);
* the composed engine's generator seed has the rank folded in.

:func:`sharded_run_hmc` drives the ordinary ``hmc.run_hmc`` loop with the
group (``run_hmc(mesh=...)``), which makes the loop's means and moments the
group's. The JAX package's GSPMD path (``kernel="xla"``) has no
counterpart: the port's samplers take a walker group themselves
(``run_chees_hmc``, ``run_nuts``, ``run_smc``, ``run_parallel_tempering``
``mesh=``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..hmc import (HMCKernel, _splitmix64, build_fused_hmc_kernel,
                   build_hmc_kernel, resolve_engine, run_hmc)
from .mesh import WalkerMesh, check_divisible, gather_rows, make_walker_mesh


def fold_rank(seed: int, rank: int) -> int:
    """The composed engine's seed on rank ``rank`` of a sharded run."""
    return _splitmix64(seed ^ _splitmix64(0x5EED0000 + rank))


def shard_map_kernel(kernel: HMCKernel, mesh: WalkerMesh) -> HMCKernel:
    """``kernel`` bound to the walker group: ``init`` and ``step`` take
    this rank's block, and a step draws as the rank's part of the whole
    ensemble (module docstring): a fused step with the rank's walker offset
    (its first walker's global index), a composed one with the rank folded
    into its seed. The result carries the group as ``mesh``, which
    ``hmc.run_hmc`` reduces its statistics over."""

    def step(key, state, step_size, *args, **kwargs):
        ens = state.ensemble
        if kernel.kind == "fused" and kernel.variant_for(
                *ens.q.shape, torch.as_tensor(ens.mass).ndim) != "composed":
            return kernel.step(key, state, step_size, *args,
                               walker_offset=mesh.rank * ens.q.shape[0],
                               **kwargs)
        seed, counter = key
        return kernel.step((fold_rank(seed, mesh.rank), counter), state,
                           step_size, *args, **kwargs)

    return dataclasses.replace(kernel, step=step, mesh=mesh)


def build_sharded_hmc_step(kernel: HMCKernel, mesh: WalkerMesh,
                           state_example=None):
    """``step(key, state, step_size) -> (state', info, stats)`` on this
    rank's block, ``stats`` the group's ensemble means ``accept_rate``,
    ``divergence_rate`` and ``mean_potential_energy`` (one all-reduce).
    ``state_example`` is accepted for the JAX package's signature; the
    block's shapes are read at each step."""
    bound = shard_map_kernel(kernel, mesh)

    def step(key, state, step_size):
        new_state, info = bound.step(key, state, step_size)
        local = torch.stack((
            torch.mean(info.accept_prob),
            torch.mean(info.divergent.to(info.accept_prob.dtype)),
            torch.mean(info.potential_energy)))
        means = torch.sum(gather_rows(local, mesh), dim=0) / mesh.size
        stats = dict(zip(("accept_rate", "divergence_rate",
                          "mean_potential_energy"), means))
        return new_state, info, stats

    return step


def sharded_run_hmc(seed: int, potential_fn, init_q, *,
                    mesh: Optional[WalkerMesh] = None, kernel: str = "auto",
                    **run_kwargs):
    """``hmc.run_hmc`` on a walker group: ``init_q`` is the global
    ensemble ``[W, D]`` (the same on every rank), of which this rank takes
    its block on its device; W must be divisible by the group's size.

    ``kernel``: ``"auto"`` (the fused kernel where ``hmc.resolve_engine``
    finds one for the rank's block, so on the card by default),
    ``"fused"`` (raises where it cannot run) or ``"composed"``. With
    ``metric="dense"`` the dense step runs (composed: no fused kernel has a
    dense metric, so ``"fused"`` raises naming it).
    The result's scalars and moments are the group's, the same on every
    rank; its state and samples are this rank's block."""
    if kernel not in ("auto", "fused", "composed"):
        raise ValueError(f"bad kernel={kernel!r} (want auto|fused|composed; "
                         f"the JAX package's 'xla' GSPMD path has no "
                         f"counterpart)")
    dense = run_kwargs.get("metric", "diag") == "dense"
    if dense and kernel == "fused":
        raise ValueError("kernel='fused' cannot run metric='dense': no fused "
                         "kernel has a dense metric (want auto|composed)")
    if "num_steps" not in run_kwargs:
        raise TypeError("sharded_run_hmc requires num_steps=")
    if mesh is None:
        mesh = make_walker_mesh()
    q = torch.as_tensor(init_q)
    if q.ndim != 2:
        raise ValueError(f"init_q must be [num_walkers, num_dims]; got "
                         f"shape {tuple(q.shape)}")
    check_divisible(q.shape[0], mesh)
    q = q[mesh.block(q.shape[0])].to(mesh.device).contiguous()
    if dense:  # run_hmc builds the dense step and binds it to the group
        return run_hmc(seed, potential_fn, q, kernel=kernel, mesh=mesh,
                       **run_kwargs)
    common = dict(num_steps=run_kwargs["num_steps"],
                  temperature=run_kwargs.get("temperature", 1.0),
                  **({"constants": run_kwargs["constants"]}
                     if "constants" in run_kwargs else {}))
    integrator = run_kwargs.get("integrator", "leapfrog")
    if resolve_engine(kernel, potential_fn, q,
                      integrator=integrator) == "fused":
        hk = build_fused_hmc_kernel(potential_fn, **common)
    else:
        hk = build_hmc_kernel(potential_fn, integrator=integrator, **common)
    return run_hmc(seed, potential_fn, q, kernel=shard_map_kernel(hk, mesh),
                   mesh=mesh, **run_kwargs)
