"""Distributed systematic resampling over the walker group (port of the JAX
package's ``parallel/resample.py``).

SMC's resampling is the one ensemble operation that moves walkers across
ranks. As in the JAX package it is a ring stream: memory per rank stays
O(W/K) for the ensemble, and the walkers travel in K - 1 hops of one block
each (the schedule of :mod:`.ring`'s N-body forces).

The plan is the one-process resampler's, exactly. ``smc`` builds its
inverse CDF in 2^-52 fixed point: each walker's weight rounded to an
integer, a prefix sum that is exact in any order. A rank computes its own
walkers' integers (from the global log-normaliser), their local prefix sum
and its total; one all-gather of the K totals gives every rank the
offsets of the other blocks' CDFs. The positions ``(u0 + j) / W`` of the
rank's output slots, with ``u0`` drawn alike on every rank from ``(seed,
stage)``, fall in one block each: the owner is found among the K block
ends, the index within the owner's own CDF as the block passes by. So the
K-rank indices are the indices of ``smc.systematic_indices`` on the whole
ensemble, bit for bit.
"""

from __future__ import annotations

import torch

from ..smc import _FIXED_ONE, _RESAMPLE_COUNTER, _step_generator, _uniforms
from .mesh import WalkerMesh, gather_walkers, ring_shift

Tensor = torch.Tensor


def systematic_offset(seed: int, stage: int, like: Tensor) -> Tensor:
    """The uniform offset of stage ``stage``'s systematic resample, the one
    ``smc``'s one-process resampler draws (``like``: the log-weights, for
    dtype and device)."""
    gen = _step_generator((seed, _RESAMPLE_COUNTER + stage), like.device)
    return _uniforms(gen, (), like)


def _flatten(tree) -> tuple[list, object]:
    if isinstance(tree, Tensor):
        return [tree], None
    if isinstance(tree, dict):
        return list(tree.values()), tuple(tree)
    return list(tree), type(tree)


def _unflatten(leaves: list, spec):
    if spec is None:
        return leaves[0]
    if isinstance(spec, tuple):
        return dict(zip(spec, leaves))
    return spec(leaves)


def ring_resample_blocks(tree, log_w: Tensor, log_norm: Tensor, u0: Tensor,
                         mesh: WalkerMesh):
    """Systematic resampling of this rank's blocks ``tree`` (a tensor, or a
    dict, list or tuple of walker-leading tensors) by its log-weights
    ``log_w`` ``[W/K]``, with ``log_norm`` the logsumexp of all W
    log-weights in float64 and ``u0`` the offset: the rank's output
    blocks."""
    k, me = mesh.size, mesh.rank
    w_loc = log_w.shape[0]
    ints = torch.round(torch.exp(log_w.double() - log_norm)
                       * _FIXED_ONE).to(torch.int64)
    cdf = torch.cumsum(ints, dim=0)
    totals = gather_walkers(cdf[-1:], mesh)            # [K], exact
    ends = torch.cumsum(totals, dim=0)
    base = ends - totals
    slots = torch.arange(me * w_loc, (me + 1) * w_loc, dtype=log_w.dtype,
                         device=log_w.device)
    fixed = torch.floor(((u0 + slots) / (k * w_loc)).double()
                        * _FIXED_ONE).to(torch.int64)
    # a position at or past the last end falls to the last walker
    owner = torch.clamp(torch.searchsorted(ends, fixed, right=True),
                        max=k - 1)
    rel = fixed - base[owner]
    leaves, spec = _flatten(tree)
    out = [torch.zeros_like(x) for x in leaves]
    visiting = [*leaves, cdf]
    for s in range(k):
        *blocks, src_cdf = visiting
        idx = torch.clamp(torch.searchsorted(src_cdf, rel, right=True), 0,
                          w_loc - 1)
        take = owner == (me + s) % k
        out = [torch.where(take.reshape((-1,) + (1,) * (o.ndim - 1)),
                           b.index_select(0, idx), o)
               for o, b in zip(out, blocks)]
        if s + 1 < k:
            visiting = ring_shift(visiting, mesh)
    return _unflatten(out, spec)


def ring_systematic_resample(seed: int, stage: int, tree, log_w: Tensor, *,
                             mesh: WalkerMesh):
    """Exact global systematic resampling of this rank's blocks ``tree`` by
    its log-weights ``log_w`` ``[W/K]``, with the offset of ``(seed,
    stage)``: ``(tree', zeroed log-weights)``, the same contract as
    ``smc.resample(method="systematic")``, distributed. Collectives: one
    all-gather of the log-weights (for the global normaliser), one of K
    integer totals, and K - 1 ring hops."""
    log_norm = torch.logsumexp(gather_walkers(log_w, mesh).double(), dim=0)
    out = ring_resample_blocks(tree, log_w, log_norm,
                               systematic_offset(seed, stage, log_w), mesh)
    return out, torch.zeros_like(log_w)
