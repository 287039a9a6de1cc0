"""Parallel tempering (replica exchange) over physical temperatures (port of
the JAX package's ``tempering.py``).

R replicas of the walker ensemble at inverse temperatures ``beta_r`` (the
cold one, ``beta_0 = 1``, targets ``exp(-U / (k_B T))``) evolve side by
side; after each HMC sweep, adjacent replicas exchange configurations
walker by walker with the Metropolis rule

    P(swap a <-> b) = min(1, exp((beta_a - beta_b) (U(q_a) - U(q_b)))),

even pairs (0,1)(2,3)... on even transitions and odd pairs (1,2)(3,4)...
on odd ones, both members of a pair deciding on the same uniform.

The HMC sweep runs one transition per replica. On the fused engine
(``hmc.resolve_engine``: CUDA and a potential with ``diag_quadratic`` or a
``device_form``) that is one launch of kernel A or B for all the replicas
(the kernels' rung axis, ``ops.kernels``; a ladder of more than
``kernels.MAX_RUNGS`` rungs takes a launch for each block of that many),
each replica with its beta, step size and thermal momentum std ``sqrt(m /
beta)`` read from the device, and each replica's rows the bits of a launch
of it alone; the composed engine integrates all R x W walkers as one batch.
Neither the sweep, the swaps nor the warmup's dual averaging reads the
device, so the warmup and sampling loops never synchronise.

Randomness: transition ``t`` of a run keyed ``seed`` sweeps replica ``r``
on the fused engine with the Philox key ``(_replica_seed(seed, r), t)``,
on the composed engine from the generator of ``(seed, t)``, and draws its
swap uniforms from the generator of ``(splitmix64(seed), t)``.

Over a replica x walker group (``mesh=``, ``parallel.make_replica_mesh``)
each rank holds a block of rungs and walkers: it sweeps its rungs at their
global keys and walker offset, takes its rows and columns of the swap
uniforms, and exchanges the edge rung of its block with the neighbouring
replica shard where a pair crosses it. A fused run at a fixed step size is
the one-process run bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Callable, Optional, Union

import numpy as np
import torch

from .adaptation import da_init, da_update
from .constants import Constants, NATURAL
from .device import resolve_device
from .hmc import (FusedTransition, _combine_moments, _splitmix64,
                  _step_generator, _synchronize, resolve_engine)
from .ops.integrators import get_integrator
from .ops.potentials import batched_value_and_grad
from .parallel.mesh import as_replica_mesh, gather_rows, shard_replicas

Tensor = torch.Tensor


def geometric_ladder(num_replicas: int, beta_min: float = 0.05,
                     dtype=torch.float32, device=None) -> Tensor:
    """Inverse-temperature ladder ``[1, ..., beta_min]`` with geometric
    spacing (swap acceptance between neighbours is then roughly uniform;
    Earl & Deem 2005)."""
    if num_replicas < 1:
        raise ValueError("need at least one replica")
    device = resolve_device(device)
    if num_replicas == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    expo = torch.arange(num_replicas, dtype=dtype,
                        device=device) / (num_replicas - 1)
    return torch.as_tensor(beta_min, dtype=dtype, device=device) ** expo


def _partner_tables(num_replicas: int) -> tuple[np.ndarray, np.ndarray]:
    """Even/odd adjacent-pair partner permutations: even (0,1)(2,3)...,
    odd (1,2)(3,4)...; an unpaired replica maps to itself."""
    even = np.arange(num_replicas)
    for a in range(0, num_replicas - 1, 2):
        even[a], even[a + 1] = a + 1, a
    odd = np.arange(num_replicas)
    for a in range(1, num_replicas - 1, 2):
        odd[a], odd[a + 1] = a + 1, a
    return even, odd


def _replica_seed(seed: int, replica: int) -> int:
    """The Philox key of replica ``replica``'s sweeps in a run keyed
    ``seed``."""
    return _splitmix64(_splitmix64(seed) ^ (replica + 1))


def swap_phase(q: Tensor, u: Tensor, g: Tensor, beta_eff: Tensor,
               partner: Tensor, uniform: Tensor):
    """Replica exchange between ``partner``-paired replicas, walker by walker:
    ``(q', u', g', swap rate [R])``. ``uniform`` ``[R, W]``: each pair takes
    the row of its lower replica, so both members decide alike."""
    return _block_swap(q, u, g, _swap_plan(beta_eff, partner, 0, q.shape[0],
                                           False), uniform)


def _swap_plan(beta_eff: Tensor, partner: Tensor, first: int, num_block: int,
               below: bool):
    """What a swap of the rungs ``first .. first + num_block - 1`` of a
    ladder indexes, fixed for a ladder, a block and a parity: each rung's
    partner's place among the block and its neighbouring rung below (where
    ``below`` pairs across the block's lower edge), the row of the
    uniforms its pair shares (the lower rung's), whether it is paired, and
    ``beta - beta_partner``."""
    rungs = torch.arange(first, first + num_block, device=beta_eff.device)
    mate = partner[rungs]
    return (mate - (first - 1 if below else first), torch.minimum(rungs, mate),
            (mate != rungs)[:, None], (beta_eff[rungs] - beta_eff[mate])[:, None])


def _block_swap(q: Tensor, u: Tensor, g: Tensor, plan, uniform: Tensor,
                below=None, above=None):
    """:func:`swap_phase` on a block of rungs (``q`` ``[R_b, W_b, D]``) by
    its :func:`_swap_plan`: ``uniform`` ``[R, W_b]`` is the whole ladder's,
    and ``below`` / ``above`` the ``(q, u, g)`` of the neighbouring rungs
    where a pair crosses the block's edge. The same operations as on the
    whole ladder, so both members of a pair decide alike on both ranks,
    and the block's rows are the whole ladder's bit for bit."""
    at, rows, paired, dbeta = plan
    parts = [q, u, g]
    if below is not None:
        parts = [torch.cat((b[None], x)) for b, x in zip(below, parts)]
    if above is not None:
        parts = [torch.cat((x, a[None])) for a, x in zip(above, parts)]
    ext_q, ext_u, ext_g = parts
    delta = dbeta * (u - ext_u[at])  # [R_b, W_b]
    log_uni = torch.log(torch.clamp_min(uniform[rows],
                                        torch.finfo(uniform.dtype).tiny))
    do = (log_uni < delta) & paired
    sel = do[:, :, None]
    return (torch.where(sel, ext_q[at], q), torch.where(do, ext_u[at], u),
            torch.where(sel, ext_g[at], g), torch.mean(do.to(q.dtype), 1))


def build_pt_transition(
    potential_fn: Callable[[Tensor], Tensor],
    *,
    betas,
    num_dims: int,
    num_steps: int = 10,
    integrator: str = "leapfrog",
    mass: Union[float, Tensor] = 1.0,
    temperature: float = 1.0,
    constants: Constants = NATURAL,
    kernel: str = "auto",
    dtype=torch.float32,
    device=None,
    mesh=None,
):
    """The replica-exchange transition, shared by
    :func:`run_parallel_tempering` and a checkpointing driver:

        transition(key, q[R,W,D], u[R,W], g[R,W,D], step_sizes[R], i)
            -> (q, u, g, accept[R], swap_rate[R])

    with ``key = (seed, t)`` and ``i`` the counter whose parity picks the
    swap pairs. ``kernel``: "auto" | "fused" | "composed", decided by
    ``hmc.resolve_engine`` for ``device`` (where the walkers live).

    ``mesh``: a replica x walker group (``parallel.make_replica_mesh``) or
    a walker group (every rung on every rank). The transition then takes
    and returns this rank's block (``parallel.shard_replicas``: ``R_b =
    R / K_r`` rungs of ``W_b = W / K_w`` walkers; ``step_sizes`` its
    rungs'), and its acceptance and swap rates are means over the rank's
    walkers. A fused sweep draws rung r at its global index and walker
    offset, so it is the one-process sweep's rows; the composed sweep folds
    the rank into its seed. The swap uniforms are the one-process ``[R,
    W]`` draw's rows and columns, and the pairs that cross a replica
    shard's edge exchange the edge rung's ``(q, u, g)`` with the
    neighbouring shard, point to point.

    Returns ``(transition, kernel_used, vg)``.
    """
    device = resolve_device(device if mesh is None else mesh.device, betas)
    betas = torch.as_tensor(betas, dtype=dtype).to(device)
    num_replicas = betas.shape[0]
    probe = torch.empty((0, num_dims), dtype=dtype, device=device)
    engine = resolve_engine(kernel, potential_fn, probe,
                            integrator=integrator)
    integ = get_integrator(integrator)
    vg = batched_value_and_grad(potential_fn)
    beta_eff = constants.beta(temperature) * betas  # [R]
    mass = torch.as_tensor(mass, dtype=dtype).to(device)
    inv_mass = 1.0 / mass
    tables = _partner_tables(num_replicas)
    partners = tuple(torch.as_tensor(t, device=device) for t in tables)
    fused = (FusedTransition(potential_fn, temperature=temperature,
                             constants=constants)
             if engine == "fused" else None)
    # this rank's rungs first .. first + R_b - 1 and its walker shard
    first, num_block, k_w, walker_rank, replicas = 0, num_replicas, 1, 0, None
    if mesh is not None:
        from .parallel.mesh import check_divisible, exchange
        from .parallel.sharded import fold_rank
        rm = as_replica_mesh(mesh)
        replicas = rm.replicas
        check_divisible(num_replicas, replicas, "num_replicas")
        num_block = num_replicas // replicas.size
        first = replicas.rank * num_block
        k_w, walker_rank = rm.walkers.size, rm.walkers.rank
    block_betas = beta_eff[first:first + num_block]
    ladder = None if fused is None else fused.ladder(block_betas, mass,
                                                     num_dims)
    rung_keys = {}  # seed -> the Philox keys of this block's rungs
    # for each parity: whether a pair crosses the block's lower and upper
    # edges, and the swap's plan
    last = first + num_block - 1
    crossing = [(first > 0 and t[first] == first - 1,
                 last < num_replicas - 1 and t[last] == last + 1)
                for t in tables]
    plans = [_swap_plan(beta_eff, partners[p], first, num_block,
                        crossing[p][0]) for p in (0, 1)]

    def composed_sweep(key, q, u, g, step_sizes):
        """One composed HMC transition of every replica, all R x W walkers
        as one batch: unscaled potential, replica r's momenta thermal at
        its beta_r (std sqrt(m / beta_r)), accepted with exp(-beta_r dH)."""
        _, w, d = q.shape
        if mesh is not None:
            key = (fold_rank(key[0], rm.rank), key[1])
        gen = _step_generator(key, q.device)
        p0 = torch.sqrt(mass / block_betas[:, None, None]) * torch.randn(
            q.shape, generator=gen, dtype=q.dtype, device=q.device)
        q1, p1, u1, g1 = integ(
            vg, q.reshape(-1, d), p0.reshape(-1, d),
            step_size=step_sizes.repeat_interleave(w)[:, None],
            num_steps=num_steps, inv_mass=inv_mass, grad=g.reshape(-1, d),
            potential_energy=u.reshape(-1))
        q1, p1, g1 = (x.reshape(q.shape) for x in (q1, p1, g1))
        u1 = u1.reshape(u.shape)
        h0 = 0.5 * torch.sum(p0 * p0 * inv_mass, dim=-1) + u
        h1 = 0.5 * torch.sum(p1 * p1 * inv_mass, dim=-1) + u1
        derr = block_betas[:, None] * (h1 - h0)
        derr = torch.where(torch.isfinite(derr), derr, torch.inf)
        uniform = torch.rand(u.shape, generator=gen, dtype=q.dtype,
                             device=q.device)
        acc = (torch.log(torch.clamp_min(uniform, torch.finfo(q.dtype).tiny))
               < -derr)
        sel = acc[:, :, None]
        return (torch.where(sel, q1, q), torch.where(acc, u1, u),
                torch.where(sel, g1, g),
                torch.mean(torch.exp(torch.clamp_max(-derr, 0.0)), dim=1))

    def fused_sweep(key, q, u, g, step_sizes):
        """The same statistics in one launch of kernel A or B for the
        block's rungs, rung r keyed ``_replica_seed(seed, first + r)`` with
        beta_r as the kernel's beta and the momenta thermal at it."""
        seed, t = key
        if seed not in rung_keys:
            rung_keys[seed] = [_replica_seed(seed, first + r)
                               for r in range(num_block)]
        q, u, g, accept_prob = fused.rungs(
            rung_keys[seed], t, q, u, g, step_sizes, ladder,
            num_steps=num_steps, walker_offset=walker_rank * q.shape[1])
        # a mean a rung: on the card one torch.mean(..., dim=1) sums the
        # rungs in another order than a mean of one rung's [W] (other bits
        # at W = 16384, 8192 and 1024 on an H100), and the warmup's step
        # sizes adapt on these
        return q, u, g, torch.stack([torch.mean(a) for a in accept_prob])

    sweep = composed_sweep if fused is None else fused_sweep

    def edges(q, u, g, i):
        """The neighbouring shards' edge rungs that pair with this block's
        on parity ``i``: ``(below, above)``, each ``(q, u, g)`` or None."""
        lower, upper = crossing[i % 2]
        send = {}
        if lower:
            send[replicas.rank - 1] = 0
        if upper:
            send[replicas.rank + 1] = num_block - 1
        if not send:
            return None, None
        d = q.shape[-1]
        got = exchange({peer: torch.cat((q[r], u[r][:, None], g[r]), dim=1)
                        for peer, r in send.items()}, replicas)

        def unpack(x):
            return None if x is None else (x[:, :d], x[:, d], x[:, d + 1:])
        return (unpack(got.get(replicas.rank - 1)),
                unpack(got.get(replicas.rank + 1)))

    def transition(key, q, u, g, step_sizes, i):
        q, u, g, acc = sweep(key, q, u, g, step_sizes)
        seed, t = key
        uniform = torch.rand((num_replicas, q.shape[1] * k_w),
                             generator=_step_generator(
                                 (_splitmix64(seed), t), q.device),
                             dtype=q.dtype, device=q.device)
        if k_w > 1:
            w = q.shape[1]
            uniform = uniform[:, walker_rank * w:(walker_rank + 1) * w]
        below, above = edges(q, u, g, i)
        q, u, g, swaps = _block_swap(q, u, g, plans[i % 2], uniform, below,
                                     above)
        return q, u, g, acc, swaps

    return transition, engine, vg


@dataclasses.dataclass
class PTResult:
    """Output of :func:`run_parallel_tempering`."""

    samples: Optional[Tensor]  # [S, W, D] cold-replica draws
    q: Tensor  # [R, W, D] final replica positions (a mesh: the block)
    u: Tensor  # [R, W] their unscaled potential energies
    g: Tensor  # [R, W, D] and gradients, as the next transition takes them
    accept_rate: Tensor  # [R] per-replica HMC acceptance
    swap_rate: Tensor  # [R] fraction of accepted swaps per slot
    step_sizes: Tensor  # [R] adapted per-replica step sizes
    betas: Tensor  # [R] the ladder used
    mean: Optional[Tensor] = None  # [D] cold-replica streaming moments
    var: Optional[Tensor] = None
    kernel_used: str = "composed"  # HMC engine: "fused" | "composed"
    sampling_seconds: float = 0.0  # wall time of sampling, device-synced


def run_parallel_tempering(
    seed: int,
    potential_fn: Callable[[Tensor], Tensor],
    init_q,
    *,
    num_replicas: int = 8,
    betas=None,
    beta_min: float = 0.05,
    num_warmup: int = 200,
    num_samples: int = 500,
    num_steps: int = 10,
    init_step_size: float = 0.2,
    target_accept: float = 0.8,
    integrator: str = "leapfrog",
    mass: Union[float, Tensor] = 1.0,
    temperature: float = 1.0,
    constants: Constants = NATURAL,
    collect: str = "samples",
    kernel: str = "auto",
    mesh=None,
) -> PTResult:
    """Replica-exchange ensemble HMC.

    ``init_q``: ``[W, D]`` (copied to every replica) or ``[R, W, D]``.
    Samples or moments come from the cold replica (``betas[0]``, 1 by
    default). Per-replica step sizes adapt by dual averaging during
    warmup, swaps included; transition ``t`` (warmup first) uses key
    ``(seed, t)``. ``collect``: "samples" | "moments" | "none".
    ``kernel``: "auto" | "fused" | "composed" (:func:`build_pt_transition`).

    ``mesh``: a replica x walker group (``parallel.make_replica_mesh``) or
    a walker group. ``init_q`` is then the whole ensemble, the same on
    every rank, of which the rank takes its block
    (``parallel.shard_replicas``); R must be divisible by the replica
    shards and W by the walker shards. A warmup transition makes one
    all-reduce of the rank's rungs' acceptance over the walker sub-group
    (and the swap exchange of :func:`build_pt_transition`), a sampling
    transition only the exchange, and the end of the run one all-reduce
    over the group. The result's ``q``, ``u`` and ``g`` are the rank's
    block, ``samples`` the cold draws of its walkers where it holds rung 0
    (None elsewhere); the rates, step sizes and moments are the group's.
    """
    if collect not in ("samples", "moments", "none"):
        raise ValueError(f"bad collect={collect!r}")
    init_q = torch.as_tensor(init_q, device=resolve_device(
        None if mesh is None else mesh.device, init_q))
    dtype, device = init_q.dtype, init_q.device
    if betas is None:
        betas = geometric_ladder(num_replicas, beta_min, dtype, device)
    betas = torch.as_tensor(betas, dtype=dtype).to(device)
    num_replicas = betas.shape[0]
    if init_q.ndim == 2:
        init_q = init_q.expand((num_replicas,) + tuple(init_q.shape))
    if init_q.shape[0] != num_replicas:
        raise ValueError(
            f"init_q leading axis {init_q.shape[0]} != R={num_replicas}")
    rm = walkers = None
    if mesh is not None:
        rm = as_replica_mesh(mesh)
        walkers = rm.walkers
        q = shard_replicas(init_q, rm)
    else:
        q = init_q.contiguous()
    num_block, num_walkers, num_dims = q.shape
    holds_cold = rm is None or rm.replicas.rank == 0

    transition, kernel_used, vg = build_pt_transition(
        potential_fn, betas=betas, num_dims=num_dims, num_steps=num_steps,
        integrator=integrator, mass=mass, temperature=temperature,
        constants=constants, kernel=kernel, dtype=dtype, device=device,
        mesh=mesh)
    u, g = vg(q.reshape(-1, num_dims))
    u = u.reshape(num_block, num_walkers)
    g = g.reshape(q.shape)

    # ---- warmup: per-replica dual averaging ------------------------------
    step_sizes = torch.full((num_block,), init_step_size, dtype=dtype,
                            device=device)
    t = 0
    if num_warmup > 0:
        da = da_init(step_sizes)
        for i in range(num_warmup):
            q, u, g, acc, _ = transition((seed, t), q, u, g,
                                         torch.exp(da.log_step), i)
            t += 1
            # the rungs' acceptance over their walkers
            da = da_update(da, torch.mean(gather_rows(acc, walkers), dim=0),
                           target=target_accept)
        step_sizes = torch.exp(da.log_avg_step)

    # ---- sampling ----------------------------------------------------------
    mean = torch.zeros((num_dims,), dtype=dtype, device=device)
    m2 = torch.zeros((num_dims,), dtype=dtype, device=device)
    n = 0
    samples, accs, swapss = [], [], []
    _synchronize(device)
    t0 = _time.perf_counter()
    for i in range(num_samples):
        q, u, g, acc, swaps = transition((seed, t), q, u, g, step_sizes, i)
        t += 1
        accs.append(acc)
        swapss.append(swaps)
        cold = q[0]
        if not holds_cold:
            continue
        if collect == "samples":
            samples.append(cold.clone())
        elif collect == "moments":
            n_new = n + num_walkers
            batch_var, batch_mean = torch.var_mean(cold, dim=0,
                                                   correction=0)
            delta = batch_mean - mean
            mean = mean + delta * (num_walkers / n_new)
            m2 = (m2 + batch_var * num_walkers
                  + delta**2 * (n * num_walkers / n_new))
            n = n_new
    if num_samples:
        accept_rate = torch.mean(torch.stack(accs), dim=0)
        swap_rate = torch.mean(torch.stack(swapss), dim=0)
    else:  # as the JAX package: the mean of no transitions is NaN
        accept_rate = torch.full((num_block,), math.nan, dtype=dtype,
                                 device=device)
        swap_rate = accept_rate.clone()
    # the group's rates, step sizes and cold moments (this process's alone
    # without a mesh)
    rows = gather_rows(torch.cat((accept_rate, swap_rate, step_sizes, mean,
                                  m2)), rm)
    k_r, k_w = (1, 1) if rm is None else (rm.replicas.size, rm.walkers.size)
    shards, r_b = rows.reshape(k_r, k_w, -1), num_block
    accept_rate, swap_rate = (
        (torch.sum(shards[:, :, a:a + r_b], dim=1) / k_w).reshape(-1)
        for a in (0, r_b))
    step_sizes = shards[:, 0, 2 * r_b:3 * r_b].reshape(-1)
    n = num_walkers * num_samples if collect == "moments" else 0
    if n:
        mean, m2, n = _combine_moments(shards[0, :, 3 * r_b:], n, num_dims)
    _synchronize(device)
    sampling_seconds = _time.perf_counter() - t0

    out_samples = post_mean = post_var = None
    if collect == "samples" and holds_cold:
        out_samples = (torch.stack(samples) if samples else torch.empty(
            (0, num_walkers, num_dims), dtype=dtype, device=device))
    elif collect == "moments":
        post_mean = mean
        post_var = m2 / max(n - 1.0, 1.0)
    return PTResult(
        samples=out_samples, q=q, u=u, g=g, accept_rate=accept_rate,
        swap_rate=swap_rate, step_sizes=step_sizes, betas=betas,
        mean=post_mean, var=post_var, kernel_used=kernel_used,
        sampling_seconds=sampling_seconds)
