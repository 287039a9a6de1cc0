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
``device_form``) that is one launch of kernel A or B per replica, on the
replica's contiguous ``[W, D]`` slice, with its beta, step size and
thermal momentum std ``sqrt(m / beta)`` read from the device; the
composed engine integrates all R x W walkers as one batch. Neither the sweep,
the swaps nor the warmup's dual averaging reads the device, so the
warmup and sampling loops never synchronise.

Randomness: transition ``t`` of a run keyed ``seed`` sweeps replica ``r``
on the fused engine with the Philox key ``(_replica_seed(seed, r), t)``,
on the composed engine from the generator of ``(seed, t)``, and draws its
swap uniforms from the generator of ``(splitmix64(seed), t)``.
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
from .ensemble import EnsembleState
from .hmc import (FusedTransition, HMCState, _splitmix64, _step_generator,
                  _synchronize, resolve_engine)
from .ops.integrators import get_integrator
from .ops.potentials import batched_value_and_grad

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
    num_replicas = q.shape[0]
    r_idx = torch.arange(num_replicas, device=q.device)
    delta = ((beta_eff - beta_eff[partner])[:, None]
             * (u - u[partner]))  # [R, W]
    log_uni = torch.log(torch.clamp_min(uniform,
                                        torch.finfo(uniform.dtype).tiny))
    log_uni = log_uni[torch.minimum(r_idx, partner)]
    do = (log_uni < delta) & (partner != r_idx)[:, None]
    sel = do[:, :, None]
    return (torch.where(sel, q[partner], q), torch.where(do, u[partner], u),
            torch.where(sel, g[partner], g), torch.mean(do.to(q.dtype), 1))


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
):
    """The replica-exchange transition, shared by
    :func:`run_parallel_tempering` and a checkpointing driver:

        transition(key, q[R,W,D], u[R,W], g[R,W,D], step_sizes[R], i)
            -> (q, u, g, accept[R], swap_rate[R])

    with ``key = (seed, t)`` and ``i`` the counter whose parity picks the
    swap pairs. ``kernel``: "auto" | "fused" | "composed", decided by
    ``hmc.resolve_engine`` for ``device`` (where the walkers live).

    Returns ``(transition, kernel_used, vg)``.
    """
    device = resolve_device(device, betas)
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
    partners = tuple(torch.as_tensor(t, device=device)
                     for t in _partner_tables(num_replicas))
    fused = (FusedTransition(potential_fn, temperature=temperature,
                             constants=constants)
             if engine == "fused" else None)

    def composed_sweep(key, q, u, g, step_sizes):
        """One composed HMC transition of every replica, all R x W walkers
        as one batch: unscaled potential, replica r's momenta thermal at
        its beta_r (std sqrt(m / beta_r)), accepted with exp(-beta_r dH)."""
        _, w, d = q.shape
        gen = _step_generator(key, q.device)
        p0 = torch.sqrt(mass / beta_eff[:, None, None]) * torch.randn(
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
        derr = beta_eff[:, None] * (h1 - h0)
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
        """The same statistics in one launch of kernel A or B per replica,
        on its contiguous [W, D] slice, with beta_r as the kernel's beta
        and the momenta thermal at it."""
        seed, t = key
        outs = []
        for r in range(num_replicas):
            # a fused transition reads neither p nor log_weight: q and u
            # stand in for them, so a sweep allocates nothing beside its
            # outputs
            state = HMCState(
                ensemble=EnsembleState(q=q[r], p=q[r], mass=mass,
                                       log_weight=u[r]),
                potential_energy=u[r], grad=g[r])
            new, info, _ = fused((_replica_seed(seed, r), t), state,
                                 step_sizes[r], num_steps=num_steps,
                                 beta=beta_eff[r])
            outs.append((new.ensemble.q, new.potential_energy, new.grad,
                         torch.mean(info.accept_prob)))
        return tuple(torch.stack(x) for x in zip(*outs))

    sweep = composed_sweep if fused is None else fused_sweep

    def transition(key, q, u, g, step_sizes, i):
        q, u, g, acc = sweep(key, q, u, g, step_sizes)
        seed, t = key
        uniform = torch.rand(q.shape[:2], generator=_step_generator(
            (_splitmix64(seed), t), q.device), dtype=q.dtype,
            device=q.device)
        q, u, g, swaps = swap_phase(q, u, g, beta_eff, partners[i % 2],
                                    uniform)
        return q, u, g, acc, swaps

    return transition, engine, vg


@dataclasses.dataclass
class PTResult:
    """Output of :func:`run_parallel_tempering`."""

    samples: Optional[Tensor]  # [S, W, D] cold-replica draws
    q: Tensor  # [R, W, D] final replica positions
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
) -> PTResult:
    """Replica-exchange ensemble HMC.

    ``init_q``: ``[W, D]`` (copied to every replica) or ``[R, W, D]``.
    Samples or moments come from the cold replica (``betas[0]``, 1 by
    default). Per-replica step sizes adapt by dual averaging during
    warmup, swaps included; transition ``t`` (warmup first) uses key
    ``(seed, t)``. ``collect``: "samples" | "moments" | "none".
    ``kernel``: "auto" | "fused" | "composed" (:func:`build_pt_transition`).
    """
    if collect not in ("samples", "moments", "none"):
        raise ValueError(f"bad collect={collect!r}")
    init_q = torch.as_tensor(init_q, device=resolve_device(None, init_q))
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
    q = init_q.contiguous()
    _, num_walkers, num_dims = q.shape

    transition, kernel_used, vg = build_pt_transition(
        potential_fn, betas=betas, num_dims=num_dims, num_steps=num_steps,
        integrator=integrator, mass=mass, temperature=temperature,
        constants=constants, kernel=kernel, dtype=dtype, device=device)
    u, g = vg(q.reshape(-1, num_dims))
    u = u.reshape(num_replicas, num_walkers)
    g = g.reshape(q.shape)

    # ---- warmup: per-replica dual averaging ------------------------------
    step_sizes = torch.full((num_replicas,), init_step_size, dtype=dtype,
                            device=device)
    t = 0
    if num_warmup > 0:
        da = da_init(step_sizes)
        for i in range(num_warmup):
            q, u, g, acc, _ = transition((seed, t), q, u, g,
                                         torch.exp(da.log_step), i)
            t += 1
            da = da_update(da, acc, target=target_accept)
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
        accept_rate = torch.full((num_replicas,), math.nan, dtype=dtype,
                                 device=device)
        swap_rate = accept_rate.clone()
    _synchronize(device)
    sampling_seconds = _time.perf_counter() - t0

    out_samples = post_mean = post_var = None
    if collect == "samples":
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
