"""The No-U-Turn Sampler over the walker ensemble in lockstep (port of the
JAX package's ``nuts.py``, ``engine="lockstep"``).

A transition builds a doubling tree of leapfrog steps per walker with the
iterative checkpoint formulation (Phan & Pradhan): each subtree's U-turn
checks run against O(max_depth) stored left endpoints, and each visited
state is reservoir-sampled with weight ``exp(-beta (H - H0))``
(multinomial NUTS). All walkers take their leapfrog together as one
batched ``[W, D]`` update through ``batched_value_and_grad``; a walker
that has stopped (turned, diverged, or its subtree ended) is frozen by
masks while the ensemble finishes.

The leaf counter, the checkpoint pointer and ``m = ctz(i + 1)`` are shared
by all walkers, so here they are Python ints: the checkpoint stack
``[max_depth + 1, W, D]`` is indexed by host integers and allocated once a
transition. Only the loop conditions need the device, and ``_host_read``
counts each read:

* the outer one, ``any(~turned & ~divergent)``, once a doubling;
* the subtree's ``any(alive)``, read after leaves 1, 2, 4, 8, ... only
  (every leaf with ``read_every_leaf=True``). A leaf run after every walker
  has stopped changes no output: its updates are masked, and its draws
  come last from its doubling's own generator.

NUTS has no fused kernel: on CUDA it runs the potential's batched value
and gradient on the card. The per-walker ``engine="vmap"`` formulation of
the JAX package is not ported.

Randomness: transition ``key = (seed, t)`` draws its momenta from the
generator of that key, and doubling ``j`` its directions, merge uniforms
and leaf uniforms, in that order, from a generator of its own. On a walker
group (``mesh=``) every rank keys these generators alike and takes its
walkers' rows of each whole-ensemble draw, so a rank's trees are the
one-process trees of its walkers: a doubling or leaf that a rank skips
(its walkers have all stopped) changes none of its outputs, as above.
"""

from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Callable, Optional, Union

import torch

from .adaptation import (batch_terms, build_warmup_schedule, da_init,
                         da_update, merge_batch_terms, regularized_mass,
                         variance_init)
from .constants import Constants, NATURAL
from .device import resolve_device
from .ensemble import thermal_momentum_std
from .hmc import HMCState, _splitmix64, _step_generator, _synchronize, \
    init_state
from .ops.potentials import batched_value_and_grad
from .parallel.mesh import check_divisible, gather_rows

Tensor = torch.Tensor


@dataclasses.dataclass
class NUTSInfo:
    """Per-transition diagnostics (per walker)."""

    accept_prob: Tensor  # [W] mean Metropolis statistic over visited leaves
    depth: Tensor  # [W] tree depth reached
    num_leapfrogs: Tensor  # [W] leapfrog steps taken
    divergent: Tensor  # [W] bool
    turned: Tensor  # [W] bool (stopped by a U-turn, not max_depth)
    potential_energy: Tensor  # [W]
    step_size: Tensor  # scalar


def _uturn(q_left, p_left, q_right, p_right, inv_mass):
    """Hoffman-Gelman criterion on the endpoints ``[..., D]``, with
    inverse-mass-weighted momenta."""
    dq = q_right - q_left
    return ((torch.sum(dq * p_left * inv_mass, dim=-1) < 0.0)
            | (torch.sum(dq * p_right * inv_mass, dim=-1) < 0.0))


def _ctz(i: int) -> int:
    """Count of trailing zeros of a positive int."""
    return (i & -i).bit_length() - 1


def _host_read(flag: Tensor) -> bool:
    """A tree loop's read of its condition: on CUDA, a device-to-host
    read."""
    _host_read.reads += 1
    return bool(flag.item())


_host_read.reads = 0  # type: ignore[attr-defined]


def _doubling_generator(key, depth: int, device) -> torch.Generator:
    seed, counter = key
    return _step_generator((_splitmix64(seed) ^ (depth + 1), counter),
                           device)


@dataclasses.dataclass(frozen=True)
class NUTSKernel:
    """A built NUTS transition kernel."""

    init: Callable
    step: Callable
    max_depth: int


def _build_lockstep_nuts_kernel(
    potential_fn: Callable[[Tensor], Tensor],
    *,
    max_depth: int,
    temperature: float,
    constants: Constants,
    divergence_threshold: float,
    read_every_leaf: bool = False,
    mesh=None,
) -> NUTSKernel:
    """Walker-lockstep iterative NUTS (see :func:`build_nuts_kernel`);
    ``read_every_leaf`` reads the subtree's condition after every leaf (for
    the test that holds the sparse reads to it)."""
    beta = constants.beta(temperature)
    vg = batched_value_and_grad(potential_fn)
    num_slots = max_depth + 1

    def init(q, *, mass: Union[float, Tensor] = 1.0) -> HMCState:
        return init_state(vg, q, mass)

    def step(key, state: HMCState, step_size, mass: Optional[Tensor] = None):
        ens = state.ensemble
        if mass is None:
            mass = ens.mass
        w, d = ens.q.shape
        dtype, device = ens.q.dtype, ens.q.device
        mass = torch.as_tensor(mass, dtype=dtype, device=device)
        inv_mass = 1.0 / torch.broadcast_to(mass, (1, d))
        eps = torch.as_tensor(step_size, dtype=dtype, device=device)
        neg_inf = torch.full((w,), -math.inf, dtype=dtype, device=device)
        tiny = torch.finfo(dtype).tiny

        # a shard draws the rows of its walkers from the whole ensemble's
        # draw, so its trees are the one-process trees of those walkers
        rows = slice(None) if mesh is None else slice(
            mesh.rank * w, (mesh.rank + 1) * w)
        total = w if mesh is None else w * mesh.size

        def draw(fn, gen, *rest):
            return fn((total, *rest), generator=gen, dtype=dtype,
                      device=device)[rows]

        p_std = thermal_momentum_std(mass, temperature, constants)
        p0 = p_std * draw(torch.randn, _step_generator(key, device), d)
        q0, u0, g0 = ens.q, state.potential_energy, state.grad

        def ke(p):
            return 0.5 * torch.sum(p * p * inv_mass, dim=-1)

        h0 = ke(p0) + u0
        # the left endpoints of the open subtrees, indexed by the shared
        # pointer
        ckpt_q = torch.empty((num_slots, w, d), dtype=dtype, device=device)
        ckpt_p = torch.empty_like(ckpt_q)

        def subtree(gen, depth, q, p, g, dirn, alive):
            """One doubling of up to 2^depth leaves, all walkers together."""
            u = torch.zeros((w,), dtype=dtype, device=device)
            logw = neg_inf
            prop_q, prop_u, prop_g = q, torch.zeros_like(u), g
            turned = torch.zeros((w,), dtype=torch.bool, device=device)
            div = torch.zeros_like(turned)
            sum_acc = torch.zeros_like(u)
            n_leap = torch.zeros((w,), dtype=torch.int32, device=device)
            dt = dirn * eps
            ptr = 0
            for i in range(1 << depth):
                if (i > 0 and (read_every_leaf or i & (i - 1) == 0)
                        and not _host_read(torch.any(alive))):
                    break
                p_half = p - 0.5 * dt * g
                q_new = q + dt * p_half * inv_mass
                u_new, g_new = vg(q_new)
                p_new = p_half - 0.5 * dt * g_new

                derr = beta * (ke(p_new) + u_new - h0)
                derr = torch.where(torch.isfinite(derr), derr, torch.inf)
                div_leaf = alive & (derr > divergence_threshold)
                sum_acc = sum_acc + torch.where(
                    alive, torch.exp(torch.clamp_max(-derr, 0.0)), 0.0)
                logw_leaf = torch.where(alive & ~div_leaf, -derr, neg_inf)
                logw_new = torch.logaddexp(logw, logw_leaf)
                uni = draw(torch.rand, gen)
                take = alive & (torch.log(torch.clamp_min(uni, tiny))
                                < logw_leaf - logw_new)
                prop_q = torch.where(take[:, None], q_new, prop_q)
                prop_u = torch.where(take, u_new, prop_u)
                prop_g = torch.where(take[:, None], g_new, prop_g)

                if i % 2 == 0:  # push a left endpoint
                    ckpt_q[ptr] = q_new
                    ckpt_p[ptr] = p_new
                    ptr += 1
                else:  # check the m subtrees this leaf closes
                    m = _ctz(i + 1)
                    for j in range(1, m + 1):
                        dq = dirn * (q_new - ckpt_q[ptr - j])
                        t = ((torch.sum(dq * ckpt_p[ptr - j] * inv_mass,
                                        dim=-1) < 0.0)
                             | (torch.sum(dq * p_new * inv_mass,
                                          dim=-1) < 0.0))
                        turned = turned | (alive & t)
                    ptr -= m - 1

                upd = alive[:, None]  # walkers active at this leaf move
                q = torch.where(upd, q_new, q)
                p = torch.where(upd, p_new, p)
                g = torch.where(upd, g_new, g)
                u = torch.where(alive, u_new, u)
                logw = logw_new
                div = div | div_leaf
                n_leap = n_leap + alive.to(torch.int32)
                alive = alive & ~div_leaf & ~turned
            return dict(q=q, p=p, g=g, logw=logw, prop_q=prop_q,
                        prop_u=prop_u, prop_g=prop_g, turned=turned,
                        div=div, sum_acc=sum_acc, n_leap=n_leap)

        qL = qR = q0
        pL = pR = p0
        gL = gR = g0
        prop_q, prop_u, prop_g = q0, u0, g0
        logw = torch.zeros((w,), dtype=dtype, device=device)
        turned = torch.zeros((w,), dtype=torch.bool, device=device)
        div = torch.zeros_like(turned)
        sum_acc = torch.zeros((w,), dtype=dtype, device=device)
        n_leap = torch.zeros((w,), dtype=torch.int32, device=device)
        depth_r = torch.zeros_like(n_leap)
        depth = 0
        while depth < max_depth and _host_read(torch.any(~turned & ~div)):
            gen = _doubling_generator(key, depth, device)
            act = ~turned & ~div
            go_right = draw(torch.rand, gen) < 0.5
            merge_u = draw(torch.rand, gen)
            dirn = torch.where(go_right, 1.0, -1.0).to(dtype)[:, None]
            gr = go_right[:, None]
            sub = subtree(gen, depth, torch.where(gr, qR, qL),
                          torch.where(gr, pR, pL), torch.where(gr, gR, gL),
                          dirn, act)
            ok = act & ~sub["turned"] & ~sub["div"]

            logw_tree = torch.logaddexp(logw, sub["logw"])
            take = ok & (merge_u < torch.exp(sub["logw"] - logw_tree))
            prop_q = torch.where(take[:, None], sub["prop_q"], prop_q)
            prop_u = torch.where(take, sub["prop_u"], prop_u)
            prop_g = torch.where(take[:, None], sub["prop_g"], prop_g)
            logw = torch.where(ok, logw_tree, logw)

            left, right = ok[:, None] & ~gr, ok[:, None] & gr
            qL = torch.where(left, sub["q"], qL)
            pL = torch.where(left, sub["p"], pL)
            gL = torch.where(left, sub["g"], gL)
            qR = torch.where(right, sub["q"], qR)
            pR = torch.where(right, sub["p"], pR)
            gR = torch.where(right, sub["g"], gR)

            turned = (turned | (act & sub["turned"])
                      | (ok & _uturn(qL, pL, qR, pR, inv_mass)))
            div = div | (act & sub["div"])
            sum_acc = sum_acc + sub["sum_acc"]
            n_leap = n_leap + sub["n_leap"]
            depth_r = torch.where(act, depth + 1, depth_r)
            depth += 1

        n = torch.clamp_min(n_leap, 1).to(dtype)
        new_state = HMCState(
            ensemble=ens.replace(q=prop_q, mass=mass),
            potential_energy=prop_u, grad=prop_g)
        info = NUTSInfo(
            accept_prob=sum_acc / n, depth=depth_r, num_leapfrogs=n_leap,
            divergent=div, turned=turned, potential_energy=prop_u,
            step_size=eps)
        return new_state, info

    return NUTSKernel(init=init, step=step, max_depth=max_depth)


def build_nuts_kernel(
    potential_fn: Callable[[Tensor], Tensor],
    *,
    max_depth: int = 8,
    temperature: float = 1.0,
    constants: Constants = NATURAL,
    divergence_threshold: float = 1000.0,
    engine: str = "lockstep",
    mesh=None,
) -> NUTSKernel:
    """A NUTS transition kernel with the interface of
    :func:`~.hmc.build_hmc_kernel`: ``init(q, mass=) -> HMCState``,
    ``step(key, state, step_size, mass=None) -> (HMCState, NUTSInfo)``,
    ``key = (seed, t)``.

    Only ``engine="lockstep"`` is ported: every walker advances one
    leapfrog per iteration as one ``[W, D]`` update, and the tree's control
    flow is shared (module docstring). ``mesh``: a walker group; a step
    then takes the rank's block of the ensemble (module docstring)."""
    if engine == "vmap":
        raise ValueError(
            "engine='vmap' (one tree per walker) is not ported; use "
            "engine='lockstep'")
    if engine != "lockstep":
        raise ValueError(f"bad engine={engine!r} (want lockstep)")
    return _build_lockstep_nuts_kernel(
        potential_fn, max_depth=max_depth, temperature=temperature,
        constants=constants, divergence_threshold=divergence_threshold,
        mesh=mesh)


@dataclasses.dataclass
class NUTSRunResult:
    """Output of :func:`run_nuts`."""

    state: HMCState
    samples: Optional[Tensor]  # [S, W, D] if collect="samples"
    accept_rate: Tensor
    divergence_rate: Tensor
    mean_depth: Tensor
    step_size: Tensor
    mass: Tensor
    sampling_seconds: float = 0.0  # wall time of sampling, device-synced


def run_nuts(
    seed: int,
    potential_fn: Callable[[Tensor], Tensor],
    init_q,
    *,
    num_warmup: int,
    num_samples: int,
    max_depth: int = 8,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    adapt_mass: bool = True,
    mass: Union[float, Tensor] = 1.0,
    temperature: float = 1.0,
    constants: Constants = NATURAL,
    collect: str = "samples",
    mesh=None,
) -> NUTSRunResult:
    """Dual-averaging warmup with the cross-walker diagonal metric (the
    windows of :func:`~.adaptation.build_warmup_schedule`), then sampling
    with the lockstep NUTS kernel. Transition ``t`` (warmup first) uses key
    ``(seed, t)``. ``collect``: "samples" | "none".

    ``mesh``: a walker group. ``init_q`` is then the whole ensemble, the
    same on every rank, of which the rank takes its block; each rank
    builds the trees of its own walkers (the module docstring's draws), so
    no rank waits on another inside a transition. A warmup transition
    makes one all-reduce (the acceptance and, in a metric window, the
    variance's batch terms, merged rank by rank), a sampling transition
    none, the end of sampling one. Scalars are the group's; the state and
    samples are the rank's block."""
    if collect not in ("samples", "none"):
        raise ValueError(f"bad collect={collect!r} (want samples|none)")
    kernel = build_nuts_kernel(potential_fn, max_depth=max_depth,
                               temperature=temperature, constants=constants,
                               mesh=mesh)
    q = torch.as_tensor(init_q, device=resolve_device(
        None if mesh is None else mesh.device, init_q))
    if mesh is not None:
        check_divisible(q.shape[0], mesh)
        q = q[mesh.block(q.shape[0])].to(mesh.device).contiguous()
    state = kernel.init(q, mass=mass)
    num_dims = state.ensemble.num_dims
    dtype, device = q.dtype, q.device

    step_size = torch.full((), init_step_size, dtype=dtype, device=device)
    mass_arr = torch.broadcast_to(
        torch.as_tensor(mass, dtype=dtype, device=device), (num_dims,))
    t = 0
    for seg in build_warmup_schedule(num_warmup, adapt_mass=adapt_mass):
        da = da_init(step_size)
        track_var = seg.update_mass and adapt_mass
        varst = variance_init(num_dims, dtype, device)
        for _ in range(seg.length):
            state, info = kernel.step((seed, t), state,
                                      torch.exp(da.log_step))
            t += 1
            # every rank's mean and batch terms, merged in rank order
            accept = torch.mean(info.accept_prob).reshape(1)
            rows = gather_rows(torch.cat((accept, *batch_terms(
                state.ensemble.q))) if track_var else accept, mesh)
            if track_var:
                varst = merge_batch_terms(varst, rows[:, 1:])
            da = da_update(da, torch.mean(rows[:, 0]), target=target_accept)
        step_size = torch.exp(da.log_avg_step)
        if track_var:
            mass_arr = 1.0 / regularized_mass(varst)
            state = state.replace(
                ensemble=state.ensemble.replace(mass=mass_arr))

    samples, accs, divs, depths = [], [], [], []
    _synchronize(device)
    t0 = _time.perf_counter()
    for _ in range(num_samples):
        state, info = kernel.step((seed, t), state, step_size)
        t += 1
        if collect == "samples":
            samples.append(state.ensemble.q)
        accs.append(torch.mean(info.accept_prob))
        divs.append(torch.mean(info.divergent.to(dtype)))
        depths.append(torch.mean(info.depth.to(dtype)))

    def mean_of(xs):
        if not xs:  # as the JAX package: the mean of no transitions is NaN
            return torch.full((), math.nan, dtype=dtype, device=device)
        return torch.mean(torch.stack(xs))

    # the group's rates (this process's alone without a mesh)
    rows = gather_rows(torch.stack((mean_of(accs), mean_of(divs),
                                    mean_of(depths))), mesh)
    accept_rate, divergence_rate, mean_depth = (torch.sum(rows, dim=0)
                                                / rows.shape[0])
    _synchronize(device)
    sampling_seconds = _time.perf_counter() - t0
    out_samples = None
    if collect == "samples":
        out_samples = (torch.stack(samples) if samples else torch.empty(
            (0,) + tuple(q.shape), dtype=dtype, device=device))
    return NUTSRunResult(
        state=state, samples=out_samples, accept_rate=accept_rate,
        divergence_rate=divergence_rate, mean_depth=mean_depth,
        step_size=step_size, mass=mass_arr,
        sampling_seconds=sampling_seconds)
