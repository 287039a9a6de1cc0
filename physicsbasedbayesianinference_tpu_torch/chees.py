"""ChEES-HMC: ensemble-native trajectory-length adaptation (port of the JAX
package's ``chees.py``; Hoffman, Radul & Sountsov, AISTATS 2021).

* Each transition integrates for a jittered time ``t = 2 h_t tau``, ``h_t``
  a quasi-random Halton draw (jitter breaks the resonances of fixed-length
  HMC); every walker takes the same ``clip(round(t / eps), 1, max_steps)``
  leapfrog steps.
* Warmup maximises the ChEES criterion ``E[(|q' - E q'|^2 - |q - E q|^2)^2]
  / 4`` by Adam on ``log tau`` with the paper's per-transition gradient
  estimator (accept-probability-weighted cross-walker means), beside the
  dual-averaging step size and the cross-walker diagonal metric.
* Sampling keeps the adapted ``tau`` and goes on jittering.

Two engines, chosen per phase when the run is built (never after a
failure), as ``run_hmc`` chooses:

* fused (:func:`build_fused_jittered_step`): one CUDA launch a transition.
  The leapfrog count is computed on the device and handed to the kernel as
  a device tensor, and warmup takes the kernel's proposal outputs, so
  neither loop reads anything back to the host.
* composed (:func:`build_jittered_hmc_kernel`): torch operations per
  leapfrog step, for any potential on any device; the CPU oracle. Its
  ``while`` over a count that lives on the device needs the host: one read
  of the count a transition.

Transition ``t`` of a run uses key ``(seed, t)``; all adaptation state (dual
averaging, Adam on log tau, the Welford variance, the Halton draws) is
tensors on the state's device.
"""

from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Callable, Optional, Union

import numpy as np
import torch

from .adaptation import (
    batch_terms,
    build_warmup_schedule,
    da_init,
    da_update,
    merge_batch_terms,
    regularized_mass,
    variance_init,
)
from .constants import Constants, NATURAL
from .device import resolve_device
from .ensemble import thermal_momentum_std
from .hmc import (
    FusedTransition,
    HMCState,
    StepKey,
    _combine_moments,
    _step_generator,
    _synchronize,
    init_state,
    metropolis_select,
    resolve_engine,
)
from .ops.potentials import batched_value_and_grad
from .parallel.mesh import check_divisible, gather_rows

Tensor = torch.Tensor

# the leapfrog count's clip, unless the caller gives one
DEFAULT_MAX_STEPS = 1024


def halton_sequence(length: int, base: int = 2) -> np.ndarray:
    """Van der Corput / Halton quasi-random sequence in (0, 1)."""
    out = np.zeros((length,), np.float32)
    for i in range(length):
        f, r, n = 1.0, 0.0, i + 1
        while n > 0:
            f /= base
            r += f * (n % base)
            n //= base
        out[i] = r
    return out


@dataclasses.dataclass
class ChEESAdaptState:
    """Adam state for log-tau ascent on the ChEES criterion."""

    log_tau: Tensor
    m: Tensor
    v: Tensor
    count: Tensor


def chees_init(init_tau, dtype=torch.float32, device=None) -> ChEESAdaptState:
    """Adam at ``init_tau`` (a float, or a 0-d tensor whose device the
    state takes; a float goes to ``device`` or the default device)."""
    log_tau = torch.log(torch.as_tensor(
        init_tau, dtype=dtype, device=resolve_device(device, init_tau)))
    z = torch.zeros_like(log_tau)
    return ChEESAdaptState(log_tau=log_tau, m=z, v=z, count=z)


def chees_update(st: ChEESAdaptState, grad: Tensor, *,
                 lr: float = 0.025, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8) -> ChEESAdaptState:
    """One Adam ascent step on log tau (``grad`` is d ChEES / d log tau; a
    non-finite one counts as zero)."""
    grad = torch.where(torch.isfinite(grad), grad, 0.0)
    count = st.count + 1.0
    m = b1 * st.m + (1.0 - b1) * grad
    v = b2 * st.v + (1.0 - b2) * grad * grad
    m_hat = m / (1.0 - b1**count)
    v_hat = v / (1.0 - b2**count)
    log_tau = st.log_tau + lr * m_hat / (torch.sqrt(v_hat) + eps)
    return ChEESAdaptState(log_tau=log_tau, m=m, v=v, count=count)


def steps_for(tau: Tensor, halton: Tensor, step_size: Tensor,
              max_steps: int) -> Tensor:
    """The leapfrog count of a transition of jittered time ``2 h tau``:
    ``clip(round(2 h tau / eps), 1, max_steps)`` as an int32 tensor ``[1]``
    on the inputs' device, with no host read."""
    t = 2.0 * halton * tau
    return torch.clamp(torch.round(t / step_size), 1,
                       max_steps).to(torch.int32).reshape(1)


def _host_count(num_steps, max_steps: int) -> int:
    """The composed step's read of the leapfrog count: for a count on a
    CUDA device this is the route's one device-to-host read a
    transition."""
    _host_count.reads += 1
    n = int(num_steps.reshape(()).item()) if isinstance(
        num_steps, Tensor) else int(num_steps)
    return min(max(n, 1), max_steps)


_host_count.reads = 0  # type: ignore[attr-defined]


def build_jittered_hmc_kernel(
    potential_fn: Callable[[Tensor], Tensor],
    *,
    max_steps: int = DEFAULT_MAX_STEPS,
    temperature: float = 1.0,
    constants: Constants = NATURAL,
    divergence_threshold: float = 1000.0,
):
    """The composed HMC transition with a per-call leapfrog count:
    ``(init, step)`` with ``step(key, state, step_size, num_steps,
    mass=None) -> (state', info, (q1, p1))``, the proposal being the
    pre-accept endpoint with its momentum flipped, which the ChEES gradient
    estimator needs. ``num_steps`` is a 0-dim or one-element int tensor (or
    an int), clipped to ``[1, max_steps]``.

    What it costs on CUDA: a Python loop over a count that lives on the
    device needs the count on the host, so every transition reads it back
    once (``_host_count``, which counts its reads) and waits for the
    device; beside that, some ten small kernels a leapfrog step. It is the
    route for potentials without a device form, and the CPU oracle.

    ``step`` also takes ``momentum=`` ``[W, D]`` and ``uniform=`` ``[W]``
    in place of its own draws, for tests that hold it against another
    implementation."""
    vg = batched_value_and_grad(potential_fn)
    beta = constants.beta(temperature)

    def init(q, *, mass: Union[float, Tensor] = 1.0) -> HMCState:
        return init_state(vg, q, mass)

    def step(key: StepKey, state: HMCState, step_size, num_steps,
             mass: Optional[Tensor] = None, *,
             momentum: Optional[Tensor] = None,
             uniform: Optional[Tensor] = None):
        ens = state.ensemble
        if mass is None:
            mass = ens.mass
        q = ens.q
        gen = _step_generator(key, q.device)
        p0 = momentum
        if p0 is None:
            p_std = thermal_momentum_std(mass, temperature, constants)
            p0 = p_std * torch.randn(q.shape, generator=gen, dtype=q.dtype,
                                     device=q.device)
        inv_mass = 1.0 / mass
        p, u, g = p0, state.potential_energy, state.grad
        for _ in range(_host_count(num_steps, max_steps)):
            p = p - 0.5 * step_size * g
            q = q + step_size * p * inv_mass
            u, g = vg(q)
            p = p - 0.5 * step_size * g
        if uniform is None:
            uniform = torch.rand(q.shape[:1], generator=gen, dtype=q.dtype,
                                 device=q.device)
        new_state, info = metropolis_select(
            state, p0, mass, (q, -p, u, g), beta=beta,
            divergence_threshold=divergence_threshold, uniform=uniform,
            step_size=step_size)
        return new_state, info, (q, -p)

    return init, step


def build_fused_jittered_step(
    potential_fn: Callable[[Tensor], Tensor],
    *,
    num_dims: int,
    max_steps: int = DEFAULT_MAX_STEPS,
    temperature: float = 1.0,
    constants: Constants = NATURAL,
    divergence_threshold: float = 1000.0,
    emit_proposal: bool = False,
):
    """The fused jittered transition: ``step(key, state, step_size,
    num_steps, mass=None, walker_offset=0) -> (state', info)`` or, with
    ``emit_proposal``, ``-> (state', info, (q1, p1))`` as the composed
    step's; ``walker_offset`` is the global index of the state's first
    walker (a walker shard's, ``parallel.shard_map_kernel``).

    One launch a transition: kernel A for a potential with
    ``diag_quadratic`` (kernel B's diagonal form where the proposal is
    asked for, since kernel A has no proposal outputs), kernel B for one
    with a ``device_form``. ``num_steps`` is an int32 tensor ``[1]`` on the
    state's device (:func:`steps_for`); the kernel reads it there and clips
    it to ``[1, max_steps]``, so nothing is read back. Raises at once for
    a potential that no kernel takes at ``num_dims``
    (``hmc.resolve_engine`` says so before a run is built)."""
    fused = FusedTransition(
        potential_fn, temperature=temperature, constants=constants,
        divergence_threshold=divergence_threshold)
    if fused.variant_for(1, num_dims) == "composed":
        raise ValueError(
            f"no fused kernel takes this potential at D={num_dims}: it has "
            f"no diag_quadratic and no usable device_form")

    def step(key: StepKey, state: HMCState, step_size, num_steps,
             mass: Optional[Tensor] = None, *, walker_offset: int = 0):
        if not isinstance(num_steps, Tensor):
            raise ValueError("the fused jittered step takes its leapfrog "
                             "count as an int32 tensor (steps_for)")
        new_state, info, proposal = fused(
            key, state, step_size, mass,
            num_steps=num_steps.reshape(1).to(torch.int32),
            max_steps=max_steps, emit_proposal=emit_proposal,
            walker_offset=walker_offset)
        if emit_proposal:
            return new_state, info, proposal
        return new_state, info

    return step


def chees_gradient(q0: Tensor, q1: Tensor, p1: Tensor, accept_prob: Tensor,
                   halton, inv_mass) -> Tensor:
    """The ChEES-HMC d/d(log tau) estimator (Hoffman et al. 2021, eq. 8),
    accept-weighted over walkers:

        g = E_w[ (|q1 - q1bar|^2 - |q0 - q0bar|^2) * ((q1 - q1bar) . v1) ]
            * h_t

    with v1 the end-point velocity and centred means taken over the
    ensemble."""
    return _chees_gradient(q0, q1, p1, accept_prob, halton, inv_mass,
                           None)[0]


def _chees_gradient(q0, q1, p1, accept_prob, halton, inv_mass, mesh,
                    extra=()):
    """:func:`chees_gradient` over the ranks of ``mesh`` (None: this
    process alone), and the ranks' rows of the vectors ``extra`` joined,
    which ride in the first of the two gathers: ``(g, [K, sum of their
    lengths])``. The sums are taken on each rank and summed over the ranks
    in rank order, so one rank's are its own bit for bit. The second
    gather waits on the first: the gradient's sums need the group's
    centres of this transition's proposal."""
    d = q0.shape[1]
    # every rank holds as many walkers (parallel.mesh.check_divisible)
    num = q0.shape[0] * (1 if mesh is None else mesh.size)
    w = accept_prob + 1e-8
    got = gather_rows(torch.cat((
        torch.sum(q0, dim=0), torch.sum(w[:, None] * q1, dim=0),
        torch.sum(w).reshape(1), *extra)), mesh)
    sums = torch.sum(got[:, :2 * d + 1], dim=0)
    wsum = sums[2 * d]
    q0c = q0 - sums[:d] / num
    q1c = q1 - sums[d:2 * d] / wsum
    a = torch.sum(q1c * q1c, dim=-1) - torch.sum(q0c * q0c, dim=-1)
    # -p1 undoes the momentum flip: the velocity in the forward direction
    b = torch.sum(q1c * (-p1 * inv_mass), dim=-1)
    second = torch.sum(gather_rows(torch.stack((
        torch.sum(w * a * b), torch.sum(a * a), torch.sum(b * b))), mesh),
        dim=0)
    g = second[0] / wsum
    # scale-free across targets (the sign is what matters)
    scale = torch.sqrt((second[1] / num) * (second[2] / num)) + 1e-10
    return halton * g / scale, got[:, 2 * d + 1:]


@dataclasses.dataclass
class ChEESRunResult:
    state: HMCState
    samples: Optional[Tensor]   # [S, W, D]
    mean: Optional[Tensor]
    var: Optional[Tensor]
    accept_rate: Tensor
    divergence_rate: Tensor
    step_size: Tensor
    trajectory_time: Tensor     # adapted tau
    mean_num_steps: Tensor
    kernel_used: str = "composed"  # sampling engine: "fused" | "composed"
    # warmup engine: "fused" | "composed" | "none" (no warmup)
    warmup_kernel_used: str = "composed"
    warmup_seconds: float = 0.0    # wall time of each phase, device-synced
    sampling_seconds: float = 0.0


def run_chees_hmc(
    seed: int,
    potential_fn: Callable[[Tensor], Tensor],
    init_q,
    *,
    num_warmup: int,
    num_samples: int,
    init_step_size: float = 0.1,
    init_tau: float = 1.0,
    max_steps: int = DEFAULT_MAX_STEPS,
    target_accept: float = 0.8,
    adapt_lr: float = 0.025,
    adapt_mass: bool = True,
    mass: Union[float, Tensor] = 1.0,
    temperature: float = 1.0,
    constants: Constants = NATURAL,
    collect: str = "samples",
    kernel: str = "auto",
    mesh=None,
) -> ChEESRunResult:
    """Warmup (dual-averaging step size, ChEES trajectory time and the
    diagonal metric together) then sampling with Halton-jittered trajectory
    lengths ``t = 2 h tau``.

    ``kernel``: ``"auto" | "fused" | "composed"`` as in ``run_hmc``
    (``hmc.resolve_engine``; ``"fused"`` raises where it cannot run),
    applied per phase. Sampling runs fused where the state is float32 on a
    CUDA device and the potential has ``diag_quadratic`` or a usable
    ``device_form``. Warmup then runs fused too, through the kernel's
    proposal outputs, except that ``"auto"`` keeps the warmup of a
    diag-quadratic target composed: the JAX package's rule, kept for
    parity. ``"fused"`` forces both phases fused, ``"composed"`` both
    composed. The target distribution is the same either way; the fused
    engine draws from the Philox stream, the composed one from a
    ``torch.Generator``.

    ``mesh``: a walker group (``parallel.make_walker_mesh``). ``init_q`` is
    then the whole ensemble, the same on every rank, of which the rank
    takes its block (W divisible by the group's size). A fused step draws
    by global walker index, a composed one with the rank folded into its
    seed (``parallel.shard_map_kernel``'s rule). The warmup's ensemble
    statistics are the group's: the acceptance, the variance's batch terms
    (merged rank by rank) and the gradient's centring sums ride in one
    all-reduce a transition, the gradient's own sums in a second. Every
    rank thus adapts the same step size, tau and metric, draws the same
    Halton count, and a sampling transition makes no collective; the end
    of sampling makes one (the rates and the streamed moments). Scalars
    and moments are the group's; the state and samples are the rank's
    block.
    """
    if collect not in ("samples", "moments", "none"):
        raise ValueError(f"bad collect={collect!r}")
    q = torch.as_tensor(init_q, device=resolve_device(
        None if mesh is None else mesh.device, init_q))
    if mesh is not None:
        from .parallel.sharded import fold_rank
        check_divisible(q.shape[0], mesh)
        q = q[mesh.block(q.shape[0])].to(mesh.device).contiguous()
    engine = resolve_engine(kernel, potential_fn, q)
    init_fn, step_fn = build_jittered_hmc_kernel(
        potential_fn, max_steps=max_steps, temperature=temperature,
        constants=constants)
    state = init_fn(q, mass=mass)
    num_walkers, num_dims = state.ensemble.q.shape
    dtype, device = q.dtype, q.device
    fused_step = fused_warm_step = None
    if engine == "fused":
        build = dict(num_dims=num_dims, max_steps=max_steps,
                     temperature=temperature, constants=constants)
        fused_step = build_fused_jittered_step(potential_fn, **build)
        warm_fused_wanted = (
            kernel == "fused"
            or getattr(potential_fn, "diag_quadratic", None) is None)
        if num_warmup > 0 and warm_fused_wanted:
            fused_warm_step = build_fused_jittered_step(
                potential_fn, emit_proposal=True, **build)
    # a shard draws as the rank's part of the whole ensemble
    offset = 0 if mesh is None else mesh.rank * num_walkers
    composed_seed = seed if mesh is None else fold_rank(seed, mesh.rank)

    def fused(step, t, *args):
        return step((seed, t), *args, walker_offset=offset)

    def composed(t, *args):
        return step_fn((composed_seed, t), *args)

    halton_all = torch.as_tensor(
        halton_sequence(num_warmup + num_samples)).to(device=device,
                                                      dtype=dtype)

    # ---- warmup: step size, tau and the diagonal metric together -----------
    # The segments of run_hmc's schedule: dual averaging and Adam on log tau
    # run inside each; between segments the cross-walker variance refreshes
    # the diagonal mass.
    step_size = torch.full((), init_step_size, dtype=dtype, device=device)
    tau = torch.full((), init_tau, dtype=dtype, device=device)
    t = 0
    _synchronize(device)
    t0 = _time.perf_counter()
    for seg in build_warmup_schedule(num_warmup, adapt_mass=adapt_mass):
        da = da_init(step_size)
        ch = chees_init(tau, dtype)
        varst = variance_init(num_dims, dtype, device)
        track = seg.update_mass and adapt_mass
        for _ in range(seg.length):
            h = halton_all[t]
            eps = torch.exp(da.log_step)
            n = steps_for(torch.exp(ch.log_tau), h, eps, max_steps)
            q0 = state.ensemble.q
            if fused_warm_step is not None:
                state, info, (q1, p1) = fused(fused_warm_step, t, state,
                                              eps, n)
            else:
                state, info, (q1, p1) = composed(t, state, eps, n)
            t += 1
            # the acceptance and the variance's batch terms ride in the
            # gradient's first gather, one row a rank
            parts = (torch.mean(info.accept_prob).reshape(1),
                     *(batch_terms(state.ensemble.q) if track else ()))
            g, got = _chees_gradient(q0, q1, p1, info.accept_prob, h,
                                     1.0 / state.ensemble.mass, mesh, parts)
            da = da_update(da, torch.mean(got[:, 0]), target=target_accept)
            ch = chees_update(ch, g, lr=adapt_lr)
            if track:
                varst = merge_batch_terms(varst, got[:, 1:])
        step_size = torch.exp(da.log_avg_step)
        tau = torch.exp(ch.log_tau)
        if track:
            state = state.replace(ensemble=state.ensemble.replace(
                mass=1.0 / regularized_mass(varst)))
    _synchronize(device)
    warmup_seconds = _time.perf_counter() - t0

    # ---- sampling -----------------------------------------------------------
    mean = torch.zeros((num_dims,), dtype=dtype, device=device)
    m2 = torch.zeros((num_dims,), dtype=dtype, device=device)
    n_cnt = 0
    accepts, divs, counts, samples = [], [], [], []
    t0 = _time.perf_counter()
    for _ in range(num_samples):
        n = steps_for(tau, halton_all[t], step_size, max_steps)
        if fused_step is not None:
            state, info = fused(fused_step, t, state, step_size, n)
        else:
            state, info, _ = composed(t, state, step_size, n)
        t += 1
        accepts.append(torch.mean(info.accept_prob))
        divs.append(torch.mean(info.divergent.to(dtype)))
        counts.append(n[0].to(dtype))
        qs = state.ensemble.q
        if collect == "samples":
            samples.append(qs)
        elif collect == "moments":
            n_new = n_cnt + num_walkers
            batch_var, batch_mean = torch.var_mean(qs, dim=0, correction=0)
            delta = batch_mean - mean
            mean = mean + delta * (num_walkers / n_new)
            m2 = (m2 + batch_var * num_walkers
                  + delta**2 * (n_cnt * num_walkers / n_new))
            n_cnt = n_new
    if num_samples:
        accept_rate = torch.mean(torch.stack(accepts))
        divergence_rate = torch.mean(torch.stack(divs))
        mean_num_steps = torch.mean(torch.stack(counts))
    else:  # as the JAX package: the mean of no transitions is NaN
        accept_rate = torch.full((), math.nan, dtype=dtype, device=device)
        divergence_rate = accept_rate.clone()
        mean_num_steps = accept_rate.clone()
    # the group's rates and moments (this process's alone without a mesh)
    got = gather_rows(torch.cat((accept_rate.reshape(1),
                                 divergence_rate.reshape(1), mean, m2)), mesh)
    accept_rate = torch.sum(got[:, 0]) / got.shape[0]
    divergence_rate = torch.sum(got[:, 1]) / got.shape[0]
    if n_cnt:
        mean, m2, n_cnt = _combine_moments(got[:, 2:], n_cnt, num_dims)
    _synchronize(device)
    sampling_seconds = _time.perf_counter() - t0

    out_samples = post_mean = post_var = None
    if collect == "samples":
        out_samples = (torch.stack(samples) if samples else torch.empty(
            (0, num_walkers, num_dims), dtype=dtype, device=device))
    elif collect == "moments":
        post_mean = mean
        post_var = m2 / max(n_cnt - 1.0, 1.0)

    return ChEESRunResult(
        state=state, samples=out_samples, mean=post_mean, var=post_var,
        accept_rate=accept_rate, divergence_rate=divergence_rate,
        step_size=step_size, trajectory_time=tau,
        mean_num_steps=mean_num_steps,
        kernel_used="fused" if fused_step is not None else "composed",
        warmup_kernel_used=("none" if num_warmup == 0
                            else "fused" if fused_warm_step is not None
                            else "composed"),
        warmup_seconds=warmup_seconds, sampling_seconds=sampling_seconds)
