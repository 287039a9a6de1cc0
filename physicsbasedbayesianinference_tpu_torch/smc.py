"""Tempered sequential Monte Carlo over the walker ensemble (port of the JAX
package's ``smc.py``).

A stage reweights the ensemble (log-space), picks the next inverse
temperature ``beta`` by a fixed 30-step bisection on the effective sample
size, resamples when the ESS falls under a threshold (or, with the ESS
target at or under the threshold, whenever the bisection stopped short of
``beta_max``), and mutates with K HMC transitions that target
``exp(-beta U / (k_B T))``. The log of each
stage's mean incremental weight accumulates into the log normalising
constant (the model evidence; ``-log Z = beta F``).

The stage loop runs on the host: its condition (``beta < beta_max`` and
``stage < max_stages``) is the one read from the device a stage
(``_host_read`` counts them); nothing inside a stage reads the device.

Mutation engines, picked by ``hmc.resolve_engine`` before the loop:

* fused (CUDA, a potential with ``diag_quadratic`` or a ``device_form``):
  each transition is one launch of kernel A or B with the stage beta as
  the kernels' potential scale, read from the device; the cached
  unscaled ``(u, g)`` are refreshed once after the resample and kept
  current by the transitions;
* composed (the CPU oracle, and CUDA potentials without a form): the
  composed HMC step on the tempered potential ``beta * U``.

Randomness: stage ``s`` mutates with the step keys ``(seed, s * K + k)``
and resamples from a generator keyed ``(seed, 2^32 + s)``.

``mesh=`` (a walker group, ``parallel.make_walker_mesh``) runs one block of
the ensemble in each process. A stage all-gathers the ``[W]`` potentials
and log-weights once, so every rank takes the bisection, the evidence, the
ESS and the resample decision on the whole ensemble, bit for bit as one
process does; it resamples with the ring resampler
(``parallel.resample``: one all-gather of K integer totals and K - 1 ring
hops of the walker blocks, the one-process indices exactly), and each
mutation's acceptance mean is that of the all-gathered ``[W]``
acceptances. So a stage makes 2 + K collectives and K - 1 hops, and the
fused engine (each rank's walkers drawn by global index) repeats the
one-process run. The composed engine folds the rank into its seed, so its
sharded run is another draw of the same law. Only the systematic
resampler runs on a mesh, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .adaptation import DualAveragingState, da_init, da_update
from .constants import Constants, NATURAL
from .device import resolve_device
from .ensemble import EnsembleState
from .hmc import (FusedTransition, HMCState, _step_generator,
                  build_hmc_kernel, resolve_engine)
from .ops.potentials import batched_value_and_grad

Tensor = torch.Tensor

# counters of the resampling generators, past every mutation's counter
_RESAMPLE_COUNTER = 1 << 32


# ---------------------------------------------------------------------------
# Weights and effective sample size
# ---------------------------------------------------------------------------


def normalize_log_weights(log_w: Tensor) -> Tensor:
    """``log w_i - logsumexp(log w)``."""
    return log_w - torch.logsumexp(log_w, dim=0)


def effective_sample_size(log_w: Tensor) -> Tensor:
    """ESS = (sum w)^2 / sum w^2 = exp(2 lse(lw) - lse(2 lw)) in [1, W]."""
    lse1 = torch.logsumexp(log_w, dim=0)
    lse2 = torch.logsumexp(2.0 * log_w, dim=0)
    return torch.exp(2.0 * lse1 - lse2)


# ---------------------------------------------------------------------------
# Resampling
# ---------------------------------------------------------------------------


def _inverse_cdf_indices(cum_w: Tensor, positions: Tensor) -> Tensor:
    """For positions u: the index i with ``cum_w[i-1] <= u < cum_w[i]``,
    clipped to ``[0, W-1]`` (a cumulative sum may end just under 1, and
    the positions past its end then fall to the last walker)."""
    return torch.clamp(torch.searchsorted(cum_w, positions, right=True),
                       0, cum_w.shape[0] - 1)


# The resamplers' weight CDF in 2^-52 fixed point. An integer prefix sum
# is exact in any order, so the indices are the same on every run; a float
# prefix sum on the card joins its partial sums in the order its blocks
# finish (PyTorch flags cumsum_cuda_kernel as nondeterministic).
_FIXED_ONE = 2.0**52


def _fixed_point_cdf(log_w: Tensor) -> Tensor:
    w = torch.exp(normalize_log_weights(log_w.double()))
    return torch.cumsum(torch.round(w * _FIXED_ONE).to(torch.int64), dim=0)


def _indices_at(log_w: Tensor, positions: Tensor) -> Tensor:
    """Inverse-CDF indices of ``positions`` in [0, 1)."""
    fixed = torch.floor(positions.double() * _FIXED_ONE).to(torch.int64)
    return _inverse_cdf_indices(_fixed_point_cdf(log_w), fixed)


def _uniforms(generator, shape, like: Tensor) -> Tensor:
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device)


def _strata(u: Tensor, num: int) -> Tensor:
    return (u + torch.arange(num, dtype=u.dtype, device=u.device)) / num


def systematic_indices(generator: torch.Generator, log_w: Tensor,
                       num: int) -> Tensor:
    """Systematic (low-variance) resampling: one uniform offset, ``num``
    evenly spaced points through the weight CDF."""
    return _indices_at(log_w, _strata(_uniforms(generator, (), log_w), num))


def stratified_indices(generator: torch.Generator, log_w: Tensor,
                       num: int) -> Tensor:
    """One uniform in each of ``num`` equal strata of the weight CDF."""
    return _indices_at(log_w,
                       _strata(_uniforms(generator, (num,), log_w), num))


def multinomial_indices(generator: torch.Generator, log_w: Tensor,
                        num: int) -> Tensor:
    """``num`` independent draws in proportion to the weights: the CDF at
    ``num`` uniforms (the JAX package draws them through
    ``jax.random.categorical``: the same law, another stream)."""
    return _indices_at(log_w, _uniforms(generator, (num,), log_w))


RESAMPLERS = {
    "systematic": systematic_indices,
    "stratified": stratified_indices,
    "multinomial": multinomial_indices,
}


def _take(tree, idx: Tensor):
    if isinstance(tree, Tensor):
        return tree.index_select(0, idx)
    if isinstance(tree, dict):
        return {k: _take(v, idx) for k, v in tree.items()}
    return type(tree)(_take(v, idx) for v in tree)


def resample(generator: torch.Generator, tree, log_w: Tensor,
             method: str = "systematic"):
    """Resample every walker-leading tensor in ``tree`` (a tensor, or a
    dict, list or tuple of them) by the weights; returns ``(tree', zeroed
    log-weights)``."""
    idx = RESAMPLERS[method](generator, log_w, log_w.shape[0])
    return _take(tree, idx), torch.zeros_like(log_w)


# ---------------------------------------------------------------------------
# Adaptive temperature ladder
# ---------------------------------------------------------------------------


def next_beta_by_ess(u: Tensor, log_w: Tensor, beta, *,
                     target_frac: float = 0.5, beta_max: float = 1.0,
                     num_bisect: int = 30) -> Tensor:
    """Largest beta' in (beta, beta_max] whose incremental weights
    ``-(beta' - beta) u`` keep ESS >= target_frac * W, found by a
    fixed-depth bisection on the device (no data-dependent trip count, no
    read back)."""
    target = target_frac * u.shape[0]
    beta = torch.as_tensor(beta, dtype=u.dtype, device=u.device)

    def ess_at(b):
        return effective_sample_size(log_w - (b - beta) * u)

    full = torch.full_like(beta, beta_max)
    lo, hi = beta, full
    for _ in range(num_bisect):
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    # if even beta_max keeps ESS above target, jump straight to it
    return torch.where(ess_at(full) >= target, full, lo)


# ---------------------------------------------------------------------------
# SMC driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SMCResult:
    """Output of :func:`run_smc`."""

    q: Tensor  # [W, D] final (posterior) positions, unweighted
    log_evidence: Tensor  # log Z estimate (free energy: -log Z = beta F)
    num_stages: int  # tempering stages used
    betas: Tensor  # [max_stages + 1] ladder (padded with beta_max)
    ess_history: Tensor  # [max_stages] ESS before each resample
    accept_history: Tensor  # [max_stages] mean acceptance of each stage's
    # last mutation
    final_step_size: Tensor
    kernel_used: str = "composed"  # mutation engine: "fused" | "composed"


@dataclasses.dataclass
class SMCCarry:
    """The state a stage hands the next (``build_smc_machinery``)."""

    seed: int
    q: Tensor  # [W, D]
    u: Tensor  # [W] unscaled potential energy of q
    beta: Tensor  # [] current inverse temperature
    log_w: Tensor  # [W]
    log_z: Tensor  # []
    stage: int
    da: DualAveragingState
    betas: Tensor
    ess_history: Tensor
    accept_history: Tensor


def _host_read(flag: Tensor) -> bool:
    """The stage loop's read of its condition: on CUDA, the one
    device-to-host read a stage."""
    _host_read.reads += 1
    return bool(flag.item())


_host_read.reads = 0  # type: ignore[attr-defined]


def _tempered(potential_fn, beta):
    """``beta * U`` as a potential, with ``beta * grad U`` as its closed-form
    gradient where U has one."""
    def tempered(q):
        return beta * potential_fn(q)

    ag = getattr(potential_fn, "analytic_grad", None)
    tempered.analytic_grad = (  # type: ignore[attr-defined]
        None if ag is None else (lambda q: beta * ag(q)))
    return tempered


def _tempered_step(potential_fn, key, q: Tensor, beta, step_size, *,
                   num_steps: int, temperature: float, constants: Constants,
                   momentum=None, uniform=None):
    """:func:`tempered_hmc_step` with every walker's acceptance."""
    k = build_hmc_kernel(_tempered(potential_fn, beta), num_steps=num_steps,
                         temperature=temperature, constants=constants)
    state, info = k.step(key, k.init(q), step_size, momentum=momentum,
                         uniform=uniform)
    return state.ensemble.q, info.accept_prob


def tempered_hmc_step(potential_fn, key, q: Tensor, beta, step_size, *,
                      num_steps: int, temperature: float = 1.0,
                      constants: Constants = NATURAL, momentum=None,
                      uniform=None):
    """One composed HMC transition targeting ``exp(-beta U / (k_B T))``:
    ``(q', mean acceptance)``. ``momentum=`` / ``uniform=`` replace its
    draws (tests)."""
    q, accept = _tempered_step(
        potential_fn, key, q, beta, step_size, num_steps=num_steps,
        temperature=temperature, constants=constants, momentum=momentum,
        uniform=uniform)
    return q, torch.mean(accept)


def run_smc(
    seed: int,
    potential_fn: Callable[[Tensor], Tensor],
    init_q,
    *,
    num_mutation_steps: int = 3,
    num_leapfrog_steps: int = 10,
    init_step_size: float = 0.5,
    beta0: float = 0.0,
    beta_max: float = 1.0,
    target_ess_frac: float = 0.5,
    resample_threshold_frac: float = 0.5,
    max_stages: int = 50,
    resampler: str = "systematic",
    temperature: float = 1.0,
    constants: Constants = NATURAL,
    mutation_target_accept: float = 0.75,
    kernel: str = "auto",
    mesh=None,
) -> SMCResult:
    """Anneal the ensemble from pi_{beta0} (near-flat) to pi_{beta_max} (the
    target) with ESS-adaptive tempering, resampling and HMC mutations, and
    estimate log Z along the way.

    ``init_q`` should be draws from the beta0 distribution. The mutation
    step size is adapted by dual averaging on the ensemble-mean mutation
    acceptance (``mutation_target_accept``), its state carried across
    stages. ``kernel``: "auto" | "fused" | "composed", as
    ``hmc.resolve_engine`` decides it ("fused" raises where it cannot
    run).

    ``mesh``: a walker group (module docstring). ``init_q`` is then the
    global ensemble, the same on every rank; the result's ``q`` is this
    rank's block, everything else the group's.
    """
    init_q = torch.as_tensor(
        init_q, device=resolve_device(None if mesh is None else mesh.device,
                                      init_q))
    m = build_smc_machinery(
        potential_fn, init_q.shape[0], init_q.dtype,
        num_dims=init_q.shape[1], num_mutation_steps=num_mutation_steps,
        num_leapfrog_steps=num_leapfrog_steps,
        init_step_size=init_step_size, beta0=beta0, beta_max=beta_max,
        target_ess_frac=target_ess_frac,
        resample_threshold_frac=resample_threshold_frac,
        max_stages=max_stages, resampler=resampler,
        temperature=temperature, constants=constants,
        mutation_target_accept=mutation_target_accept, kernel=kernel,
        device=init_q.device, mesh=mesh)
    carry = m["init_carry"](seed, init_q)
    while m["cond"](carry):
        carry = m["body"](carry)
    return m["finalize"](carry)


def build_smc_machinery(
    potential_fn: Callable[[Tensor], Tensor],
    num_walkers: int,
    dtype,
    *,
    num_dims: int,
    num_mutation_steps: int = 3,
    num_leapfrog_steps: int = 10,
    init_step_size: float = 0.5,
    beta0: float = 0.0,
    beta_max: float = 1.0,
    target_ess_frac: float = 0.5,
    resample_threshold_frac: float = 0.5,
    max_stages: int = 50,
    resampler: str = "systematic",
    temperature: float = 1.0,
    constants: Constants = NATURAL,
    mutation_target_accept: float = 0.75,
    kernel: str = "auto",
    device=None,
    mesh=None,
) -> dict:
    """The SMC stage machinery as separate pieces:

    ``{"init_carry": (seed, init_q) -> SMCCarry, "cond": carry -> bool,
    "body": carry -> carry, "finalize": carry -> SMCResult,
    "kernel_used": "fused" | "composed"}``.

    :func:`run_smc` loops ``body`` while ``cond``; a checkpointing driver
    may save the carry after each stage and resume with the same pieces,
    which reproduce the uninterrupted run. ``device``: where the walkers
    live (the engine is chosen for it). ``mesh``: a walker group; the
    carry then holds this rank's blocks, ``num_walkers`` is the global
    count and ``init_carry`` takes the global ensemble.
    """
    if resampler not in RESAMPLERS:
        raise ValueError(f"bad resampler={resampler!r} (want one of "
                         f"{tuple(RESAMPLERS)})")
    if mesh is not None:
        if resampler != "systematic":
            raise ValueError(
                "sharded SMC (mesh=...) supports only the systematic "
                f"resampler; got {resampler!r}")
        from .parallel.mesh import check_divisible, gather_walkers
        from .parallel.resample import ring_resample_blocks, \
            systematic_offset
        from .parallel.sharded import fold_rank
        check_divisible(num_walkers, mesh)
        device = mesh.device
        block = mesh.block(num_walkers)
    # the global index of this process's first walker
    offset = 0 if mesh is None else block.start
    probe = torch.empty((0, num_dims), dtype=dtype,
                        device=resolve_device(device))
    engine = resolve_engine(kernel, potential_fn, probe)
    vg = batched_value_and_grad(potential_fn)
    base_beta = constants.beta(temperature)
    k_mut = num_mutation_steps
    fused = (FusedTransition(potential_fn, temperature=temperature,
                             constants=constants)
             if engine == "fused" else None)

    def resample_q(seed, stage, q, log_w):
        """``q`` resampled by the weights ``log_w`` ``[W]`` (with a mesh,
        this rank's block of q, by the ring)."""
        if mesh is not None:
            return ring_resample_blocks(
                q, log_w[block], torch.logsumexp(log_w.double(), dim=0),
                systematic_offset(seed, stage, log_w), mesh)
        gen = _step_generator((seed, _RESAMPLE_COUNTER + stage), q.device)
        return q.index_select(0, RESAMPLERS[resampler](gen, log_w,
                                                       num_walkers))

    def whole(x: Tensor) -> Tensor:
        """A walker-leading vector of the whole ensemble: with a mesh, the
        ranks' blocks all-gathered."""
        return x if mesh is None else gather_walkers(x, mesh)

    def whole2(u: Tensor, log_w: Tensor) -> tuple[Tensor, Tensor]:
        if mesh is None:
            return u, log_w
        both = gather_walkers(torch.stack((u, log_w), dim=1), mesh)
        return both[:, 0].contiguous(), both[:, 1].contiguous()

    def cond(c: SMCCarry) -> bool:
        more = _host_read(c.beta < beta_max)
        return more and c.stage < max_stages

    def body(c: SMCCarry) -> SMCCarry:
        # with a mesh the stage's weights are taken on the whole ensemble
        u_all, log_w = whole2(c.u, c.log_w)
        new_beta = next_beta_by_ess(
            base_beta * u_all, log_w, c.beta, target_frac=target_ess_frac,
            beta_max=beta_max)
        inc = -(new_beta - c.beta) * base_beta * u_all
        # evidence increment: log mean incremental weight under the
        # normalised current weights
        log_z = c.log_z + torch.logsumexp(
            normalize_log_weights(log_w) + inc, dim=0)
        log_w = log_w + inc
        ess = effective_sample_size(normalize_log_weights(log_w))

        # resample when depleted (decided on the device). A stage that
        # stops short of beta_max has pushed the ESS down onto its target;
        # with the target at or under the threshold the weights are depleted
        # by construction, which the JAX package leaves to the float32
        # rounding of the ESS (and then stalls: ROADMAP.md section 3)
        do_resample = ess < resample_threshold_frac * num_walkers
        if target_ess_frac <= resample_threshold_frac:
            do_resample = do_resample | (new_beta < beta_max)
        q = torch.where(do_resample,
                        resample_q(c.seed, c.stage, c.q, log_w), c.q)
        log_w = torch.where(do_resample, torch.zeros_like(log_w), log_w)
        if mesh is not None:
            log_w = log_w[block].contiguous()

        # K tempered mutations, each feeding its ensemble-mean acceptance
        # into dual averaging
        da = c.da
        if fused is not None:
            # (u, g) refreshed after the resample-select, then kept
            # current by the transitions
            u, g = vg(q)
            state = HMCState(
                ensemble=EnsembleState(
                    q=q, p=torch.zeros_like(q),
                    mass=torch.ones((), dtype=q.dtype, device=q.device),
                    log_weight=torch.zeros_like(log_w)),
                potential_energy=u, grad=g)
            for k in range(k_mut):
                state, info, _ = fused(
                    (c.seed, c.stage * k_mut + k), state,
                    torch.exp(da.log_step), num_steps=num_leapfrog_steps,
                    potential_scale=new_beta, walker_offset=offset)
                acc = torch.mean(whole(info.accept_prob))
                da = da_update(da, acc, target=mutation_target_accept)
            q, u = state.ensemble.q, state.potential_energy
        else:
            seed = c.seed if mesh is None else fold_rank(c.seed, mesh.rank)
            for k in range(k_mut):
                q, accept = _tempered_step(
                    potential_fn, (seed, c.stage * k_mut + k), q, new_beta,
                    torch.exp(da.log_step), num_steps=num_leapfrog_steps,
                    temperature=temperature, constants=constants)
                acc = torch.mean(whole(accept))
                da = da_update(da, acc, target=mutation_target_accept)
            # unscaled target potential for the next reweighting
            u, _ = vg(q)
        if k_mut == 0:
            acc = torch.zeros((), dtype=dtype, device=q.device)

        # the histories by selects, not by writes into a copy: a stage
        # makes no memory copy
        slots = torch.arange(max_stages + 1, device=q.device)
        here = slots[:-1] == c.stage
        return SMCCarry(
            seed=c.seed, q=q, u=u, beta=new_beta, log_w=log_w, log_z=log_z,
            stage=c.stage + 1, da=da,
            betas=torch.where(slots == c.stage + 1, new_beta, c.betas),
            ess_history=torch.where(here, ess, c.ess_history),
            accept_history=torch.where(here, acc, c.accept_history))

    def init_carry(seed: int, init_q) -> SMCCarry:
        init_q = torch.as_tensor(init_q,
                                 device=resolve_device(device, init_q))
        if mesh is not None:
            if init_q.shape[0] != num_walkers:
                raise ValueError(f"init_q has {init_q.shape[0]} walkers, "
                                 f"want the whole ensemble of {num_walkers}")
            init_q = init_q[block].contiguous()
        dev = init_q.device
        u0, _ = vg(init_q)
        betas = torch.full((max_stages + 1,), beta_max, dtype=dtype,
                           device=dev)
        betas[0] = beta0
        return SMCCarry(
            seed=seed, q=init_q, u=u0,
            beta=torch.full((), beta0, dtype=dtype, device=dev),
            log_w=torch.zeros(init_q.shape[:1], dtype=dtype, device=dev),
            log_z=torch.zeros((), dtype=dtype, device=dev), stage=0,
            da=da_init(torch.full((), init_step_size, dtype=dtype,
                                  device=dev)),
            betas=betas,
            ess_history=torch.zeros((max_stages,), dtype=dtype, device=dev),
            accept_history=torch.zeros((max_stages,), dtype=dtype,
                                       device=dev))

    def finalize(c: SMCCarry) -> SMCResult:
        # a final resample, so the returned ensemble is unweighted
        q = resample_q(c.seed, c.stage, c.q, whole(c.log_w))
        return SMCResult(
            q=q, log_evidence=c.log_z, num_stages=c.stage, betas=c.betas,
            ess_history=c.ess_history, accept_history=c.accept_history,
            final_step_size=torch.exp(c.da.log_step).to(dtype),
            kernel_used=engine)

    return {"init_carry": init_carry, "cond": cond, "body": body,
            "finalize": finalize, "kernel_used": engine}
