"""Ensemble Hamiltonian Monte Carlo over ``[W, D]`` tensors (port of the JAX
package's ``hmc.py``).

A transition is ``step(key, state, step_size) -> (state', info)`` with
``key = (seed, transition index)``. Two engines implement it:

* the composed engine (:func:`build_hmc_kernel`): torch ops per leapfrog
  step, momenta and uniforms from a ``torch.Generator`` seeded from the
  key. It runs on any device and is the CPU oracle, as the JAX package's
  ``kernel="xla"`` is;
* the fused engine (:func:`build_fused_hmc_kernel`): one hand-written CUDA
  kernel per transition, its draws from the Philox counter stream keyed by
  (seed, transition index, walker, dim-group), so no host RNG runs per
  transition.

``run_hmc(kernel="auto")`` picks the engine from the state's device and the
potential's attributes when it builds the kernel, never after a failure:

    CPU            any potential        composed
    CUDA           diag_quadratic       fused, variant "diag"    (kernel A)
    CUDA           device_form          fused, variant "generic" (kernel B)
    CUDA           anything else        composed

``kernel="fused"`` raises where it cannot be honoured (unlike the JAX
package, which degrades to its XLA engine with a warning). ``kernel=`` also
takes a built :class:`HMCKernel`, used as it is.

``run_hmc(mesh=...)`` runs one walker shard of a multi-process run
(:mod:`.parallel`): the kernel draws by global walker index, the loop's
ensemble means and moments are reduced over the group, and nothing else
changes.

``run_hmc(metric="dense")`` runs :func:`build_dense_hmc_kernel`, a composed
step whose metric operations are ``[W, D] x [D, D]`` products; no fused
kernel has a dense metric, so ``kernel="fused"`` raises there.

At temperature T the target is ``exp(-U / (k_B T))``: momenta have std
``sqrt(m k_B T)`` and the Metropolis ratio is ``exp(-beta (H1 - H0))``.
"""

from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Callable, Optional, Union

import torch

from .adaptation import (
    batch_terms,
    build_warmup_schedule,
    covariance_init,
    da_init,
    da_update,
    merge_batch_terms,
    regularized_covariance,
    regularized_mass,
    variance_init,
)
from .constants import Constants, NATURAL
from .device import resolve_device
from .ensemble import EnsembleState, kinetic_energy, thermal_momentum_std
from .ops import kernels
from .ops.integrators import get_integrator
from .ops.potentials import batched_value_and_grad

Tensor = torch.Tensor
StepKey = tuple  # (run seed: int, transition index: int)

FUSED_INTEGRATORS = ("leapfrog", "velocity_verlet")


@dataclasses.dataclass
class HMCState:
    """Sampler state: ensemble + cached potential energy and gradient."""

    ensemble: EnsembleState
    potential_energy: Tensor  # [W]
    grad: Tensor  # [W, D]

    def replace(self, **changes) -> "HMCState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class HMCInfo:
    """Per-transition diagnostics."""

    accept_prob: Tensor  # [W]
    accepted: Tensor  # [W] bool
    energy_error: Tensor  # [W] beta * (H_new - H_old), non-finite -> +inf
    divergent: Tensor  # [W] bool
    potential_energy: Tensor  # [W]
    step_size: Tensor  # scalar


@dataclasses.dataclass(frozen=True)
class HMCKernel:
    """A built HMC transition kernel."""

    init: Callable[..., HMCState]
    step: Callable[..., tuple[HMCState, HMCInfo]]
    num_steps: int
    grad_evals_per_step: int
    kind: str = "composed"  # "composed" | "fused" | "dense"
    # (num_walkers, num_dims, mass_ndim) -> "diag" | "generic" | "composed"
    variant_for: Optional[Callable[..., str]] = None
    # the dense kernel's step after its draws (build_dense_hmc_kernel)
    transition: Optional[Callable[..., tuple]] = None
    # the walker group a kernel of parallel.shard_map_kernel is bound to
    mesh: Optional[object] = None


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def _device_scalar(x, device) -> Tensor:
    """``x`` (a number, or a tensor of one element) as a float32 tensor [1]
    on ``device``; a number is filled there, not copied from the host."""
    if isinstance(x, Tensor):
        return x.reshape(1).to(device=device, dtype=torch.float32)
    return torch.full((1,), float(x), dtype=torch.float32, device=device)


def _step_generator(key: StepKey, device) -> torch.Generator:
    """The composed engine's generator for transition ``key``."""
    seed, counter = key
    gen = torch.Generator(device=device)
    gen.manual_seed(_splitmix64(_splitmix64(seed) ^ counter) >> 1)
    return gen


def init_state(vg, q, mass: Union[float, Tensor] = 1.0) -> HMCState:
    """The sampler state at positions ``q`` ``[W, D]``: the ensemble and
    the cached ``(U, grad)`` from ``vg``."""
    q = torch.as_tensor(q, device=resolve_device(None, q))
    if q.ndim != 2:
        raise ValueError(
            f"init positions must be [num_walkers, num_dims]; got shape "
            f"{tuple(q.shape)}. For a single walker pass q[None, :].")
    u, g = vg(q)
    ens = EnsembleState(
        q=q, p=torch.zeros_like(q),
        mass=torch.as_tensor(mass, dtype=q.dtype, device=q.device),
        log_weight=torch.zeros(q.shape[:1], dtype=q.dtype, device=q.device))
    return HMCState(ensemble=ens, potential_energy=u, grad=g)


def metropolis_select(state: HMCState, p0: Tensor, mass: Tensor, proposal,
                      *, beta, divergence_threshold: float, uniform: Tensor,
                      step_size) -> tuple[HMCState, HMCInfo]:
    """Per-walker Metropolis test of ``proposal = (q1, p1, u1, g1)`` (p1
    already flipped) against ``state`` with start momentum ``p0``, and the
    selected state. ``uniform``: one draw in [0, 1) a walker."""
    q1, p1, u1, g1 = proposal
    ens = state.ensemble
    h0 = kinetic_energy(p0, mass) + state.potential_energy
    h1 = kinetic_energy(p1, mass) + u1
    energy_error = beta * (h1 - h0)
    energy_error = torch.where(torch.isfinite(energy_error),
                               energy_error, torch.inf)
    divergent = energy_error > divergence_threshold
    log_u = torch.log(torch.clamp_min(uniform,
                                      torch.finfo(uniform.dtype).tiny))
    accepted = (log_u < -energy_error) & ~divergent
    accept_prob = torch.where(
        divergent, 0.0, torch.exp(torch.clamp_max(-energy_error, 0.0)))
    sel = accepted[:, None]
    new_state = HMCState(
        ensemble=ens.replace(q=torch.where(sel, q1, ens.q),
                             p=torch.where(sel, p1, p0), mass=mass),
        potential_energy=torch.where(accepted, u1, state.potential_energy),
        grad=torch.where(sel, g1, state.grad))
    info = HMCInfo(accept_prob=accept_prob, accepted=accepted,
                   energy_error=energy_error, divergent=divergent,
                   potential_energy=new_state.potential_energy,
                   step_size=torch.as_tensor(step_size))
    return new_state, info


def build_hmc_kernel(
    potential_fn: Callable[[Tensor], Tensor],
    *,
    num_steps: int,
    integrator: str = "leapfrog",
    temperature: float = 1.0,
    constants: Constants = NATURAL,
    divergence_threshold: float = 1000.0,
    use_analytic_grad: bool = True,
) -> HMCKernel:
    """The composed transition: thermal momentum refresh, ``num_steps``
    integrator steps, momentum flip, per-walker Metropolis select."""
    integ = get_integrator(integrator)
    vg = batched_value_and_grad(potential_fn, use_analytic=use_analytic_grad)
    beta = constants.beta(temperature)

    def init(q, *, mass: Union[float, Tensor] = 1.0) -> HMCState:
        return init_state(vg, q, mass)

    def step(key: StepKey, state: HMCState, step_size,
             mass: Optional[Tensor] = None, *,
             momentum: Optional[Tensor] = None,
             uniform: Optional[Tensor] = None) -> tuple[HMCState, HMCInfo]:
        """``momentum=`` ``[W, D]`` and ``uniform=`` ``[W]`` replace the
        step's own draws, for tests that hold it against another
        implementation."""
        ens = state.ensemble
        if mass is None:
            mass = ens.mass
        q = ens.q
        gen = _step_generator(key, q.device)
        p_std = thermal_momentum_std(mass, temperature, constants)
        p0 = p_std * torch.randn(q.shape, generator=gen, dtype=q.dtype,
                                 device=q.device)
        if momentum is not None:
            p0 = momentum
        q1, p1, u1, g1 = integ(
            vg, q, p0, step_size=step_size, num_steps=num_steps,
            inv_mass=1.0 / mass, grad=state.grad,
            potential_energy=state.potential_energy)
        if uniform is None:
            uniform = torch.rand(q.shape[:1], generator=gen, dtype=q.dtype,
                                 device=q.device)
        # momentum flip: the proposal is its own inverse
        return metropolis_select(
            state, p0, mass, (q1, -p1, u1, g1), beta=beta,
            divergence_threshold=divergence_threshold, uniform=uniform,
            step_size=step_size)

    return HMCKernel(init=init, step=step, num_steps=num_steps,
                     grad_evals_per_step=getattr(
                         integ, "grad_evals_per_step", 1))


class FusedTransition:
    """One fused CUDA transition (kernel A or B) of a potential, with what
    a launch needs beside the sampler state prepared once: the routing,
    the potential's parameters and the metric on the state's device, the
    scalars. Shared by :func:`build_fused_hmc_kernel` (a fixed leapfrog
    count) and ``chees.build_fused_jittered_step`` (a count on the device,
    with or without the proposal outputs). On CPU tensors the kernels'
    plain versions run the same function."""

    def __init__(self, potential_fn, *, temperature: float = 1.0,
                 constants: Constants = NATURAL,
                 divergence_threshold: float = 1000.0):
        self.temperature = temperature
        self.constants = constants
        self.divergence_threshold = divergence_threshold
        self.beta = constants.beta(temperature)
        self.diag = getattr(potential_fn, "diag_quadratic", None)
        self.form = getattr(potential_fn, "device_form", None)
        # Potential parameters and the metric, prepared on the state's
        # device once (per device and D; the metric again only when its
        # tensor changes), so a step issues no host-to-device copy; a
        # number is filled on the device, so not even the first step does.
        self._prepared: dict = {}
        self._metric_cache: dict = {}
        self._beta_scale: dict = {}

    def variant_for(self, num_walkers: int, num_dims: int,
                    mass_ndim: int = 1) -> str:
        """What a step runs: ``"diag"`` (kernel A; kernel B's diagonal
        form where the proposal is asked for) for a potential with
        ``diag_quadratic``, ``"generic"`` (kernel B) for one with a
        ``device_form`` the kernel takes at this D
        (``kernels.generic_unsupported``), else ``"composed"``. A
        per-walker mass (``mass_ndim > 1``) is also ``"composed"``: the
        kernels take a [D] metric."""
        if mass_ndim > 1:
            return "composed"
        if self.diag is not None:
            return "diag"
        if (self.form is not None and kernels.generic_unsupported(
                self.form, num_dims) is None):
            return "generic"
        return "composed"

    def _params(self, device, d: int):
        key = (str(device), d)
        if key not in self._prepared:
            def vec(v):
                if not isinstance(v, Tensor):
                    return torch.full((d,), float(v), dtype=torch.float32,
                                      device=device)
                return torch.broadcast_to(
                    v.to(device=device, dtype=torch.float32),
                    (d,)).contiguous()
            if self.diag is not None:
                self._prepared[key] = (vec(self.diag[0]), vec(self.diag[1]))
            else:
                name, params = self.form
                self._prepared[key] = (name, tuple(
                    p.to(device=device, dtype=torch.float32).contiguous()
                    for p in params))
        return self._prepared[key]

    def _scalars(self, step_size, device, beta=None, scale=None) -> Tensor:
        """(step size, beta, potential scale) as a device tensor [3].
        Writing a Python number into a CUDA tensor is a blocking
        host-to-device copy, so a number is filled on the device and a
        tensor joined as it is; without a per-call ``beta`` or ``scale``
        the pair (the constants' beta, 1) is made once per device."""
        step = _device_scalar(step_size, device)
        if beta is None and scale is None:
            key = str(device)
            if key not in self._beta_scale:
                self._beta_scale[key] = torch.cat((
                    _device_scalar(self.beta, device),
                    _device_scalar(1.0, device)))
            return torch.cat((step, self._beta_scale[key]))
        return torch.cat((
            step, _device_scalar(self.beta if beta is None else beta, device),
            _device_scalar(1.0 if scale is None else scale, device)))

    def _metric(self, mass: Tensor, d: int):
        cache = self._metric_cache
        if cache.get("mass") is not mass:
            p_std = thermal_momentum_std(mass, self.temperature,
                                         self.constants)
            cache.update(
                mass=mass,
                p_std=torch.broadcast_to(p_std, (d,)).contiguous(),
                inv_mass=torch.broadcast_to(1.0 / mass, (d,)).contiguous())
        return cache["p_std"], cache["inv_mass"]

    def __call__(self, key: StepKey, state: HMCState, step_size,
                 mass: Optional[Tensor] = None, *, num_steps,
                 max_steps: Optional[int] = None,
                 emit_proposal: bool = False, potential_scale=None,
                 beta=None, walker_offset: int = 0):
        """``(state', info, proposal)``: one transition with ``num_steps``
        leapfrog steps (an int, or an int32 tensor [1] on the state's
        device with ``max_steps``); ``proposal`` is ``(q1, -p1)`` with
        ``emit_proposal``, else None.

        ``potential_scale`` (SMC's stage beta) multiplies U in the forces
        and in H while the returned (u, g) stay unscaled; ``beta`` (a
        parallel-tempering rung, ``1 / (k_B T_r)``) replaces the
        constants' beta in the Metropolis ratio, and the momenta are then
        thermal at it, std ``sqrt(m / beta)``. Each is a Python number or
        a tensor of shape [] or [1] on the state's device, which the
        kernels read there. ``walker_offset``: the global index of the
        state's first walker (``ops.kernels``)."""
        ens = state.ensemble
        if mass is None:
            mass = ens.mass
        w, d = ens.q.shape
        variant = self.variant_for(w, d, mass.ndim)
        if variant == "composed":
            raise ValueError(
                "no fused kernel for this state: the potential has no "
                f"diag_quadratic and no device_form for D={d}, or the mass "
                f"is per walker (mass.ndim={mass.ndim})")
        seed, counter = key
        q = ens.q.contiguous()
        p_std, inv_mass = self._metric(mass, d)
        if beta is not None:
            p_std = torch.sqrt(torch.broadcast_to(mass, (d,)) / beta)
        common = dict(scalars=self._scalars(step_size, q.device, beta,
                                            potential_scale),
                      p_std=p_std, inv_mass=inv_mass, num_steps=num_steps,
                      max_steps=max_steps,
                      divergence_threshold=self.divergence_threshold,
                      walker_offset=walker_offset)
        proposal = None
        if variant == "diag" and not emit_proposal:
            k_diag, mean = self._params(q.device, d)
            q1, g1, u1, accept_prob, accepted, energy_error = \
                kernels.fused_hmc_diag_quadratic(
                    seed, counter, q, k_diag=k_diag, mean=mean, **common)
        else:
            form = self._params(q.device, d)
            if variant == "diag":  # kernel A has no proposal outputs
                form = ("diag", form)
            out = kernels.fused_hmc_transition(
                form, seed, counter, q, state.potential_energy.contiguous(),
                state.grad.contiguous(), emit_proposal=emit_proposal,
                **common)
            q1, u1, g1, accept_prob, accepted, energy_error = out[:6]
            if emit_proposal:
                proposal = (out[6], out[7])
        new_state = HMCState(ensemble=ens.replace(q=q1, mass=mass),
                             potential_energy=u1, grad=g1)
        info = HMCInfo(
            accept_prob=accept_prob, accepted=accepted,
            energy_error=energy_error,
            divergent=torch.isinf(energy_error)
            | (energy_error > self.divergence_threshold),
            potential_energy=u1, step_size=torch.as_tensor(step_size))
        return new_state, info, proposal

    def ladder(self, betas: Tensor, mass: Tensor, num_dims: int) -> dict:
        """What a call of :meth:`rungs` at the inverse temperatures ``betas``
        ``[R]`` needs beside its state, made once per ladder: each rung's
        thermal momentum std ``sqrt(m / beta_r)`` ``[R, D]``, taken rung by
        rung as a call with ``beta=beta_r`` takes it, and the beta and
        potential-scale columns of the launch's scalars."""
        m = torch.broadcast_to(mass, (num_dims,))
        return {"mass": mass, "betas": betas.to(torch.float32),
                "scale": torch.ones_like(betas, dtype=torch.float32),
                "p_std": torch.stack([torch.sqrt(m / b) for b in betas])}

    def rungs(self, seeds, counter: int, q: Tensor, u: Tensor, g: Tensor,
              step_sizes: Tensor, ladder: dict, *, num_steps,
              walker_offset: int = 0):
        """One transition of each of R rungs of a ladder (:meth:`ladder`)
        in one launch of kernel A or B (their rung axis, ``ops.kernels``):
        ``q`` ``[R, W, D]`` with its cached ``(u [R, W], g [R, W, D])``,
        rung r keyed ``(seeds[r], counter)`` at step size ``step_sizes[r]``
        and beta_r. Rung r's rows are those of a call with ``beta=beta_r``
        on rung r alone, bit for bit. Returns ``(q', u', g', accept_prob
        [R, W])``."""
        mass = ladder["mass"]
        _, w, d = q.shape
        variant = self.variant_for(w, d, mass.ndim)
        if variant == "composed":
            raise ValueError(
                "no fused kernel for these rungs: the potential has no "
                f"diag_quadratic and no device_form for D={d}, or the mass "
                f"is per walker (mass.ndim={mass.ndim})")
        _, inv_mass = self._metric(mass, d)
        scalars = torch.stack((step_sizes.to(torch.float32), ladder["betas"],
                               ladder["scale"]), dim=1)
        common = dict(scalars=scalars, p_std=ladder["p_std"],
                      inv_mass=inv_mass, num_steps=num_steps,
                      divergence_threshold=self.divergence_threshold,
                      walker_offset=walker_offset)
        q = q.contiguous()
        if variant == "diag":
            k_diag, mean = self._params(q.device, d)
            q1, g1, u1, accept_prob, _, _ = kernels.fused_hmc_diag_quadratic(
                list(seeds), counter, q, k_diag=k_diag, mean=mean, **common)
        else:
            q1, u1, g1, accept_prob, _, _ = kernels.fused_hmc_transition(
                self._params(q.device, d), list(seeds), counter, q,
                u.contiguous(), g.contiguous(), **common)
        return q1, u1, g1, accept_prob


def build_fused_hmc_kernel(
    potential_fn: Callable[[Tensor], Tensor],
    *,
    num_steps: int,
    temperature: float = 1.0,
    constants: Constants = NATURAL,
    divergence_threshold: float = 1000.0,
) -> HMCKernel:
    """Single-kernel HMC: the whole transition (momentum refresh, merged-kick
    leapfrog, Metropolis select) is one CUDA launch on CUDA tensors; on CPU
    tensors the kernels' plain versions run the same function.

    ``variant_for`` (:meth:`FusedTransition.variant_for`) names what a
    step runs; where it says ``"composed"`` the step is the
    :func:`build_hmc_kernel` step.
    """
    base = build_hmc_kernel(
        potential_fn, num_steps=num_steps, temperature=temperature,
        constants=constants, divergence_threshold=divergence_threshold)
    fused = FusedTransition(
        potential_fn, temperature=temperature, constants=constants,
        divergence_threshold=divergence_threshold)

    def step(key: StepKey, state: HMCState, step_size,
             mass: Optional[Tensor] = None, *, potential_scale=None,
             beta=None, walker_offset: int = 0) -> tuple[HMCState, HMCInfo]:
        ens = state.ensemble
        if mass is None:
            mass = ens.mass
        if fused.variant_for(*ens.q.shape, mass.ndim) == "composed":
            if potential_scale is not None or beta is not None \
                    or walker_offset:
                raise ValueError(
                    "this state runs the composed step, which takes no "
                    "potential_scale, beta or walker_offset: temper the "
                    "potential itself (as run_smc's composed route does)")
            return base.step(key, state, step_size, mass=mass)
        new_state, info, _ = fused(key, state, step_size, mass,
                                   num_steps=num_steps,
                                   potential_scale=potential_scale, beta=beta,
                                   walker_offset=walker_offset)
        return new_state, info

    return HMCKernel(init=base.init, step=step, num_steps=num_steps,
                     grad_evals_per_step=1, kind="fused",
                     variant_for=fused.variant_for)


def build_dense_hmc_kernel(
    potential_fn: Callable[[Tensor], Tensor],
    *,
    num_steps: int,
    temperature: float = 1.0,
    constants: Constants = NATURAL,
    divergence_threshold: float = 1000.0,
) -> HMCKernel:
    """HMC transition with a dense metric (mass matrix M = Sigma^-1, Stan's
    "dense_e"). The sampler takes the covariance Sigma itself, so every
    metric operation is a ``[W, D] x [D, D]`` product (``torch.matmul``; the
    JAX package computes them outside its Pallas kernels too) and no solve
    or inverse of Sigma runs in the loop:

      momentum draw   p = sqrt(k_B T) z @ inv_chol, inv_chol =
                      cholesky(Sigma)^-1, so cov(p) = k_B T M
      drift           q += dt p @ Sigma
      kinetic energy  0.5 sum(p * (p @ Sigma))

    ``step(key, state, step_size, cov, inv_chol)`` draws ``z`` ``[W, D]``
    and ``log u`` ``[W]`` (a uniform clipped below at the dtype's tiny)
    from the generator of ``key`` and runs ``transition(state, z, log_u,
    step_size, cov, inv_chol)``, the deterministic rest: a non-finite
    energy error counts as +inf, and the accept is a select."""
    vg = batched_value_and_grad(potential_fn)
    beta = constants.beta(temperature)
    momentum_scale = math.sqrt(1.0 / beta)

    def init(q, *, mass: Union[float, Tensor] = 1.0) -> HMCState:
        return init_state(vg, q, mass)

    def kinetic(p, cov):
        return 0.5 * torch.sum(p * (p @ cov), dim=-1)

    def transition(state: HMCState, z: Tensor, log_u: Tensor, step_size,
                   cov: Tensor, inv_chol: Tensor) -> tuple[HMCState, HMCInfo]:
        ens = state.ensemble
        p0 = momentum_scale * (z @ inv_chol)
        q, p, u, g = ens.q, p0, state.potential_energy, state.grad
        for _ in range(num_steps):
            p = p - (0.5 * step_size) * g
            q = q + step_size * (p @ cov)
            u, g = vg(q)
            p = p - (0.5 * step_size) * g
        p1 = -p
        energy_error = beta * ((kinetic(p1, cov) + u)
                               - (kinetic(p0, cov) + state.potential_energy))
        energy_error = torch.where(torch.isfinite(energy_error),
                                   energy_error, torch.inf)
        divergent = energy_error > divergence_threshold
        accepted = (log_u < -energy_error) & ~divergent
        accept_prob = torch.where(
            divergent, 0.0, torch.exp(torch.clamp_max(-energy_error, 0.0)))
        sel = accepted[:, None]
        new_state = HMCState(
            ensemble=ens.replace(q=torch.where(sel, q, ens.q),
                                 p=torch.where(sel, p1, p0)),
            potential_energy=torch.where(accepted, u,
                                         state.potential_energy),
            grad=torch.where(sel, g, state.grad))
        info = HMCInfo(accept_prob=accept_prob, accepted=accepted,
                       energy_error=energy_error, divergent=divergent,
                       potential_energy=new_state.potential_energy,
                       step_size=torch.as_tensor(step_size))
        return new_state, info

    def step(key: StepKey, state: HMCState, step_size, cov: Tensor,
             inv_chol: Tensor) -> tuple[HMCState, HMCInfo]:
        q = state.ensemble.q
        gen = _step_generator(key, q.device)
        z = torch.randn(q.shape, generator=gen, dtype=q.dtype,
                        device=q.device)
        uniform = torch.rand(q.shape[:1], generator=gen, dtype=q.dtype,
                             device=q.device)
        log_u = torch.log(torch.clamp_min(uniform, torch.finfo(q.dtype).tiny))
        return transition(state, z, log_u, step_size, cov, inv_chol)

    return HMCKernel(init=init, step=step, num_steps=num_steps,
                     grad_evals_per_step=1, kind="dense",
                     transition=transition)


def _inverse_cholesky(cov: Tensor) -> Tensor:
    chol = torch.linalg.cholesky(cov)
    eye = torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
    return torch.linalg.solve_triangular(chol, eye, upper=False)


@dataclasses.dataclass
class HMCRunResult:
    """Output of :func:`run_hmc`."""

    state: HMCState
    samples: Optional[Tensor]  # [S, W, D] if collect="samples"
    mean: Optional[Tensor]  # [D] streaming posterior mean (collect="moments")
    var: Optional[Tensor]  # [D] streaming posterior variance
    accept_rate: Tensor  # scalar, post-warmup mean (NaN if num_samples=0)
    divergence_rate: Tensor  # scalar
    step_size: Tensor  # adapted step size
    mass: Tensor  # adapted diagonal mass [D] (dense: 1 / diag(Sigma))
    num_grad_evals: int  # potential-gradient evaluations, all walkers
    kernel_used: str = "composed"  # "fused" | "composed" | "dense"
    # "diag" | "generic" | "composed" | "dense"
    kernel_variant: str = "composed"
    sampling_seconds: float = 0.0  # wall time of sampling, device-synced
    metric_cov: Optional[Tensor] = None  # [D, D] adapted Sigma (dense)


def resolve_engine(kernel: str, potential_fn, q: Tensor, *,
                   integrator: str = "leapfrog") -> str:
    """``kernel="auto"|"fused"|"composed"`` -> the engine that will run
    ("fused" | "composed"), decided from the state tensor and the
    potential's attributes. ``"fused"`` raises where it cannot run."""
    if kernel not in ("auto", "fused", "composed"):
        raise ValueError(f"bad kernel={kernel!r} (want auto|fused|composed)")
    if kernel == "composed":
        return "composed"
    form = getattr(potential_fn, "device_form", None)
    has_form = (getattr(potential_fn, "diag_quadratic", None) is not None
                or (form is not None and kernels.generic_unsupported(
                    form, q.shape[-1]) is None))
    if q.device.type != "cuda":
        why = f"the state tensors are on {q.device}, not on a CUDA device"
    elif q.dtype != torch.float32:
        why = f"the fused kernels take float32, the state is {q.dtype}"
    elif integrator not in FUSED_INTEGRATORS:
        why = f"integrator {integrator!r} has no fused kernel"
    elif not has_form:
        why = ("the potential has no diag_quadratic and no device_form "
               f"for D={q.shape[-1]}")
    else:
        return "fused"
    if kernel == "fused":
        raise ValueError(f"kernel='fused' cannot run: {why}")
    return "composed"


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _combine_moments(rows: Tensor, n: int, d: int):
    """Chan et al.'s merge of the ranks' streamed ``(mean, m2)``, ``rows``
    ``[K, 2 D]`` in rank order, each over ``n`` draws: ``(mean, m2, K n)``.
    One rank's are returned as they are."""
    mean, m2, total = rows[0, :d], rows[0, d:], n
    for r in range(1, rows.shape[0]):
        n_new = total + n
        delta = rows[r, :d] - mean
        mean = mean + delta * (n / n_new)
        m2 = m2 + rows[r, d:] + delta**2 * (total * n / n_new)
        total = n_new
    return mean, m2, total


def run_hmc(
    seed: int,
    potential_fn: Callable[[Tensor], Tensor],
    init_q,
    *,
    num_warmup: int,
    num_samples: int,
    num_steps: int,
    init_step_size: float = 0.1,
    target_accept: float = 0.8,
    adapt_step_size: bool = True,
    adapt_mass: bool = True,
    mass: Union[float, Tensor] = 1.0,
    integrator: str = "leapfrog",
    temperature: float = 1.0,
    constants: Constants = NATURAL,
    collect: str = "samples",
    thin: int = 1,
    kernel: Union[str, HMCKernel] = "auto",
    metric: str = "diag",
    mesh=None,
) -> HMCRunResult:
    """Warmup-adapt and sample with ensemble HMC.

    Warmup: dual averaging of the step size on the ensemble-mean acceptance
    and a cross-walker estimate of the metric, refreshed at the window
    boundaries of :func:`~.adaptation.build_warmup_schedule`: with
    ``metric="diag"`` the variance (mass = 1/var), with ``metric="dense"``
    the covariance Sigma (:func:`build_dense_hmc_kernel`, whose result
    carries it as ``metric_cov``). Transition ``t`` of the run (warmup
    first, then sampling) uses key ``(seed, t)``. All adaptation state
    stays on the device; the loop never reads a value back.

    ``collect``: "samples" stacks every ``thin``-th position ``[S, W, D]``;
    "moments" streams the posterior mean/variance; "none" keeps only the
    diagnostics. ``kernel``: see :func:`resolve_engine`; with
    ``metric="dense"`` "auto" and "composed" run the dense step and
    "fused" raises. A built :class:`HMCKernel` is used as it is.

    ``mesh``: a walker group (``parallel.make_walker_mesh``); ``init_q`` is
    then this process's block of an ensemble split evenly over the group.
    The kernel is bound to the group (``parallel.shard_map_kernel``: the
    fused kernels draw by global walker index, the composed engine's seed
    has the rank folded in), and the loop's ensemble statistics are the
    group's: a warmup transition makes one all-reduce of a small packed
    vector (the acceptance and, in a metric window, the variance's batch
    terms, merged rank by rank with Chan's formula), a sampling transition
    none, and the end of sampling one (the rates and the streamed
    moments). Scalars and moments are the same on every rank; the state
    and samples are this rank's block. With ``metric="dense"`` the batch
    terms are the covariance's (``[D, D]`` a rank), and the dense step,
    composed, has the rank folded into its seed.
    """
    if collect not in ("samples", "moments", "none"):
        raise ValueError(f"bad collect={collect!r}")
    if metric not in ("diag", "dense"):
        raise ValueError(f"bad metric={metric!r} (want diag|dense)")
    q = torch.as_tensor(init_q, device=resolve_device(None, init_q))
    dense = metric == "dense"
    if isinstance(kernel, HMCKernel):
        if dense:
            raise ValueError("metric='dense' builds its own kernel: pass "
                             "kernel='auto' or 'composed'")
        hk = kernel
    elif dense:
        if kernel not in ("auto", "composed"):
            raise ValueError(
                f"kernel={kernel!r} cannot run metric='dense': no fused "
                f"kernel has a dense metric (want auto|composed)")
        if integrator not in FUSED_INTEGRATORS:
            raise ValueError(f"metric='dense' integrates with leapfrog; "
                             f"got integrator={integrator!r}")
        hk = build_dense_hmc_kernel(
            potential_fn, num_steps=num_steps, temperature=temperature,
            constants=constants)
    elif resolve_engine(kernel, potential_fn, q,
                        integrator=integrator) == "fused":
        hk = build_fused_hmc_kernel(
            potential_fn, num_steps=num_steps, temperature=temperature,
            constants=constants)
    else:
        hk = build_hmc_kernel(
            potential_fn, num_steps=num_steps, integrator=integrator,
            temperature=temperature, constants=constants)
    if mesh is None:
        mesh = hk.mesh
    if mesh is not None:
        if hk.mesh is None:
            from .parallel.sharded import shard_map_kernel
            hk = shard_map_kernel(hk, mesh)
        elif hk.mesh is not mesh:
            raise ValueError("the kernel is bound to another walker mesh")
    from .parallel.mesh import gather_rows
    state = hk.init(q, mass=mass)
    num_walkers, num_dims = state.ensemble.q.shape
    dtype, device = q.dtype, q.device
    cov = inv_chol = torch.eye(num_dims, dtype=dtype, device=device)

    def step(key, st, eps):
        if dense:
            return hk.step(key, st, eps, cov, inv_chol)
        return hk.step(key, st, eps)

    # ---- warmup -----------------------------------------------------------
    step_size = torch.full((), init_step_size, dtype=dtype, device=device)
    mass_arr = torch.broadcast_to(
        torch.as_tensor(mass, dtype=dtype, device=device), (num_dims,))
    t = 0
    for seg in build_warmup_schedule(num_warmup, adapt_mass=adapt_mass):
        da = da_init(step_size)
        track = seg.update_mass and adapt_mass
        est = (covariance_init if dense else variance_init)(
            num_dims, dtype, device)
        for _ in range(seg.length):
            state, info = step((seed, t), state, torch.exp(da.log_step))
            t += 1
            # every rank's mean and batch terms, merged in rank order
            accept = torch.mean(info.accept_prob).reshape(1)
            rows = gather_rows(torch.cat((accept, *batch_terms(
                state.ensemble.q, dense=dense))) if track else accept, mesh)
            if track:
                est = merge_batch_terms(est, rows[:, 1:])
            da = da_update(da, torch.mean(rows[:, 0]), target=target_accept,
                           enabled=adapt_step_size)
        if adapt_step_size:
            step_size = torch.exp(da.log_avg_step)
        if track and dense:
            cov = regularized_covariance(est)
            inv_chol = _inverse_cholesky(cov)
            mass_arr = 1.0 / torch.diagonal(cov)
        elif track:
            mass_arr = 1.0 / regularized_mass(est)
            state = state.replace(
                ensemble=state.ensemble.replace(mass=mass_arr))

    # ---- sampling ---------------------------------------------------------
    mean = torch.zeros((num_dims,), dtype=dtype, device=device)
    m2 = torch.zeros((num_dims,), dtype=dtype, device=device)
    n = 0
    accepts, divs, samples = [], [], []
    _synchronize(device)
    t0 = _time.perf_counter()
    for i in range(num_samples):
        state, info = step((seed, t), state, step_size)
        t += 1
        accepts.append(torch.mean(info.accept_prob))
        divs.append(torch.mean(info.divergent.to(dtype)))
        qs = state.ensemble.q
        if collect == "samples" and i % thin == 0:
            samples.append(qs)
        elif collect == "moments":
            n_new = n + num_walkers
            batch_var, batch_mean = torch.var_mean(qs, dim=0, correction=0)
            delta = batch_mean - mean
            mean = mean + delta * (num_walkers / n_new)
            m2 = (m2 + batch_var * num_walkers
                  + delta**2 * (n * num_walkers / n_new))
            n = n_new
    if num_samples:
        accept_rate = torch.mean(torch.stack(accepts))
        divergence_rate = torch.mean(torch.stack(divs))
    else:  # as the JAX package: the mean of no transitions is NaN
        accept_rate = torch.full((), math.nan, dtype=dtype, device=device)
        divergence_rate = accept_rate.clone()
    # the group's rates and moments (this process's alone without a mesh)
    rows = gather_rows(torch.cat((accept_rate.reshape(1),
                                  divergence_rate.reshape(1), mean, m2)), mesh)
    accept_rate = torch.sum(rows[:, 0]) / rows.shape[0]
    divergence_rate = torch.sum(rows[:, 1]) / rows.shape[0]
    if n:  # streamed moments
        mean, m2, n = _combine_moments(rows[:, 2:], n, num_dims)
    _synchronize(device)
    sampling_seconds = _time.perf_counter() - t0

    out_samples = post_mean = post_var = None
    if collect == "samples":
        out_samples = (torch.stack(samples) if samples else torch.empty(
            (0, num_walkers, num_dims), dtype=dtype, device=device))
    elif collect == "moments":
        post_mean = mean
        post_var = m2 / max(n - 1.0, 1.0)

    total_grads = ((num_warmup + num_samples) * num_walkers
                   * (1 if mesh is None else mesh.size)
                   * (hk.num_steps * hk.grad_evals_per_step + 1))
    variant = (hk.variant_for(num_walkers, num_dims, 1) if hk.kind == "fused"
               else "dense" if dense else "composed")
    return HMCRunResult(
        state=state, samples=out_samples, mean=post_mean, var=post_var,
        accept_rate=accept_rate, divergence_rate=divergence_rate,
        step_size=step_size, mass=mass_arr, num_grad_evals=total_grads,
        kernel_used=hk.kind, kernel_variant=variant,
        sampling_seconds=sampling_seconds,
        metric_cov=cov if dense else None)
