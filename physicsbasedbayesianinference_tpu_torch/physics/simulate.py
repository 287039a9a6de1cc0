"""Trajectory drivers: fixed-step runs and adaptive timestepping (port of
the JAX package's ``physics/simulate.py``).

The JAX ``lax.scan`` over save blocks becomes a Python loop that writes
every ``save_every``-th state and its energy and angular momentum into
preallocated ``[num_saves, ...]`` tensors; it reads nothing back to the
host. The adaptive drivers keep the JAX version's static ``max_steps``
buffers and ``num_valid`` count; their ``while_loop`` becomes a host loop
that reads its condition (``t < final_time``) back once per step.

The accelerations go through :func:`.nbody.accelerations`, so a ``[N, 3]``
state on a CUDA device runs kernel E.
"""

from __future__ import annotations

import dataclasses

import torch

from ..constants import Constants, NATURAL
from . import integrators as phyint
from .nbody import (
    NBodySystem,
    accelerations,
    jerk,
    total_angular_momentum,
    total_energy,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Trajectory:
    """Recorded simulation output. ``x``/``v``: [num_saves, N, D];
    ``times``/``energy``/``angular_momentum``: [num_saves]; ``final``: the
    end state; ``num_valid``: saves actually filled, a Python int
    (== num_saves for fixed-step runs; <= for adaptive runs)."""

    x: Tensor
    v: Tensor
    times: Tensor
    energy: Tensor
    angular_momentum: Tensor
    initial_energy: Tensor
    final: NBodySystem
    num_valid: int


def _diag(system: NBodySystem, constants: Constants, softening: float):
    return (total_energy(system, constants=constants, softening=softening),
            total_angular_momentum(system))


def _accel_fn(system, constants, softening):
    return lambda x: accelerations(system.replace(x=x), constants=constants,
                                   softening=softening)


def _stepper(method, system, constants, softening):
    """``step(x, v, dt) -> (x', v')`` of ``method`` on ``system``'s bodies
    (with the jerk for the methods that need it)."""
    step_fn = phyint.get_physics_integrator(method)
    accel = _accel_fn(system, constants, softening)
    if method in phyint.NEEDS_JERK:
        def jerk_fn(x, v):
            return jerk(x, v, system.mass, constants=constants,
                        softening=softening)
        return lambda x, v, dt: step_fn(accel, jerk_fn, x, v, dt)
    return lambda x, v, dt: step_fn(accel, x, v, dt)


def _buffers(system: NBodySystem, length: int):
    x = system.x
    scalar = torch.zeros((length,), dtype=x.dtype, device=x.device)
    return (torch.zeros((length,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device),
            torch.zeros((length,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device),
            scalar, scalar.clone(), scalar.clone())


def _scalar(value, like: Tensor) -> Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def simulate(
    system: NBodySystem,
    dt: float,
    num_steps: int,
    *,
    method: str = "velocity_verlet",
    save_every: int = 1,
    constants: Constants = NATURAL,
    softening: float = 0.0,
) -> Trajectory:
    """Integrate ``num_steps`` fixed steps, saving every ``save_every``-th
    state with its energy and angular momentum.

    ``num_steps`` must be divisible by ``save_every``.
    """
    if num_steps % save_every != 0:
        raise ValueError(
            f"num_steps={num_steps} not divisible by save_every={save_every}")
    step = _stepper(method, system, constants, softening)
    dt = _scalar(dt, system.x)
    num_saves = num_steps // save_every
    xs, vs, ts, es, ls = _buffers(system, num_saves)
    e0, _ = _diag(system, constants, softening)
    x, v, t = system.x, system.v, system.time
    for s in range(num_saves):
        for _ in range(save_every):
            x, v = step(x, v, dt)
            t = t + dt
        e, l = _diag(system.replace(x=x, v=v, time=t), constants, softening)
        xs[s], vs[s], ts[s], es[s], ls[s] = x, v, t, e, l
    return Trajectory(x=xs, v=vs, times=ts, energy=es, angular_momentum=ls,
                      initial_energy=e0,
                      final=system.replace(x=x, v=v, time=t),
                      num_valid=num_saves)


# ---------------------------------------------------------------------------
# Adaptive timestep criteria
# ---------------------------------------------------------------------------


def adaptive_dt_simple(system: NBodySystem, dt0, *,
                       constants: Constants = NATURAL,
                       softening: float = 0.0) -> Tensor:
    """Aarseth-style criterion: dt = dt0 * min_i |a_i| / |da_i/dt|."""
    a = accelerations(system, constants=constants, softening=softening)
    da = jerk(system.x, system.v, system.mass,
              constants=constants, softening=softening)
    a_nrm = torch.sqrt(torch.sum(a * a, dim=-1))
    da_nrm = torch.sqrt(torch.sum(da * da, dim=-1)) + 1e-300
    return dt0 * torch.amin(a_nrm / da_nrm, dim=-1)


def adaptive_dt_advanced(system: NBodySystem, dt0, *,
                         constants: Constants = NATURAL,
                         softening: float = 0.0) -> Tensor:
    """Higher-derivative criterion: estimate the 2nd and 3rd acceleration
    derivatives from a dt0 Taylor prediction and take
    dt = dt0 * min_i sqrt( (|a||a2| + |da|^2) / (|da||a3| + |a2|^2) )."""
    x, v, m = system.x, system.v, system.mass
    dt0 = _scalar(dt0, x)
    a = accelerations(system, constants=constants, softening=softening)
    da = jerk(x, v, m, constants=constants, softening=softening)
    vp = v + dt0 * a + 0.5 * dt0**2 * da
    xp = x + dt0 * v + 0.5 * dt0**2 * a + (dt0**3 / 6.0) * da
    ap = accelerations(system.replace(x=xp), constants=constants,
                       softening=softening)
    dap = jerk(xp, vp, m, constants=constants, softening=softening)
    a2 = -6.0 * (a - ap) / dt0**2 - 2.0 * (2.0 * da + dap) / dt0
    a3 = 12.0 * (a - ap) / dt0**3 + 6.0 * (da + dap) / dt0**2

    def nrm(z):
        return torch.sqrt(torch.sum(z * z, dim=-1))

    val = ((nrm(a) * nrm(a2) + torch.sum(da * da, dim=-1))
           / (nrm(da) * nrm(a3) + torch.sum(a2 * a2, dim=-1) + 1e-300))
    return dt0 * torch.amin(torch.sqrt(val), dim=-1)


def simulate_adaptive(
    system: NBodySystem,
    dt0: float,
    final_time: float,
    *,
    method: str = "velocity_verlet",
    criterion: str = "simple",
    max_steps: int = 10_000,
    constants: Constants = NATURAL,
    softening: float = 0.0,
) -> Trajectory:
    """Adaptive-dt integration to ``final_time``: each step re-derives dt
    from the chosen criterion, clipped so as not to overshoot. The
    ``max_steps`` buffers hold every accepted step; ``num_valid`` says how
    many are filled. The loop reads ``t < final_time`` back to the host
    once per step."""
    step = _stepper(method, system, constants, softening)
    crit = {"simple": adaptive_dt_simple,
            "advanced": adaptive_dt_advanced}[criterion]
    final_time = _scalar(final_time, system.x)
    xs, vs, ts, es, ls = _buffers(system, max_steps)

    e0, _ = _diag(system, constants, softening)
    x, v, t = system.x, system.v, system.time
    i = 0
    while i < max_steps and bool(t < final_time):
        sys_t = system.replace(x=x, v=v, time=t)
        dt = crit(sys_t, dt0, constants=constants, softening=softening)
        dt = torch.minimum(dt, final_time - t)
        x, v = step(x, v, dt)
        t = t + dt
        e, l = _diag(system.replace(x=x, v=v, time=t), constants, softening)
        xs[i], vs[i], ts[i], es[i], ls[i] = x, v, t, e, l
        i += 1
    return Trajectory(x=xs, v=vs, times=ts, energy=es, angular_momentum=ls,
                      initial_energy=e0,
                      final=system.replace(x=x, v=v, time=t), num_valid=i)


def simulate_rk45(
    system: NBodySystem,
    dt0: float,
    final_time: float,
    *,
    rtol: float = 1e-6,
    atol: float = 1e-9,
    max_steps: int = 10_000,
    constants: Constants = NATURAL,
    softening: float = 0.0,
) -> Trajectory:
    """Error-controlled Dormand-Prince 5(4) integration to ``final_time``.
    Scaled RMS error norm over (x, v), accept when <= 1, dt *= clip(0.9
    err^{-1/5}, 0.2, 5); a rejected step retries with the shrunk dt,
    advances no time and fills no slot. The loop reads the accept decision
    and ``t < final_time`` back to the host together, once per attempt."""
    accel = _accel_fn(system, constants, softening)
    x = system.x
    final_time = _scalar(final_time, x)
    xs, vs, ts, es, ls = _buffers(system, max_steps)

    def err_norm(err, ref_a, ref_b):
        scale = atol + rtol * torch.maximum(torch.abs(ref_a),
                                            torch.abs(ref_b))
        return torch.sqrt(torch.mean((err / scale) ** 2))

    e0, _ = _diag(system, constants, softening)
    v, t, dt = system.v, system.time, _scalar(dt0, x)
    i = tries = 0
    running = bool(t < final_time)
    while running and i < max_steps and tries < 8 * max_steps:
        dt_c = torch.minimum(dt, final_time - t)
        xn, vn, err_x, err_v = phyint.rk45_step(accel, x, v, dt_c)
        err = torch.maximum(err_norm(err_x, x, xn), err_norm(err_v, v, vn))
        accept = err <= 1.0
        factor = torch.clamp(0.9 * (err + 1e-30) ** -0.2, 0.2, 5.0)
        dt = dt_c * factor
        x = torch.where(accept, xn, x)
        v = torch.where(accept, vn, v)
        t = torch.where(accept, t + dt_c, t)
        e, l = _diag(system.replace(x=x, v=v, time=t), constants, softening)
        accepted, running = torch.stack(
            (accept, t < final_time)).tolist()
        # the JAX version's dummy slot: a rejected attempt selects the last
        # slot and writes it back unchanged
        slot = i if accepted else max_steps - 1
        for buf, val in ((xs, x), (vs, v), (ts, t), (es, e), (ls, l)):
            buf[slot] = torch.where(accept, val, buf[slot])
        i += int(accepted)
        tries += 1
    return Trajectory(x=xs, v=vs, times=ts, energy=es, angular_momentum=ls,
                      initial_energy=e0,
                      final=system.replace(x=x, v=v, time=t), num_valid=i)


def energy_drift(traj: Trajectory) -> Tensor:
    """|E_t - E_0| / |E_0| over saved states, relative to the energy of the
    initial state."""
    e0 = traj.initial_energy
    return torch.abs(traj.energy - e0) / torch.abs(e0)
