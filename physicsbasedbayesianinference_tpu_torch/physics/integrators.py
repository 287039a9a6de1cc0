"""The N-body integrator zoo (port of the JAX package's
``physics/integrators.py``).

Each integrator is a single-step function

    step(accel_fn, x, v, dt) -> (x', v')           (x, v: [N, D])

with no time loop of its own (the loops are in :mod:`.simulate`). Hermite
takes ``jerk_fn(x, v)`` too. Fixed-point and corrector loops run a fixed
number of times, as the JAX ``fori_loop``s do, so the number of
``accel_fn`` calls per step is known in advance: velocity Verlet calls it
twice per step (at x and at x').
"""

from __future__ import annotations

from typing import Callable

import torch

Tensor = torch.Tensor
AccelFn = Callable[[Tensor], Tensor]           # x:[N,D] -> a:[N,D]
JerkFn = Callable[[Tensor, Tensor], Tensor]    # (x, v) -> da/dt


def explicit_euler(accel_fn: AccelFn, x, v, dt):
    """x += v dt; v += a(x) dt. Not symplectic: the energy drifts."""
    a = accel_fn(x)
    return x + dt * v, v + dt * a


def symplectic_euler(accel_fn: AccelFn, x, v, dt):
    """Euler-Cromer: v += a(x) dt, then x += v' dt. First order."""
    v = v + dt * accel_fn(x)
    return x + dt * v, v


def explicit_midpoint(accel_fn: AccelFn, x, v, dt):
    """Derivatives evaluated at the half-step Euler prediction."""
    xm = x + 0.5 * dt * v
    vm = v + 0.5 * dt * accel_fn(x)
    return x + dt * vm, v + dt * accel_fn(xm)


def velocity_verlet(accel_fn: AccelFn, x, v, dt):
    """Kick-drift-kick leapfrog: two ``accel_fn`` calls per step."""
    a = accel_fn(x)
    v = v + 0.5 * dt * a
    x = x + dt * v
    v = v + 0.5 * dt * accel_fn(x)
    return x, v


def position_verlet(accel_fn: AccelFn, x, v, dt):
    """Drift-kick-drift."""
    x = x + 0.5 * dt * v
    v = v + dt * accel_fn(x)
    x = x + 0.5 * dt * v
    return x, v


def stormer_verlet(accel_fn: AccelFn, x, v, dt):
    """Störmer-Verlet in one-step form with exact velocity: algebraically
    velocity Verlet."""
    return velocity_verlet(accel_fn, x, v, dt)


def rk4(accel_fn: AccelFn, x, v, dt):
    """Classical 4th-order Runge-Kutta on the (x, v) system."""
    k1x, k1v = v, accel_fn(x)
    k2x, k2v = v + 0.5 * dt * k1v, accel_fn(x + 0.5 * dt * k1x)
    k3x, k3v = v + 0.5 * dt * k2v, accel_fn(x + 0.5 * dt * k2x)
    k4x, k4v = v + dt * k3v, accel_fn(x + dt * k3x)
    x = x + (dt / 6.0) * (k1x + 2 * k2x + 2 * k3x + k4x)
    v = v + (dt / 6.0) * (k1v + 2 * k2v + 2 * k3v + k4v)
    return x, v


def implicit_midpoint(accel_fn: AccelFn, x, v, dt, *, num_iters: int = 8):
    """Implicit midpoint rule, solved by ``num_iters`` fixed-point
    iterations. Symplectic and time-reversible."""
    x_next, v_next = x, v
    for _ in range(num_iters):
        a_mid = accel_fn(0.5 * (x + x_next))
        v_next = v + dt * a_mid
        x_next = x + dt * 0.5 * (v + v_next)
    return x_next, v_next


def hermite(accel_fn: AccelFn, jerk_fn: JerkFn, x, v, dt, *,
            num_corrector_iters: int = 2):
    """4th-order Hermite predictor-corrector: Taylor predict with the jerk,
    then ``num_corrector_iters`` Makino-Aarseth corrector passes."""
    a = accel_fn(x)
    j = jerk_fn(x, v)
    xc = x + dt * v + (dt**2 / 2.0) * a + (dt**3 / 6.0) * j
    vc = v + dt * a + (dt**2 / 2.0) * j
    for _ in range(num_corrector_iters):
        ap = accel_fn(xc)
        jp = jerk_fn(xc, vc)
        vc = v + (dt / 2.0) * (a + ap) + (dt**2 / 12.0) * (j - jp)
        xc = x + (dt / 2.0) * (v + vc) + (dt**2 / 12.0) * (a - ap)
    return xc, vc


# Dormand-Prince 5(4) tableau.
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)


def rk45_step(accel_fn: AccelFn, x, v, dt):
    """One embedded Dormand-Prince 5(4) step on the joint (x, v) system
    (seven ``accel_fn`` calls). Returns ``(x5, v5, err_x, err_v)``: the
    5th-order solution and the (5th - 4th)-order error estimate."""
    kx, kv = [], []
    for row in _DP_A:
        xs = x + dt * sum(c * k for c, k in zip(row, kx))
        vs = v + dt * sum(c * k for c, k in zip(row, kv))
        kx.append(vs)
        kv.append(accel_fn(xs))
    x5 = x + dt * sum(b * k for b, k in zip(_DP_B5, kx))
    v5 = v + dt * sum(b * k for b, k in zip(_DP_B5, kv))
    err_x = dt * sum((b5 - b4) * k
                     for b5, b4, k in zip(_DP_B5, _DP_B4, kx))
    err_v = dt * sum((b5 - b4) * k
                     for b5, b4, k in zip(_DP_B5, _DP_B4, kv))
    return x5, v5, err_x, err_v


INTEGRATORS = {
    "explicit_euler": explicit_euler,
    "symplectic_euler": symplectic_euler,
    "explicit_midpoint": explicit_midpoint,
    "velocity_verlet": velocity_verlet,
    "leapfrog": velocity_verlet,
    "position_verlet": position_verlet,
    "stormer_verlet": stormer_verlet,
    "rk4": rk4,
    "implicit_midpoint": implicit_midpoint,
}

NEEDS_JERK = {"hermite": hermite}


def get_physics_integrator(name: str):
    if name in INTEGRATORS:
        return INTEGRATORS[name]
    if name in NEEDS_JERK:
        return NEEDS_JERK[name]
    raise ValueError(
        f"Invalid integration method {name!r}; available: "
        f"{sorted(INTEGRATORS) + sorted(NEEDS_JERK)}")
