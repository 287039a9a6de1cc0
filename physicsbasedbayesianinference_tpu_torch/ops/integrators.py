"""Symplectic splitting integrators over ``[W, D]`` tensors (port of the JAX
package's ``ops/integrators.py``).

A palindromic table of momentum kicks (p -= c dt grad U) and position
drifts (q += c dt p / m) becomes a Python loop over steps; the gradient is
recomputed only where a kick follows a drift. ``lax.scan`` becomes that
loop. ``pallas_leapfrog`` runs the whole trajectory in one launch of
kernel D on CUDA (``ops/kernels.py`` ``leapfrog_trajectory``); the
registry holds the same names as the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from . import kernels

Tensor = torch.Tensor
ValueAndGradFn = Callable[[Tensor], Tuple[Tensor, Tensor]]

_KICK = "K"
_DRIFT = "D"


def num_steps_for_time(final_time: float, step_size: float) -> int:
    """Number of steps covering [0, final_time] (rounded, >= 1)."""
    return max(1, int(round(final_time / step_size)))


def make_splitting_integrator(stages: Sequence[Tuple[str, float]],
                              name: str = "splitting"):
    """Build ``integrate(vg_fn, q, p, *, step_size, num_steps, inv_mass,
    grad=None, potential_energy=None) -> (q, p, potential_energy, grad)``
    from a kick/drift coefficient table (coefficients of each kind sum to
    1). ``step_size`` is a scalar or per-walker ``[W, 1]``."""
    stages = tuple((k, float(c)) for k, c in stages)
    for kind, _ in stages:
        if kind not in (_KICK, _DRIFT):
            raise ValueError(f"bad stage kind {kind!r}")
    for kind in (_KICK, _DRIFT):
        total = sum(c for k, c in stages if k == kind)
        if abs(total - 1.0) > 1e-12:
            raise ValueError(
                f"{name}: {kind} coefficients sum to {total}, not 1")

    ends_with_kick = stages[-1][0] == _KICK
    grad_evals = 0
    fresh = ends_with_kick
    for kind, _ in stages:
        if kind == _KICK and not fresh:
            grad_evals += 1
            fresh = True
        elif kind == _DRIFT:
            fresh = False

    def integrate(vg_fn: ValueAndGradFn, q: Tensor, p: Tensor, *,
                  step_size, num_steps: int, inv_mass,
                  grad: Tensor | None = None,
                  potential_energy: Tensor | None = None):
        dt = step_size
        u, g = potential_energy, grad
        if g is None or u is None:
            u, g = vg_fn(q)
        for _ in range(num_steps):
            fresh = ends_with_kick
            for kind, c in stages:
                if kind == _KICK:
                    if not fresh:
                        u, g = vg_fn(q)
                        fresh = True
                    p = p - (c * dt) * g
                else:
                    q = q + (c * dt) * p * inv_mass
                    fresh = False
        if not ends_with_kick:
            u, g = vg_fn(q)
        return q, p, u, g

    integrate.stages = stages  # type: ignore[attr-defined]
    integrate.grad_evals_per_step = max(  # type: ignore[attr-defined]
        grad_evals, 1)
    integrate.name = name  # type: ignore[attr-defined]
    return integrate


leapfrog = make_splitting_integrator(
    [(_KICK, 0.5), (_DRIFT, 1.0), (_KICK, 0.5)], name="leapfrog")
velocity_verlet = leapfrog

position_verlet = make_splitting_integrator(
    [(_DRIFT, 0.5), (_KICK, 1.0), (_DRIFT, 0.5)], name="position_verlet")

# McLachlan (1995) 2-stage minimal-error 2nd-order scheme.
_MCL_B = 0.1931833275037836
mclachlan = make_splitting_integrator(
    [(_KICK, _MCL_B), (_DRIFT, 0.5), (_KICK, 1.0 - 2.0 * _MCL_B),
     (_DRIFT, 0.5), (_KICK, _MCL_B)],
    name="mclachlan")

# Yoshida (1990) 4th-order triple-jump composition of velocity Verlet.
_Y_W1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_Y_W0 = 1.0 - 2.0 * _Y_W1
yoshida4 = make_splitting_integrator(
    [(_KICK, _Y_W1 / 2), (_DRIFT, _Y_W1), (_KICK, (_Y_W1 + _Y_W0) / 2),
     (_DRIFT, _Y_W0), (_KICK, (_Y_W0 + _Y_W1) / 2), (_DRIFT, _Y_W1),
     (_KICK, _Y_W1 / 2)],
    name="yoshida4")


def stormer_verlet(vg_fn: ValueAndGradFn, q: Tensor, p: Tensor, *,
                   step_size, num_steps: int, inv_mass,
                   grad: Tensor | None = None,
                   potential_energy: Tensor | None = None):
    """Two-step position recursion q_{n+1} = 2 q_n - q_{n-1} + a(q_n) dt^2,
    final momentum from a backward difference (1st order in p)."""
    dt = step_size
    if grad is None or potential_energy is None:
        potential_energy, grad = vg_fn(q)
    v = p * inv_mass
    q_prev = q
    q = q + v * dt + (0.5 * dt * dt) * (-grad * inv_mass)
    for _ in range(max(num_steps - 1, 0)):
        _, g = vg_fn(q)
        q_prev, q = q, 2.0 * q - q_prev + (dt * dt) * (-g * inv_mass)
    v = (q - q_prev) / dt
    p = v / inv_mass
    potential_energy, grad = vg_fn(q)
    return q, p, potential_energy, grad


stormer_verlet.grad_evals_per_step = 1  # type: ignore[attr-defined]
stormer_verlet.name = "stormer_verlet"  # type: ignore[attr-defined]


def _leapfrog_form(vg_fn, device, d: int):
    """The device form kernel D runs for ``vg_fn`` at dimension ``d``, its
    parameters as contiguous float32 tensors on ``device``: the diagonal
    quadratic when the potential has one (kernel A's targets), else its
    ``device_form``. Prepared once per device and D and kept on ``vg_fn``,
    so a trajectory issues no host-to-device copy."""
    prepared = vg_fn.__dict__.setdefault("leapfrog_forms", {})
    key = (str(device), d)
    if key in prepared:
        return prepared[key]
    diag = getattr(vg_fn, "diag_quadratic", None)
    form = getattr(vg_fn, "device_form", None)
    if diag is not None:
        form = ("diag", tuple(
            torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32),
                               (d,)) for v in diag))
    elif form is None:
        raise ValueError(
            "integrator 'pallas_leapfrog' on CUDA runs kernel D, which "
            "needs the potential's diag_quadratic or device_form; this "
            "potential has neither")
    why = kernels.leapfrog_unsupported(form, d)
    if why is not None:
        raise ValueError(f"integrator 'pallas_leapfrog' on CUDA: {why}")
    prepared[key] = (form[0], tuple(
        t.to(device=device, dtype=torch.float32).contiguous()
        for t in form[1]))
    return prepared[key]


def _on_device(value, shape, what: str, device) -> Tensor:
    """``value`` as a contiguous float32 tensor of ``shape`` on ``device``;
    a Python number is filled there (a kernel, not a host copy)."""
    if not isinstance(value, Tensor):
        return torch.full(shape, float(value), dtype=torch.float32,
                          device=device)
    if value.numel() not in (1, shape[0]):
        raise ValueError(f"kernel D takes {what}, got shape "
                         f"{tuple(value.shape)}")
    return torch.broadcast_to(
        value.to(device=device, dtype=torch.float32).reshape(-1),
        shape).contiguous()


def pallas_leapfrog(vg_fn: ValueAndGradFn, q: Tensor, p: Tensor, *,
                    step_size, num_steps: int, inv_mass,
                    grad: Tensor | None = None,
                    potential_energy: Tensor | None = None):
    """The JAX package's ``pallas_leapfrog`` (kick-drift-kick, one gradient
    per step). On CPU tensors it is :func:`leapfrog`. On CUDA it is one
    launch of kernel D with the potential's device form (see
    :func:`_leapfrog_form`; a potential without one raises): one step
    size, read on the device, a ``[D]`` or scalar inverse mass, and the
    cached ``(potential_energy, grad)`` used when given."""
    if q.device.type == "cpu":
        return leapfrog(vg_fn, q, p, step_size=step_size,
                        num_steps=num_steps, inv_mass=inv_mass, grad=grad,
                        potential_energy=potential_energy)
    d = q.shape[-1]
    form = _leapfrog_form(vg_fn, q.device, d)
    return kernels.leapfrog_trajectory(
        form, q.contiguous(), p.contiguous(),
        step_size=_on_device(step_size, (1,), "one step size", q.device),
        num_steps=num_steps,
        inv_mass=_on_device(inv_mass, (d,), "a [D] or scalar inverse mass",
                            q.device),
        grad=None if grad is None else grad.contiguous(),
        potential_energy=(None if potential_energy is None
                          else potential_energy.contiguous()))


pallas_leapfrog.grad_evals_per_step = 1  # type: ignore[attr-defined]
pallas_leapfrog.name = "pallas_leapfrog"  # type: ignore[attr-defined]


INTEGRATORS = {
    "leapfrog": leapfrog,
    "velocity_verlet": velocity_verlet,
    "position_verlet": position_verlet,
    "mclachlan": mclachlan,
    "yoshida4": yoshida4,
    "stormer_verlet": stormer_verlet,
    "pallas_leapfrog": pallas_leapfrog,
}


def get_integrator(name: str):
    """Look up an integrator by name; ValueError lists the valid ones."""
    try:
        return INTEGRATORS[name]
    except KeyError:
        raise ValueError(
            f"Invalid integration method {name!r}; "
            f"available: {sorted(INTEGRATORS)}") from None
