"""Analytic target potentials and N-body energies/forces (port of the JAX
package's ``ops/potentials.py``).

Every potential is a function of positions ``q: [..., D] -> [...]`` (one
walker or a batch; the last axis is reduced). Attributes read by the
sampler:

* ``analytic_grad``: closed-form ``q -> dU/dq``, used instead of autodiff.
* ``diag_quadratic``: ``(k_diag, mean)`` for ``U = 0.5 sum_d k_d (q_d -
  mean_d)^2``; routes a CUDA transition to the diagonal-quadratic kernel.
* ``device_form``: ``(name, parameter tensors)`` that the generic fused
  CUDA kernel (B) and the leapfrog kernel (D) evaluate in-kernel
  (``ops/kernels.py`` ``FORM_IDS``):
  ``("gaussian", (mean [D], precision [D, D]))``, ``("funnel", ((2
  sigma^2, (num_dims - 1) / 2),))``, ``("banana", ((a, b),))``,
  ``("mixture", (means [K, D], log_weights [K], (1 / sigma^2,)))`` or
  ``("nbody", (mass [N], (G, softening^2)))``. This replaces tracing a
  jaxpr into the kernel.

Parameter tensors live on the ``device`` given to the constructor
(without one: where the first parameter lies if it is a tensor, else on
``device.default_device()``, the card when there is one); a potential
evaluated on another device copies them on every call.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from ..constants import Constants, NATURAL
from ..device import resolve_device

Tensor = torch.Tensor
PotentialFn = Callable[[Tensor], Tensor]


def _attach(fn: PotentialFn, *, analytic_grad: Optional[Callable] = None,
            name: str = "", diag_quadratic=None,
            device_form=None) -> PotentialFn:
    fn.analytic_grad = analytic_grad  # type: ignore[attr-defined]
    fn.name = name or fn.__name__  # type: ignore[attr-defined]
    fn.diag_quadratic = diag_quadratic  # type: ignore[attr-defined]
    fn.device_form = device_form  # type: ignore[attr-defined]
    return fn


def _param(x, device) -> Tensor:
    """Float parameters become float32 tensors, as ``jnp.asarray`` does."""
    t = torch.as_tensor(x)
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(device)


def _like(t: Tensor, q: Tensor) -> Tensor:
    return t.to(dtype=q.dtype, device=q.device)


# ---------------------------------------------------------------------------
# Simple analytic targets
# ---------------------------------------------------------------------------


def harmonic_potential(q: Tensor, spring_consts) -> Tensor:
    """ND harmonic potential ``0.5 * sum_d k_d q_d^2`` over the last axis."""
    k = torch.as_tensor(spring_consts, dtype=q.dtype, device=q.device)
    return 0.5 * torch.sum(k * q * q, dim=-1)


def make_harmonic(spring_consts, *, device=None) -> PotentialFn:
    k = _param(spring_consts, resolve_device(device, spring_consts))

    def potential(q):
        return harmonic_potential(q, _like(k, q))

    def grad(q):
        return _like(k, q) * q

    return _attach(potential, analytic_grad=grad, name="harmonic",
                   diag_quadratic=(k, 0.0))


def make_standard_normal(num_dims: int) -> PotentialFn:
    """U(q) = 0.5 |q|^2: standard normal target."""

    def potential(q):
        return 0.5 * torch.sum(q * q, dim=-1)

    def grad(q):
        return q

    return _attach(potential, analytic_grad=grad,
                   name=f"std_normal_{num_dims}d",
                   diag_quadratic=(1.0, 0.0))


def make_gaussian(mean, cov=None, precision=None, *,
                  device=None) -> PotentialFn:
    """Multivariate Gaussian ``U(q) = 0.5 (q-mu)^T P (q-mu)``.

    Supply ``cov`` (inverted through its Cholesky factor, in float32 on the
    CPU, as the JAX constructor does) or ``precision``.
    """
    device = resolve_device(device, mean)
    mean = _param(mean, "cpu")
    if precision is None:
        if cov is None:
            raise ValueError("need cov or precision")
        cov = _param(cov, "cpu")
        chol = torch.linalg.cholesky(cov)
        eye = torch.eye(cov.shape[-1], dtype=cov.dtype)
        inv_chol = torch.linalg.solve_triangular(chol, eye, upper=False)
        precision = inv_chol.T @ inv_chol
    else:
        precision = _param(precision, "cpu")
    off_diag = precision - torch.diag(torch.diagonal(precision))
    is_diag = bool(torch.all(off_diag == 0.0))
    mean, precision = mean.to(device), precision.to(device)

    def potential(q):
        d = q - _like(mean, q)
        return 0.5 * torch.sum(d * (d @ _like(precision, q)), dim=-1)

    def grad(q):
        return (q - _like(mean, q)) @ _like(precision, q)

    diag = (torch.diagonal(precision), mean) if is_diag else None
    return _attach(potential, analytic_grad=grad, name="gaussian",
                   diag_quadratic=diag,
                   device_form=("gaussian", (mean, precision)))


def make_banana(a: float = 1.0, b: float = 100.0, *,
                device=None) -> PotentialFn:
    """2D Rosenbrock target ``(a - q0)^2 + b (q1 - q0^2)^2``."""

    def potential(q):
        q0, q1 = q[..., 0], q[..., 1]
        return (a - q0) ** 2 + b * (q1 - q0**2) ** 2

    def grad(q):
        q0, q1 = q[..., 0], q[..., 1]
        d0 = -2.0 * (a - q0) - 4.0 * b * q0 * (q1 - q0**2)
        d1 = 2.0 * b * (q1 - q0**2)
        return torch.stack([d0, d1], dim=-1)

    params = torch.tensor([a, b], dtype=torch.float32,
                          device=resolve_device(device))
    return _attach(potential, analytic_grad=grad, name="banana",
                   device_form=("banana", (params,)))


def make_funnel(num_dims: int = 10, sigma: float = 3.0, *,
                device=None) -> PotentialFn:
    """Neal's funnel: v ~ N(0, sigma^2); x_i | v ~ N(0, e^v).

    U(v, x) = v^2/(2 sigma^2) + (D-1) v / 2 + e^{-v} |x|^2 / 2. The JAX
    package differentiates it by autodiff; here the closed form is attached
    (the generic CUDA kernel evaluates the same formula).
    """
    two_s2 = 2.0 * sigma**2
    half_dm1 = 0.5 * (num_dims - 1)

    def potential(q):
        v = q[..., 0]
        x = q[..., 1:]
        return (v * v / two_s2 + half_dm1 * v
                + 0.5 * torch.exp(-v) * torch.sum(x * x, dim=-1))

    def grad(q):
        v = q[..., :1]
        x = q[..., 1:]
        ev = torch.exp(-v)
        gv = (2.0 * v / two_s2 + half_dm1
              - 0.5 * ev * torch.sum(x * x, dim=-1, keepdim=True))
        return torch.cat([gv, ev * x], dim=-1)

    params = torch.tensor([two_s2, half_dm1], dtype=torch.float32,
                          device=resolve_device(device))
    return _attach(potential, analytic_grad=grad, name=f"funnel_{num_dims}d",
                   device_form=("funnel", (params,)))


def make_gaussian_mixture(means, sigma: float = 1.0, log_weights=None, *,
                          device=None) -> PotentialFn:
    """Isotropic Gaussian mixture ``-logsumexp_k (log w_k - |q - mu_k|^2 /
    (2 sigma^2))``; ``means``: ``[K, D]``."""
    device = resolve_device(device, means)
    mu = _param(means, device)
    k_comp = mu.shape[0]
    lw = (torch.zeros((k_comp,), device=device) if log_weights is None
          else _param(log_weights, device))
    inv_var = 1.0 / (sigma * sigma)

    def potential(q):
        d2 = torch.sum((q[..., None, :] - _like(mu, q)) ** 2, dim=-1)
        comp = _like(lw, q) - 0.5 * inv_var * d2
        return -torch.logsumexp(comp, dim=-1)

    iv = torch.tensor([inv_var], dtype=torch.float32, device=device)
    return _attach(potential, name=f"gaussian_mixture_{k_comp}",
                   device_form=("mixture", (mu, lw, iv)))


def no_potential(q: Tensor) -> Tensor:
    """U = 0: free flight."""
    return torch.zeros(q.shape[:-1], dtype=q.dtype, device=q.device)


# U = 0 is the diagonal quadratic with k = 0, so the CUDA path runs it
# through the diagonal-quadratic kernel.
_attach(no_potential, analytic_grad=torch.zeros_like, name="no_potential",
        diag_quadratic=(0.0, 0.0))


# ---------------------------------------------------------------------------
# Gravitational N-body (plain torch; kernel E, ops/kernels.py
# nbody_accelerations_tiled, is the CUDA route of physics/nbody.py)
# ---------------------------------------------------------------------------


def pairwise_displacements(x: Tensor) -> Tensor:
    """r_ij = x_j - x_i for x: [..., N, D] -> [..., N, N, D]."""
    return x[..., None, :, :] - x[..., :, None, :]


# target rows per block of the pairwise energy: [rows, N] pairs of at most
# 2^24 elements, so N = 16384 needs no [N, N, D] tensor
_ENERGY_PAIR_BLOCK = 1 << 24


def nbody_potential_energy(x: Tensor, mass: Tensor, *,
                           constants: Constants = NATURAL,
                           softening: float = 0.0) -> Tensor:
    """Total gravitational energy ``-G sum_{i<j} m_i m_j / r_ij``, over
    blocks of target rows (one block up to N = 4096)."""
    n = x.shape[-2]
    rows = max(1, _ENERGY_PAIR_BLOCK // n)
    cols = torch.arange(n, device=x.device)
    total = None
    for start in range(0, n, rows):
        stop = min(n, start + rows)
        r = x[..., None, :, :] - x[..., start:stop, None, :]
        dist2 = torch.sum(r * r, dim=-1) + softening**2
        eye = cols[None, :] == torch.arange(start, stop,
                                            device=x.device)[:, None]
        inv_dist = torch.where(
            eye, 0.0, torch.rsqrt(torch.where(eye, 1.0, dist2)))
        mm = mass[start:stop, None] * mass[None, :]
        part = torch.sum(mm * inv_dist, dim=(-2, -1))
        total = part if total is None else total + part
    return -0.5 * constants.G * total


def nbody_accelerations(x: Tensor, mass: Tensor, *,
                        constants: Constants = NATURAL,
                        softening: float = 0.0) -> Tensor:
    """Accelerations ``a_i = G sum_{j != i} m_j r_ij / |r_ij|^3``."""
    n = x.shape[-2]
    r = pairwise_displacements(x)
    dist2 = torch.sum(r * r, dim=-1) + softening**2
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    inv_dist3 = torch.where(
        eye, 0.0, torch.rsqrt(torch.where(eye, 1.0, dist2)) ** 3)
    contrib = (mass[None, :] * inv_dist3)[..., :, :, None] * r
    return constants.G * torch.sum(contrib, dim=-2)


def make_nbody_potential(mass, num_bodies: int, num_space_dims: int = 3, *,
                         constants: Constants = NATURAL,
                         softening: float = 0.0,
                         device=None) -> PotentialFn:
    """N-body energy over the flattened configuration ``q: [N * D]``;
    ``analytic_grad`` is the exact force."""
    device = resolve_device(device, mass)
    mass = _param(mass, device)
    consts = torch.tensor([constants.G, softening**2], dtype=torch.float32,
                          device=device)

    def potential(q):
        x = q.reshape(*q.shape[:-1], num_bodies, num_space_dims)
        return nbody_potential_energy(x, _like(mass, q), constants=constants,
                                      softening=softening)

    def grad(q):
        x = q.reshape(*q.shape[:-1], num_bodies, num_space_dims)
        m = _like(mass, q)
        acc = nbody_accelerations(x, m, constants=constants,
                                  softening=softening)
        return (-m[:, None] * acc).reshape(q.shape)

    return _attach(potential, analytic_grad=grad,
                   name=f"nbody_{num_bodies}x{num_space_dims}",
                   device_form=("nbody", (mass, consts)))


# ---------------------------------------------------------------------------
# Numerical differentiation (the reference's numerical force path)
# ---------------------------------------------------------------------------


def numerical_grad(potential_fn: PotentialFn,
                   eps: float = 1e-4) -> Callable[[Tensor], Tensor]:
    """Central-difference gradient ``q:[D] -> dU/dq:[D]``, an oracle for
    testing closed-form and autograd gradients (the JAX package's; the
    reference differentiates forward with ``scipy.optimize.approx_fprime``,
    potential.py:104-138). All 2D perturbed positions are evaluated in one
    batched call."""
    batched = torch.func.vmap(potential_fn)

    def grad(q: Tensor) -> Tensor:
        d = q.shape[-1]
        basis = eps * torch.eye(d, dtype=q.dtype, device=q.device)
        u = batched(torch.cat((q[None, :] + basis, q[None, :] - basis)))
        return (u[:d] - u[d:]) / (2.0 * eps)

    return grad


def numerical_force(potential_fn: PotentialFn,
                    eps: float = 1e-4) -> Callable[[Tensor], Tensor]:
    """``F = -grad U`` by central differences (the reference's
    ``nBodyForce``, potential.py:104-119)."""
    g = numerical_grad(potential_fn, eps)
    return lambda q: -g(q)


# ---------------------------------------------------------------------------
# Batched value-and-grad
# ---------------------------------------------------------------------------


def batched_value_and_grad(
    potential_fn: PotentialFn, *, use_analytic: bool = True
) -> Callable[[Tensor], tuple[Tensor, Tensor]]:
    """``q:[W, D] -> (U:[W], grad:[W, D])``: the closed-form gradient when
    the potential has one, else ``vmap(grad_and_value(f))``. The returned
    function carries the potential's ``diag_quadratic`` and
    ``device_form``, which the ``pallas_leapfrog`` integrator hands to
    kernel D on CUDA."""
    ag = getattr(potential_fn, "analytic_grad", None)
    if use_analytic and ag is not None:
        def vg(q):
            return potential_fn(q), ag(q)
    else:
        gv = torch.func.vmap(torch.func.grad_and_value(potential_fn))

        def vg(q):
            g, u = gv(q)
            return u, g
    vg.diag_quadratic = getattr(  # type: ignore[attr-defined]
        potential_fn, "diag_quadratic", None)
    vg.device_form = getattr(  # type: ignore[attr-defined]
        potential_fn, "device_form", None)
    return vg


@functools.lru_cache(maxsize=None)
def builtin_potentials(device=None) -> dict:
    """Registry of zero-arg builtin target constructors for the CLI, their
    parameters on ``device`` (``default_device()`` unless given)."""
    device = resolve_device(device)
    return {
        "std_normal_2d": lambda: make_standard_normal(2),
        "std_normal_32d": lambda: make_standard_normal(32),
        "banana": lambda: make_banana(device=device),
        "funnel_10d": lambda: make_funnel(10, device=device),
        "bimodal_2d": lambda: make_gaussian_mixture(
            torch.tensor([[-3.0, 0.0], [3.0, 0.0]]), device=device),
    }
