"""The hand-written CUDA kernels: wrappers beside their plain-torch versions
(the counterpart of the JAX package's ``ops/pallas_kernels.py``).

    A  fused_hmc_diag_quadratic   csrc/fused_hmc.cu  whole HMC transition
    B  fused_hmc_transition       csrc/fused_hmc.cu  whole HMC transition
    D  leapfrog_trajectory        csrc/leapfrog.cu   leapfrog trajectory
    E  nbody_accelerations_tiled  csrc/nbody.cu      N-body accelerations

Each wrapper takes the plain version for tensors on the CPU and launches
the kernel for CUDA tensors; any other device, a bad dtype, shape or
layout, a failed build or a failed launch raises. ``wrapper.launches``
counts the kernel's launches.

The transition kernels' plain versions draw the same Philox bits
(``ops/philox.py``), so for the same seed and transition index they agree
to float rounding. Their shared arguments: ``seed`` (64-bit run seed) and
``counter`` (transition index) key the draws; ``scalars`` is a float32
tensor ``[3]`` on q's device holding (step size, beta, potential scale);
``p_std`` and ``inv_mass`` are ``[D]``. With ``scale != 1`` forces and H
use ``scale * U`` while the returned (u, g) stay unscaled.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import philox
from ._build import load_library

Tensor = torch.Tensor

# Kernels B and D keep one dim-group of four per lane of a warp.
MAX_GENERIC_DIMS = 128
# Parameter floats a device form may stage in shared memory (128 KiB).
MAX_FORM_FLOATS = 32768
# device form -> (its id at the C entries, its parameter tensors' names)
# (csrc/forms.cuh with_form). Kernel D takes every form; kernel B all but
# "diag", the diagonal quadratic that kernel A runs.
FORM_IDS = {
    "gaussian": (0, ("mean", "precision")),
    "funnel": (1, ("params",)),
    "banana": (2, ("params",)),
    "mixture": (3, ("means", "log_weights", "inv_var")),
    "nbody": (4, ("mass", "consts")),
    "diag": (5, ("k_diag", "mean")),
}
GENERIC_FORMS = {k: v for k, v in FORM_IDS.items() if k != "diag"}


def _metropolis(seed: int, counter: int, h0: Tensor, h1: Tensor,
                beta: Tensor, threshold: float):
    derr = beta * (h1 - h0)
    derr = torch.where(torch.isfinite(derr), derr, torch.inf)
    divergent = derr > threshold
    log_u = torch.log(philox.accept_uniforms(seed, counter, h0.shape[0],
                                             h0.device))
    accepted = (log_u < -derr) & ~divergent
    accept_prob = torch.where(divergent, 0.0,
                              torch.exp(torch.clamp_max(-derr, 0.0)))
    return derr, accepted, accept_prob


def _momenta(seed: int, counter: int, q: Tensor, p_std: Tensor) -> Tensor:
    w, d = q.shape
    return p_std * philox.momentum_normals(seed, counter, w, d, q.device)


def _check(q: Tensor, named: dict, shapes: dict) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the kernels take CPU or CUDA tensors, got "
                         f"{q.device}")
    if q.ndim != 2 or q.shape[0] < 1 or q.shape[1] < 1:
        raise ValueError(f"q must be a non-empty [W, D] tensor, got "
                         f"{tuple(q.shape)}")
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shapes[name]}")


def _outputs(q: Tensor):
    w = q.shape[0]
    return (torch.empty_like(q), torch.empty_like(q),
            torch.empty(w, dtype=q.dtype, device=q.device),
            torch.empty(w, dtype=q.dtype, device=q.device),
            torch.empty(w, dtype=torch.uint8, device=q.device),
            torch.empty(w, dtype=q.dtype, device=q.device))


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = load_library().pbbi_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


# ---------------------------------------------------------------------------
# Kernel A: diagonal-quadratic potentials
# ---------------------------------------------------------------------------


def fused_hmc_diag_quadratic_plain(
    seed: int, counter: int, q: Tensor, *, scalars: Tensor, p_std: Tensor,
    inv_mass: Tensor, k_diag: Tensor, mean: Tensor, num_steps: int,
    divergence_threshold: float = 1000.0,
):
    """One HMC transition for ``U = 0.5 sum_d k_d (q_d - mean_d)^2``.

    Returns ``(q', g', u', accept_prob, accepted, energy_error)``; u and g
    are computed from q (no cached values in), g' is the gradient of the
    selected state.
    """
    dt, beta, s = scalars[0], scalars[1], scalars[2]
    p0 = _momenta(seed, counter, q, p_std)
    qc0 = q - mean
    u0 = 0.5 * torch.sum(k_diag * qc0 * qc0, dim=1)
    h0 = 0.5 * torch.sum(p0 * p0 * inv_mass, dim=1) + s * u0
    dtim = dt * inv_mass
    ck = dt * s
    p = p0 - (0.5 * ck) * (k_diag * qc0)
    q1 = q
    for _ in range(num_steps):
        q1 = q1 + p * dtim
        p = p - ck * (k_diag * (q1 - mean))
    qc1 = q1 - mean
    p = p + (0.5 * ck) * (k_diag * qc1)
    u1 = 0.5 * torch.sum(k_diag * qc1 * qc1, dim=1)
    h1 = 0.5 * torch.sum(p * p * inv_mass, dim=1) + s * u1
    derr, accepted, accept_prob = _metropolis(
        seed, counter, h0, h1, beta, divergence_threshold)
    q_sel = torch.where(accepted[:, None], q1, q)
    return (q_sel, k_diag * (q_sel - mean), torch.where(accepted, u1, u0),
            accept_prob, accepted, derr)


def fused_hmc_diag_quadratic(
    seed: int, counter: int, q: Tensor, *, scalars: Tensor, p_std: Tensor,
    inv_mass: Tensor, k_diag: Tensor, mean: Tensor, num_steps: int,
    divergence_threshold: float = 1000.0,
):
    """Kernel A. Replaces ``make_fused_hmc_diag_quadratic``
    (physicsbasedbayesianinference_tpu/ops/pallas_kernels.py:893); see
    :func:`fused_hmc_diag_quadratic_plain` for the contract. Any D."""
    if q.device.type == "cpu":
        return fused_hmc_diag_quadratic_plain(
            seed, counter, q, scalars=scalars, p_std=p_std,
            inv_mass=inv_mass, k_diag=k_diag, mean=mean,
            num_steps=num_steps, divergence_threshold=divergence_threshold)
    d = q.shape[-1]
    _check(q, {"q": q, "scalars": scalars, "p_std": p_std,
               "inv_mass": inv_mass, "k_diag": k_diag, "mean": mean},
           {"q": tuple(q.shape), "scalars": (3,), "p_std": (d,),
            "inv_mass": (d,), "k_diag": (d,), "mean": (d,)})
    outs = _outputs(q)
    q_out, g_out, u_out, acc, taken, derr = outs
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load_library().pbbi_fused_hmc_diag_quadratic(
            *map(Tensor.data_ptr,
                 (q, k_diag, mean, inv_mass, p_std, scalars, *outs)),
            q.shape[0], d, num_steps, divergence_threshold,
            seed & 0xFFFFFFFFFFFFFFFF, counter & 0xFFFFFFFF, stream)
    _raise_on(rc, "fused_hmc_diag_quadratic")
    fused_hmc_diag_quadratic.launches += 1
    return q_out, g_out, u_out, acc, taken.view(torch.bool), derr


fused_hmc_diag_quadratic.launches = 0  # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# Kernel B: potentials with a device form
# ---------------------------------------------------------------------------


def _param_shapes(device_form, d: int):
    """The shapes a form's parameters must have at dimension ``d``, and the
    count (mixture components, bodies) the kernel is told."""
    name, params = device_form
    if name == "gaussian":
        return {"mean": (d,), "precision": (d, d)}, 0
    if name == "diag":
        return {"k_diag": (d,), "mean": (d,)}, 0
    if name in ("funnel", "banana"):
        return {"params": (2,)}, 0
    if name == "mixture":
        k = params[0].shape[0]
        return {"means": (k, d), "log_weights": (k,), "inv_var": (1,)}, k
    n = params[0].shape[0]
    return {"mass": (n,), "consts": (2,)}, n


def _unsupported(device_form, num_dims: int, forms: dict,
                 kernel: str) -> Optional[str]:
    name, params = device_form
    if name not in forms:
        return f"unknown device form {name!r}; want one of {tuple(forms)}"
    if len(params) != len(forms[name][1]):
        return (f"device form {name!r} takes parameters "
                f"{forms[name][1]}, got {len(params)}")
    if not 1 <= num_dims <= MAX_GENERIC_DIMS:
        return (f"the {kernel} takes D <= {MAX_GENERIC_DIMS}, "
                f"got D={num_dims}")
    if name == "banana" and num_dims != 2:
        return f"the banana form takes D=2, got D={num_dims}"
    if name == "nbody" and num_dims % params[0].shape[0]:
        return (f"D={num_dims} is not a multiple of the "
                f"{params[0].shape[0]} bodies")
    shapes, _ = _param_shapes(device_form, num_dims)
    floats = sum(math.prod(shape) for shape in shapes.values())
    if floats > MAX_FORM_FLOATS:
        return (f"the {name} form's {floats} parameter floats exceed "
                f"{MAX_FORM_FLOATS} in shared memory")
    return None


def generic_unsupported(device_form, num_dims: int) -> Optional[str]:
    """Why kernel B cannot run ``device_form`` at ``num_dims``, or None
    when it can (the routing test of ``hmc.variant_for``)."""
    return _unsupported(device_form, num_dims, GENERIC_FORMS,
                        "generic fused kernel")


def leapfrog_unsupported(device_form, num_dims: int) -> Optional[str]:
    """Why kernel D cannot run ``device_form`` at ``num_dims``, or None
    when it can."""
    return _unsupported(device_form, num_dims, FORM_IDS, "leapfrog kernel")


def _diag_vg(k_diag, mean):
    def vg(q):
        qc = q - mean
        return 0.5 * torch.sum(k_diag * qc * qc, dim=1), k_diag * qc
    return vg


def _gaussian_vg(mean, prec):
    def vg(q):
        d = q - mean
        g = torch.zeros_like(q)
        for j in range(q.shape[1]):
            g = g + d[:, j:j + 1] * prec[j]
        return 0.5 * torch.sum(d * g, dim=1), g
    return vg


def _funnel_vg(fp):
    two_s2, half_dm1 = fp[0], fp[1]

    def vg(q):
        v, x = q[:, :1], q[:, 1:]
        sx = torch.zeros_like(v)
        for i in range(x.shape[1]):
            sx = sx + x[:, i:i + 1] * x[:, i:i + 1]
        ev = torch.exp(-v)
        gv = 2.0 * v / two_s2 + half_dm1 - 0.5 * ev * sx
        u = v * v / two_s2 + half_dm1 * v + 0.5 * ev * sx
        return u[:, 0], torch.cat([gv, ev * x], dim=1)
    return vg


def _banana_vg(ab):
    a, b = ab[0], ab[1]

    def vg(q):
        q0, q1 = q[:, 0], q[:, 1]
        t = q1 - q0 * q0
        g = torch.stack([-2.0 * (a - q0) - 4.0 * b * q0 * t, 2.0 * b * t],
                        dim=1)
        return (a - q0) * (a - q0) + b * (t * t), g
    return vg


def _mixture_vg(means, log_w, inv_var):
    def vg(q):
        d2 = torch.zeros(q.shape[0], means.shape[0], dtype=q.dtype,
                         device=q.device)
        for j in range(q.shape[1]):
            diff = q[:, j:j + 1] - means[:, j]
            d2 = d2 + diff * diff
        comp = log_w - 0.5 * inv_var * d2
        m = torch.amax(comp, dim=1, keepdim=True)
        ex = torch.exp(comp - m)
        s = torch.zeros_like(m)
        num = torch.zeros_like(q)
        for c in range(means.shape[0]):
            s = s + ex[:, c:c + 1]
            num = num + ex[:, c:c + 1] * (q - means[c])
        return -(m[:, 0] + torch.log(s[:, 0])), inv_var * num / s
    return vg


def _nbody_vg(mass, consts):
    big_g, eps2 = consts[0], consts[1]
    n = mass.shape[0]

    def vg(q):
        w, d = q.shape
        x = q.reshape(w, n, d // n)
        r = x[:, None, :, :] - x[:, :, None, :]  # r[:, i, j] = x_j - x_i
        d2 = torch.zeros(w, n, n, dtype=q.dtype, device=q.device)
        for c in range(d // n):
            d2 = d2 + r[..., c] * r[..., c]
        eye = torch.eye(n, dtype=torch.bool, device=q.device)
        inv = torch.where(eye, 0.0, 1.0 / torch.sqrt(d2 + eps2))
        inv3 = inv * inv * inv
        acc = torch.zeros_like(x)
        row = torch.zeros(w, n, dtype=q.dtype, device=q.device)
        for j in range(n):
            acc = acc + (mass[j] * inv3[:, :, j])[..., None] * r[:, :, j]
            row = row + mass[j] * inv[:, :, j]
        total = torch.zeros(w, dtype=q.dtype, device=q.device)
        for i in range(n):
            total = total + mass[i] * row[:, i]
        g = -mass[:, None] * (big_g * acc)
        return -0.5 * big_g * total, g.reshape(w, d)
    return vg


_PLAIN_FORMS = {"gaussian": _gaussian_vg, "funnel": _funnel_vg,
                "banana": _banana_vg, "mixture": _mixture_vg,
                "nbody": _nbody_vg, "diag": _diag_vg}


def device_value_and_grad(device_form):
    """Plain-torch ``q:[W, D] -> (U, grad)`` of a device form: the function
    kernels B and D evaluate, with their sums over dimensions, components
    and bodies taken in index order as the kernels take them."""
    name, params = device_form
    if name not in _PLAIN_FORMS:
        raise ValueError(f"unknown device form {name!r}; want one of "
                         f"{tuple(FORM_IDS)}")
    return _PLAIN_FORMS[name](*params)


def fused_hmc_transition_plain(
    device_form, seed: int, counter: int, q: Tensor, u: Tensor, g: Tensor,
    *, scalars: Tensor, p_std: Tensor, inv_mass: Tensor, num_steps: int,
    divergence_threshold: float = 1000.0,
):
    """One HMC transition for the potential named by ``device_form``, from
    cached unscaled ``(u, g)``. Returns ``(q', u', g', accept_prob,
    accepted, energy_error)``."""
    vg = device_value_and_grad(device_form)
    dt, beta, s = scalars[0], scalars[1], scalars[2]
    p0 = _momenta(seed, counter, q, p_std)
    h0 = 0.5 * torch.sum(p0 * p0 * inv_mass, dim=1) + s * u
    dtim = dt * inv_mass
    ck = dt * s
    p = p0 - (0.5 * ck) * g
    q1, u1, g1 = q, u, g
    for _ in range(num_steps):
        q1 = q1 + p * dtim
        u1, g1 = vg(q1)
        p = p - ck * g1
    p = p + (0.5 * ck) * g1
    h1 = 0.5 * torch.sum(p * p * inv_mass, dim=1) + s * u1
    derr, accepted, accept_prob = _metropolis(
        seed, counter, h0, h1, beta, divergence_threshold)
    sel = accepted[:, None]
    return (torch.where(sel, q1, q), torch.where(accepted, u1, u),
            torch.where(sel, g1, g), accept_prob, accepted, derr)


def fused_hmc_transition(
    device_form, seed: int, counter: int, q: Tensor, u: Tensor, g: Tensor,
    *, scalars: Tensor, p_std: Tensor, inv_mass: Tensor, num_steps: int,
    divergence_threshold: float = 1000.0,
):
    """Kernel B. Replaces ``make_fused_hmc_transition``
    (physicsbasedbayesianinference_tpu/ops/pallas_kernels.py:373) and, as
    one layout serves every D here, its walker-packed variant
    ``make_fused_hmc_packed`` (:576); see :func:`fused_hmc_transition_plain`
    and :func:`generic_unsupported` for what it takes."""
    if q.device.type == "cpu":
        return fused_hmc_transition_plain(
            device_form, seed, counter, q, u, g, scalars=scalars,
            p_std=p_std, inv_mass=inv_mass, num_steps=num_steps,
            divergence_threshold=divergence_threshold)
    name, params = device_form
    w, d = q.shape if q.ndim == 2 else (0, 0)
    why = generic_unsupported(device_form, d)
    if why is not None:
        raise ValueError(why)
    form_id, names = FORM_IDS[name]
    shapes, count = _param_shapes(device_form, d)
    named = dict(zip(names, params))
    _check(q, {"q": q, "u": u, "g": g, **named, "scalars": scalars,
               "p_std": p_std, "inv_mass": inv_mass},
           {"q": (w, d), "u": (w,), "g": (w, d), **shapes, "scalars": (3,),
            "p_std": (d,), "inv_mass": (d,)})
    param_ptrs = [t.data_ptr() for t in params]
    param_ptrs += [None] * (3 - len(param_ptrs))
    q_out, g_out, u_out, acc, taken, derr = _outputs(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load_library().pbbi_fused_hmc_transition(
            form_id, *param_ptrs, count,
            *map(Tensor.data_ptr,
                 (q, u, g, inv_mass, p_std, scalars,
                  q_out, u_out, g_out, acc, taken, derr)),
            w, d, num_steps, divergence_threshold,
            seed & 0xFFFFFFFFFFFFFFFF, counter & 0xFFFFFFFF, stream)
    _raise_on(rc, f"fused_hmc_transition[{name}]")
    fused_hmc_transition.launches += 1
    return q_out, u_out, g_out, acc, taken.view(torch.bool), derr


fused_hmc_transition.launches = 0  # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# Kernel D: the leapfrog trajectory alone
# ---------------------------------------------------------------------------


def leapfrog_trajectory_plain(
    device_form, q: Tensor, p: Tensor, *, step_size, num_steps: int,
    inv_mass, grad: Optional[Tensor] = None,
    potential_energy: Optional[Tensor] = None,
):
    """``num_steps`` kick-drift-kick steps of every walker under the
    potential named by ``device_form``; returns ``(q', p', u', g')``.

    Each step is ``p -= dt/2 g; q += dt p inv_mass; (u, g) at q; p -= dt/2
    g``, as the TPU kernel's loop. The cached ``(potential_energy, grad)``
    at q is used when both are given; otherwise g is evaluated at q."""
    vg = device_value_and_grad(device_form)
    dt = step_size
    if grad is None or potential_energy is None:
        u, g = vg(q)
    else:
        u, g = potential_energy, grad
    for _ in range(num_steps):
        p = p - (0.5 * dt) * g
        q = q + dt * p * inv_mass
        u, g = vg(q)
        p = p - (0.5 * dt) * g
    return q, p, u, g


def leapfrog_trajectory(
    device_form, q: Tensor, p: Tensor, *, step_size: Tensor, num_steps: int,
    inv_mass: Tensor, grad: Optional[Tensor] = None,
    potential_energy: Optional[Tensor] = None,
):
    """Kernel D. Replaces ``make_pallas_leapfrog``
    (physicsbasedbayesianinference_tpu/ops/pallas_kernels.py:140); see
    :func:`leapfrog_trajectory_plain` for the contract and
    :func:`leapfrog_unsupported` for the forms and shapes it takes.

    On CUDA: float32 ``q``, ``p`` ``[W, D]``, ``step_size`` a one-element
    float32 tensor on the device (read there, never on the host),
    ``inv_mass`` ``[D]``. Uses the cached ``(potential_energy, grad)``
    when given (both or neither), where the TPU kernel recomputed them at
    q; u' is the form's value at the final q."""
    if q.device.type == "cpu":
        return leapfrog_trajectory_plain(
            device_form, q, p, step_size=step_size, num_steps=num_steps,
            inv_mass=inv_mass, grad=grad, potential_energy=potential_energy)
    name, params = device_form
    w, d = q.shape if q.ndim == 2 else (0, 0)
    why = leapfrog_unsupported(device_form, d)
    if why is not None:
        raise ValueError(why)
    cached = grad is not None
    if cached != (potential_energy is not None):
        raise ValueError("pass grad and potential_energy together, or "
                         "neither")
    if not isinstance(step_size, Tensor) or step_size.numel() != 1:
        raise ValueError("kernel D takes one step size, as a one-element "
                         "tensor on the device")
    step = step_size.reshape(1)
    form_id, names = FORM_IDS[name]
    shapes, count = _param_shapes(device_form, d)
    named = {"q": q, "p": p, **dict(zip(names, params)), "step": step,
             "inv_mass": inv_mass}
    shapes.update(q=(w, d), p=(w, d), step=(1,), inv_mass=(d,))
    if cached:
        named.update(u=potential_energy, g=grad)
        shapes.update(u=(w,), g=(w, d))
    _check(q, named, shapes)
    param_ptrs = [t.data_ptr() for t in params]
    param_ptrs += [None] * (3 - len(param_ptrs))
    q_out, p_out, g_out = (torch.empty_like(q) for _ in range(3))
    u_out = torch.empty(w, dtype=q.dtype, device=q.device)
    cache_ptrs = ((potential_energy.data_ptr(), grad.data_ptr()) if cached
                  else (None, None))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load_library().pbbi_leapfrog_trajectory(
            form_id, *param_ptrs, count, q.data_ptr(), p.data_ptr(),
            *cache_ptrs,
            *map(Tensor.data_ptr, (inv_mass, step, q_out, p_out, u_out,
                                   g_out)),
            w, d, num_steps, stream)
    _raise_on(rc, f"leapfrog_trajectory[{name}]")
    leapfrog_trajectory.launches += 1
    return q_out, p_out, u_out, g_out


leapfrog_trajectory.launches = 0  # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# Kernel E: all-pairs gravitational accelerations
# ---------------------------------------------------------------------------

# float elements of one [rows, N] pair block of the plain version (64 MiB
# in float32 per temporary)
_PLAIN_PAIR_BLOCK = 1 << 24
_NBODY_DTYPES = {torch.float32: 0, torch.float64: 1}


def nbody_accelerations_tiled_plain(x: Tensor, mass: Tensor, *,
                                    g_const: float,
                                    softening: float) -> Tensor:
    """``a_i = G sum_{j != i} m_j r_ij / (|r_ij|^2 + eps^2)^{3/2}`` with
    ``r_ij = x_j - x_i``, for ``x`` ``[N, 3]``: the pairs of a block of
    target rows at a time, so that N = 16384 fits in memory. Each pair's
    terms are rounded as kernel E rounds them; the sums over sources are
    torch reductions, in another order than the kernel's."""
    n = x.shape[0]
    rows = max(1, _PLAIN_PAIR_BLOCK // n)
    soft2 = float(softening) ** 2
    out = torch.empty_like(x)
    cols = torch.arange(n, device=x.device)
    for start in range(0, n, rows):
        stop = min(n, start + rows)
        r = x[None, :, :] - x[start:stop, None, :]  # r[i, j] = x_j - x_i
        r2 = (r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1]
              + r[..., 2] * r[..., 2] + soft2)
        self_pair = cols[None, :] == torch.arange(
            start, stop, device=x.device)[:, None]
        inv = torch.where(self_pair, 0.0,
                          1.0 / torch.sqrt(torch.where(self_pair, 1.0, r2)))
        w = mass[None, :] * (inv * inv * inv)
        out[start:stop] = g_const * torch.sum(w[..., None] * r, dim=1)
    return out


def nbody_abs_sum(x: Tensor, mass: Tensor, *, g_const: float,
                  softening: float) -> Tensor:
    """``S_i = |G| sum_{j != i} |m_j| |r_ij| / (|r_ij|^2 + eps^2)^{3/2}``
    in float64, ``[N]``: the sum of the magnitudes of a_i's terms. Two
    summation orders of a_i in a dtype with unit roundoff u differ by about
    u sqrt(N) S_i, which states the tolerance between kernel E and its
    plain version."""
    x, mass = x.double(), mass.double().abs()
    n = x.shape[0]
    rows = max(1, _PLAIN_PAIR_BLOCK // n)
    soft2 = float(softening) ** 2
    out = torch.empty(n, dtype=torch.float64, device=x.device)
    cols = torch.arange(n, device=x.device)
    for start in range(0, n, rows):
        stop = min(n, start + rows)
        r = x[None, :, :] - x[start:stop, None, :]
        d2 = torch.sum(r * r, dim=-1)
        self_pair = cols[None, :] == torch.arange(
            start, stop, device=x.device)[:, None]
        terms = mass[None, :] * torch.sqrt(d2) / (d2 + soft2) ** 1.5
        out[start:stop] = torch.sum(torch.where(self_pair, 0.0, terms), 1)
    return abs(g_const) * out


def nbody_accelerations_tiled(x: Tensor, mass: Tensor, *, g_const: float,
                              softening: float) -> Tensor:
    """Kernel E. Replaces ``nbody_accelerations_pallas``
    (physicsbasedbayesianinference_tpu/ops/pallas_kernels.py:252); see
    :func:`nbody_accelerations_tiled_plain` for the contract. ``x``
    ``[N, 3]`` and ``mass`` ``[N]``, contiguous, both float32 or both
    float64; ``softening`` is eps, added as eps^2 to r^2. A body at the
    origin with eps = 0 gets a finite acceleration: the kernel has no
    padded sources."""
    if x.device.type == "cpu":
        return nbody_accelerations_tiled_plain(
            x, mass, g_const=g_const, softening=softening)
    if x.device.type != "cuda":
        raise ValueError(f"kernel E takes CPU or CUDA tensors, got "
                         f"{x.device}")
    if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] != 3:
        raise ValueError(f"x must be a non-empty [N, 3] tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _NBODY_DTYPES:
        raise ValueError(f"kernel E takes float32 or float64, got "
                         f"{x.dtype}")
    n = x.shape[0]
    if mass.device != x.device or mass.dtype != x.dtype or \
            tuple(mass.shape) != (n,):
        raise ValueError(f"mass must be [{n}] {x.dtype} on {x.device}, got "
                         f"{tuple(mass.shape)} {mass.dtype} on "
                         f"{mass.device}")
    if not (x.is_contiguous() and mass.is_contiguous()):
        raise ValueError("x and mass must be contiguous")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load_library().pbbi_nbody_accelerations(
            _NBODY_DTYPES[x.dtype], x.data_ptr(), mass.data_ptr(),
            out.data_ptr(), n, float(softening), float(g_const), stream)
    _raise_on(rc, "nbody_accelerations_tiled")
    nbody_accelerations_tiled.launches += 1
    return out


nbody_accelerations_tiled.launches = 0  # type: ignore[attr-defined]


KERNELS = (fused_hmc_diag_quadratic, fused_hmc_transition,
           leapfrog_trajectory, nbody_accelerations_tiled)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
