"""N-body system state, conserved quantities and initial-condition IO (port
of the JAX package's ``physics/nbody.py``).

The state is a frozen dataclass of tensors (positions and velocities
``[N, D]``, masses ``[N]``, a scalar time) with ``replace``; every function
is vectorised over bodies and keeps a leading batch axis where the JAX one
does. The text format: header ``N tmax dt``, then N masses, N position rows
and N velocity rows.

:func:`accelerations` is the declared route to kernel E: an unbatched
``[N, 3]`` state on a CUDA device goes to the tiled CUDA kernel
(``ops/kernels.py`` ``nbody_accelerations_tiled``); a CPU state, and a
shape the kernel does not take (D != 3, a leading batch axis), go to the
plain ``ops.potentials.nbody_accelerations``. The choice is made from the
state's device and shape before any launch; nothing falls back after a
failure.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Union

import numpy as np
import torch

from ..constants import (
    AU_IN_METERS,
    Constants,
    DAY_IN_SECONDS,
    NATURAL,
    SI,
    SOLAR_MASS_IN_KG,
    solar_system_units,
)
from ..device import resolve_device
from ..ops import kernels
from ..ops.potentials import nbody_accelerations, nbody_potential_energy

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class NBodySystem:
    """Gravitational N-body state: ``x``/``v`` are ``[..., N, D]``,
    ``mass`` is ``[N]``, ``time`` a scalar tensor."""

    x: Tensor
    v: Tensor
    mass: Tensor
    time: Tensor

    @property
    def num_bodies(self) -> int:
        return self.x.shape[-2]

    @property
    def num_space_dims(self) -> int:
        return self.x.shape[-1]

    def replace(self, **changes) -> "NBodySystem":
        return dataclasses.replace(self, **changes)


def new_system(x, v, mass, *, time: float = 0.0, dtype=None,
               device=None) -> NBodySystem:
    """A system on ``device``; without one, where ``x`` lies if it is a
    tensor, else on ``device.default_device()``."""
    x = torch.as_tensor(x, dtype=dtype, device=resolve_device(device, x))
    return NBodySystem(
        x=x,
        v=torch.as_tensor(v, dtype=x.dtype, device=x.device),
        mass=torch.as_tensor(mass, dtype=x.dtype, device=x.device),
        time=torch.as_tensor(time, dtype=x.dtype, device=x.device),
    )


# ---------------------------------------------------------------------------
# Frames and conserved quantities
# ---------------------------------------------------------------------------


def center_of_mass_frame(system: NBodySystem) -> NBodySystem:
    """Shift to the centre-of-mass frame (position and velocity)."""
    total = torch.sum(system.mass, dim=-1, keepdim=True)
    w = (system.mass / total)[..., :, None]
    x_com = torch.sum(w * system.x, dim=-2, keepdim=True)
    v_com = torch.sum(w * system.v, dim=-2, keepdim=True)
    return system.replace(x=system.x - x_com, v=system.v - v_com)


def kinetic_energy(system: NBodySystem) -> Tensor:
    return 0.5 * torch.sum(
        system.mass * torch.sum(system.v * system.v, dim=-1), dim=-1)


def total_energy(system: NBodySystem, *, constants: Constants = NATURAL,
                 softening: float = 0.0) -> Tensor:
    """T + U. U is plain torch, over blocks of target rows at large N."""
    return kinetic_energy(system) + nbody_potential_energy(
        system.x, system.mass, constants=constants, softening=softening)


def total_angular_momentum(system: NBodySystem) -> Tensor:
    """|sum_i m_i x_i x v_i| (3D cross product over the last axis)."""
    ang = torch.sum(system.mass[..., :, None]
                    * torch.linalg.cross(system.x, system.v, dim=-1), dim=-2)
    return torch.linalg.norm(ang, dim=-1)


def accelerations(system: NBodySystem, *, constants: Constants = NATURAL,
                  softening: float = 0.0) -> Tensor:
    """Gravitational accelerations ``[..., N, D]``: kernel E for an
    unbatched ``[N, 3]`` CUDA state, the plain pairwise form otherwise
    (module docstring)."""
    x = system.x
    if x.device.type == "cuda" and x.ndim == 2 and x.shape[-1] == 3:
        return kernels.nbody_accelerations_tiled(
            x.contiguous(), system.mass.contiguous(), g_const=constants.G,
            softening=softening)
    return nbody_accelerations(x, system.mass, constants=constants,
                               softening=softening)


def jerk(x: Tensor, v: Tensor, mass: Tensor, *,
         constants: Constants = NATURAL, softening: float = 0.0) -> Tensor:
    """Time derivative of the gravitational acceleration (Hermite steps and
    the adaptive-dt criteria):

        da_i/dt = G sum_j m_j [ dv/r^3 - 3 (dr . dv) dr / r^5 ]

    over all pairs at once (plain torch, [N, N, D] tensors)."""
    n = x.shape[-2]
    dr = x[..., None, :, :] - x[..., :, None, :]  # [N, N, D], j - i
    dv = v[..., None, :, :] - v[..., :, None, :]
    dist2 = torch.sum(dr * dr, dim=-1) + softening**2
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    safe = torch.where(eye, 1.0, dist2)
    inv3 = torch.where(eye, 0.0, torch.rsqrt(safe) ** 3)
    inv5 = torch.where(eye, 0.0, torch.rsqrt(safe) ** 5)
    rdotv = torch.sum(dr * dv, dim=-1)
    term = (dv * inv3[..., None]
            - 3.0 * dr * (rdotv * inv5)[..., None])
    return constants.G * torch.sum(mass[None, :, None] * term, dim=-2)


def two_body_invariants(system: NBodySystem, *,
                        constants: Constants = NATURAL) -> dict:
    """Kepler invariants of the relative orbit of bodies 0 and 1: reduced
    angular momentum L, Runge-Lenz eccentricity |R| and semi-major axis
    a = |L|^2 / (G M mu^2 (1 - |R|^2))."""
    m0 = system.mass[..., 0]
    m1 = system.mass[..., 1]
    mu = m0 * m1 / (m0 + m1)
    rel_r = system.x[..., 0, :] - system.x[..., 1, :]
    rel_v = system.v[..., 0, :] - system.v[..., 1, :]
    ang = torch.linalg.cross(rel_r, rel_v, dim=-1) * mu[..., None]
    gm = constants.G * (m0 + m1)
    runge = (torch.linalg.cross(rel_v, ang / mu[..., None], dim=-1)
             / gm[..., None]
             - rel_r / torch.linalg.norm(rel_r, dim=-1, keepdim=True))
    l_nrm = torch.linalg.norm(ang, dim=-1)
    r_nrm = torch.linalg.norm(runge, dim=-1)
    a = (l_nrm / mu) ** 2 / (gm * (1.0 - r_nrm**2))
    return {"angular_momentum": l_nrm, "runge_lenz": r_nrm,
            "semi_major_axis": a}


# ---------------------------------------------------------------------------
# Initial conditions IO
# ---------------------------------------------------------------------------


def load_nbody_text(source: Union[str, io.TextIOBase], *,
                    dtype=torch.float64,
                    device=None) -> tuple[NBodySystem, float, float]:
    """Parse the N-body text format and return ``(system, tmax, dt)``.
    ``source`` is a filename, the raw text itself, or an open text file."""
    if isinstance(source, io.TextIOBase):
        text = source.read()
    elif "\n" in str(source):
        text = str(source)
    else:
        with open(source) as f:
            text = f.read()
    from ..native import parse_nbody_text
    mass_np, x_np, v_np, tmax, dt = parse_nbody_text(text)
    return new_system(x_np, v_np, mass_np, dtype=dtype,
                      device=device), tmax, dt


def save_nbody_text(system: NBodySystem, tmax: float, dt: float) -> str:
    """Serialise to the same text format (round-trips load_nbody_text)."""
    lines = [f"{system.num_bodies} {tmax} {dt}"]
    lines += [repr(m) for m in system.mass.tolist()]
    for arr in (system.x, system.v):
        lines += [" ".join(repr(c) for c in row) for row in arr.tolist()]
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

_EARTH_MASS_KG = 5.972e24
_SUN_MASS_KG = 1.989e30
_MOON_MASS_KG = 7.34e22
_EARTH_X_M = 1.52e11
_EARTH_VY_MS = 29_800.0
_MOON_DY_M = 3.844e8
_MOON_VZ_MS = 1_022.0


def solar_system(units: str = "astro", *,
                 device=None) -> tuple[NBodySystem, Constants]:
    """Earth-Sun-Moon: Earth at 1.52e11 m with 29.8 km/s, the Moon offset
    3.844e8 m with +1.022 km/s out of plane.

    ``units="si"``: metres/kg/seconds, float64 (SI gravitational energies
    overflow float32). ``units="astro"``: AU / M_sun / day, float32.
    Returns ``(system, constants)``.
    """
    mass_kg = [_EARTH_MASS_KG, _SUN_MASS_KG, _MOON_MASS_KG]
    x_m = [[_EARTH_X_M, 0.0, 0.0],
           [0.0, 0.0, 0.0],
           [_EARTH_X_M, _MOON_DY_M, 0.0]]
    v_ms = [[0.0, _EARTH_VY_MS, 0.0],
            [0.0, 0.0, 0.0],
            [0.0, _EARTH_VY_MS, _MOON_VZ_MS]]
    if units == "si":
        return new_system(x_m, v_ms, mass_kg, dtype=torch.float64,
                          device=device), SI
    if units == "astro":
        x = np.asarray(x_m) / AU_IN_METERS
        v = np.asarray(v_ms) * DAY_IN_SECONDS / AU_IN_METERS
        m = np.asarray(mass_kg) / SOLAR_MASS_IN_KG
        return (new_system(x, v, m, dtype=torch.float32, device=device),
                solar_system_units())
    raise ValueError(f"unknown units {units!r}")


def kepler_two_body(*, eccentricity: float = 0.5, mass_ratio: float = 1e-3,
                    dtype=torch.float32,
                    device=None) -> tuple[NBodySystem, Constants]:
    """A two-body Kepler orbit in natural units (G = 1, primary mass 1),
    starting at periapsis of an orbit with the given eccentricity and
    semi-major axis 1, in the centre-of-mass frame."""
    e = float(eccentricity)
    m1 = float(mass_ratio)
    r_peri = 1.0 - e
    # vis-viva with a = 1, GM = 1 + m1
    v_peri = (((1.0 + m1) * (2.0 / r_peri - 1.0)) ** 0.5)
    x = [[r_peri * m1 / (1 + m1), 0.0, 0.0],
         [-r_peri / (1 + m1), 0.0, 0.0]]
    v = [[0.0, v_peri * m1 / (1 + m1), 0.0],
         [0.0, -v_peri / (1 + m1), 0.0]]
    sys_ = new_system(x, v, [1.0, m1], dtype=dtype, device=device)
    return center_of_mass_frame(sys_), NATURAL
