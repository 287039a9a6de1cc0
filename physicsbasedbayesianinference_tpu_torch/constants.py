"""Physical constants and unit systems (port of the JAX package's
``constants.py``; pure Python, no tensor code).

* ``NATURAL`` (default): k_B = G = 1, so "temperature" is the tempering
  parameter beta = 1/(k_B T).
* ``SI``: CODATA 2018 values, for physics-mode simulation in float64.
* ``solar_system_units()``: AU / solar-mass / day units, float32-safe.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Constants:
    """Physical constants used by thermodynamic scaling and gravity.

    Attributes:
      k_B: Boltzmann constant. Thermal momenta have per-component std
        ``sqrt(mass * k_B * T)``.
      G: gravitational constant for N-body potentials.
    """

    k_B: float = 1.0
    G: float = 1.0

    def beta(self, temperature: float) -> float:
        """Inverse temperature 1 / (k_B * T)."""
        return 1.0 / (self.k_B * temperature)


NATURAL = Constants(k_B=1.0, G=1.0)

SI = Constants(k_B=1.380649e-23, G=6.6743e-11)

_AU = 1.495978707e11
_MSUN = 1.98892e30
_DAY = 86400.0
_G_ASTRO = 6.6743e-11 * _MSUN * _DAY**2 / _AU**3


def solar_system_units() -> Constants:
    """Constants in AU / M_sun / day units (G ~= 2.96e-4, float32-safe)."""
    return Constants(k_B=1.0, G=_G_ASTRO)


AU_IN_METERS = _AU
SOLAR_MASS_IN_KG = _MSUN
DAY_IN_SECONDS = _DAY
