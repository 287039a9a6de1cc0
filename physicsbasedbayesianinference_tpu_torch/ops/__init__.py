"""Compute ops: potentials, integrators, the Philox stream and the fused
CUDA transition kernels (built on first use, never at import)."""

from . import integrators, kernels, philox, potentials
from .integrators import INTEGRATORS, get_integrator
from .potentials import (
    batched_value_and_grad,
    builtin_potentials,
    harmonic_potential,
    make_banana,
    make_funnel,
    make_gaussian,
    make_gaussian_mixture,
    make_harmonic,
    make_nbody_potential,
    make_standard_normal,
    nbody_accelerations,
    nbody_potential_energy,
    no_potential,
)

__all__ = [
    "integrators",
    "kernels",
    "philox",
    "potentials",
    "INTEGRATORS",
    "get_integrator",
    "batched_value_and_grad",
    "builtin_potentials",
    "harmonic_potential",
    "make_banana",
    "make_funnel",
    "make_gaussian",
    "make_gaussian_mixture",
    "make_harmonic",
    "make_nbody_potential",
    "make_standard_normal",
    "nbody_accelerations",
    "nbody_potential_energy",
    "no_potential",
]
