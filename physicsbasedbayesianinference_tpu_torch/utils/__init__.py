"""Utilities: moving state and parameters to and from the JAX package."""

from . import convert
from .convert import (hmc_state_from_jax, hmc_state_to_numpy,
                      nbody_system_from_numpy, potential_params_from_numpy)

__all__ = ["convert", "hmc_state_from_jax", "hmc_state_to_numpy",
           "nbody_system_from_numpy", "potential_params_from_numpy"]
