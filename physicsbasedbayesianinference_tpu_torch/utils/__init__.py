"""Utilities: moving state and parameters to and from the JAX package,
tree helpers, and the plot helpers (matplotlib, loaded on first use)."""

from . import convert, trees
from .convert import (hmc_state_from_jax, hmc_state_to_numpy,
                      nbody_system_from_numpy, potential_params_from_numpy)
from .trees import ravel_ensemble, tree_bytes, tree_summary

__all__ = ["convert", "trees", "plotting", "hmc_state_from_jax",
           "hmc_state_to_numpy", "nbody_system_from_numpy",
           "potential_params_from_numpy", "ravel_ensemble", "tree_bytes",
           "tree_summary"]


def __getattr__(name):
    # the matplotlib helpers load on first use (importlib: ``from . import``
    # would re-enter this __getattr__ through _handle_fromlist)
    if name == "plotting":
        import importlib
        return importlib.import_module(".plotting", __name__)
    raise AttributeError(name)
