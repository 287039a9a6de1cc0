"""Carry sampler state, N-body systems and potential parameters between the
JAX package and the port as numpy arrays (neither side imports the
other).

The numpy form of an HMC state is a dict with keys ``q``, ``p``, ``mass``,
``log_weight``, ``potential_energy`` and ``grad``: for a JAX state,
``{"q": np.asarray(state.ensemble.q), ..., "grad": np.asarray(state.grad)}``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..device import resolve_device
from ..ensemble import EnsembleState
from ..hmc import HMCState
from ..ops import potentials
from ..physics.nbody import NBodySystem

STATE_KEYS = ("q", "p", "mass", "log_weight", "potential_energy", "grad")
NBODY_KEYS = ("x", "v", "mass", "time")


def hmc_state_from_jax(state: Mapping[str, np.ndarray],
                       device=None) -> HMCState:
    """The port's ``HMCState`` from a JAX state given as numpy arrays; the
    values are copied exactly (same dtype), onto ``device``
    (``device.default_device()`` unless given)."""
    missing = [k for k in STATE_KEYS if k not in state]
    if missing:
        raise KeyError(f"state dict lacks {missing}")
    device = resolve_device(device)
    t = {k: torch.as_tensor(np.asarray(state[k])).to(device)
         for k in STATE_KEYS}
    ens = EnsembleState(q=t["q"], p=t["p"], mass=t["mass"],
                        log_weight=t["log_weight"])
    return HMCState(ensemble=ens, potential_energy=t["potential_energy"],
                    grad=t["grad"])


def hmc_state_to_numpy(state: HMCState) -> dict:
    """The numpy form of an ``HMCState`` (host copies)."""
    ens = state.ensemble
    values = (ens.q, ens.p, ens.mass, ens.log_weight,
              state.potential_energy, state.grad)
    return {k: v.detach().cpu().numpy() for k, v in zip(STATE_KEYS, values)}


def nbody_system_from_numpy(system: Mapping[str, np.ndarray],
                            device=None) -> NBodySystem:
    """The port's ``NBodySystem`` from a JAX one given as numpy arrays
    (``{"x": np.asarray(s.x), "v": ..., "mass": ..., "time": ...}``); the
    values are copied exactly (same dtype), onto ``device``
    (``device.default_device()`` unless given)."""
    missing = [k for k in NBODY_KEYS if k not in system]
    if missing:
        raise KeyError(f"system dict lacks {missing}")
    device = resolve_device(device)
    return NBodySystem(**{k: torch.as_tensor(np.array(system[k])).to(device)
                          for k in NBODY_KEYS})


def potential_params_from_numpy(kind: str, params: Mapping,
                                device=None):
    """The port's potential from the numpy parameters of the matching JAX
    constructor: ``"gaussian"`` takes ``mean`` and ``cov`` or
    ``precision``; ``"funnel"`` ``num_dims`` and ``sigma``; ``"banana"``
    ``a`` and ``b``; ``"mixture"`` ``means``, ``sigma`` and
    ``log_weights``; ``"nbody"`` ``mass``, ``num_bodies``,
    ``num_space_dims`` and ``softening``."""
    if kind == "gaussian":
        return potentials.make_gaussian(
            params["mean"], cov=params.get("cov"),
            precision=params.get("precision"), device=device)
    if kind == "funnel":
        return potentials.make_funnel(
            int(params["num_dims"]), float(params.get("sigma", 3.0)),
            device=device)
    if kind == "banana":
        return potentials.make_banana(float(params.get("a", 1.0)),
                                      float(params.get("b", 100.0)),
                                      device=device)
    if kind == "mixture":
        return potentials.make_gaussian_mixture(
            params["means"], float(params.get("sigma", 1.0)),
            params.get("log_weights"), device=device)
    if kind == "nbody":
        return potentials.make_nbody_potential(
            params["mass"], int(params["num_bodies"]),
            int(params.get("num_space_dims", 3)),
            softening=float(params.get("softening", 0.0)), device=device)
    raise ValueError(f"unknown potential kind {kind!r} "
                     f"(want gaussian|funnel|banana|mixture|nbody)")
