"""Ensemble state: the walker population as walker-major ``[W, D]`` tensors.

Port of the JAX package's ``ensemble.py``. A dataclass replaces the flax
pytree; ``replace`` returns a new state (tensors are shared, never mutated
in place). Randomness comes from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from .constants import Constants, NATURAL
from .device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class EnsembleState:
    """State of an ensemble of walkers.

    Attributes:
      q: positions ``[num_walkers, num_dims]``.
      p: momenta ``[num_walkers, num_dims]``.
      mass: diagonal metric, broadcastable against ``[W, D]``: scalar,
        per-dim ``[D]``, per-walker ``[W, 1]`` or full ``[W, D]``.
      log_weight: per-walker log importance weight ``[W]``.
    """

    q: Tensor
    p: Tensor
    mass: Tensor
    log_weight: Tensor

    @property
    def num_walkers(self) -> int:
        return self.q.shape[0]

    @property
    def num_dims(self) -> int:
        return self.q.shape[-1]

    def replace(self, **changes) -> "EnsembleState":
        return dataclasses.replace(self, **changes)


def new_ensemble(
    num_walkers: int,
    num_dims: int,
    *,
    mass: Union[float, Tensor] = 1.0,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> EnsembleState:
    """Zero-initialised ensemble with unit (or given) mass, zero weights,
    on ``device`` (``device.default_device()`` unless given)."""
    device = resolve_device(device)
    return EnsembleState(
        q=torch.zeros((num_walkers, num_dims), dtype=dtype, device=device),
        p=torch.zeros((num_walkers, num_dims), dtype=dtype, device=device),
        mass=torch.as_tensor(mass, dtype=dtype, device=device),
        log_weight=torch.zeros((num_walkers,), dtype=dtype, device=device),
    )


def sample_positions(
    generator: torch.Generator,
    state: EnsembleState,
    q_std: Union[float, Tensor],
    mean: Union[float, Tensor] = 0.0,
) -> EnsembleState:
    """Gaussian position initialisation, seeded by ``generator``."""
    noise = torch.randn(state.q.shape, generator=generator,
                        dtype=state.q.dtype, device=state.q.device)
    return state.replace(q=mean + q_std * noise)


def thermal_momentum_std(
    mass: Union[float, Tensor],
    temperature: Union[float, Tensor],
    constants: Constants = NATURAL,
) -> Tensor:
    """Maxwell-Boltzmann per-component momentum std ``sqrt(m k_B T)``."""
    return torch.sqrt(torch.as_tensor(mass) * constants.k_B * temperature)


def sample_momenta(
    generator: torch.Generator,
    state: EnsembleState,
    temperature: Union[float, Tensor] = 1.0,
    constants: Constants = NATURAL,
) -> EnsembleState:
    """Thermal (Maxwell-Boltzmann) momentum refresh."""
    p_std = thermal_momentum_std(state.mass, temperature, constants)
    noise = torch.randn(state.p.shape, generator=generator,
                        dtype=state.p.dtype, device=state.p.device)
    return state.replace(p=p_std * noise)


def kinetic_energy(p: Tensor, mass: Union[float, Tensor]) -> Tensor:
    """Per-walker kinetic energy ``sum_d p_d^2 / (2 m_d)``, [W, D] -> [W]."""
    return 0.5 * torch.sum(p * p / mass, dim=-1)


def velocities(p: Tensor, mass: Union[float, Tensor]) -> Tensor:
    """v = p / m (broadcasting diagonal mass)."""
    return p / mass


def walker(state: EnsembleState, index: int):
    """(q, p, mass, log_weight) of one walker; bounds checked."""
    n = state.num_walkers
    if not 0 <= index < n:
        raise IndexError(f"Index {index} out of bounds. num_walkers={n}")
    mass = torch.broadcast_to(state.mass, state.q.shape)
    return state.q[index], state.p[index], mass[index], state.log_weight[index]


def boltzmann_log_weights(
    state: EnsembleState,
    potential_energy: Tensor,
    temperature: Union[float, Tensor] = 1.0,
    constants: Constants = NATURAL,
) -> Tensor:
    """Normalised log canonical weights ``-beta H - logsumexp(-beta H)``."""
    h = kinetic_energy(state.p, state.mass) + potential_energy
    lw = -h * constants.beta(temperature)
    return lw - torch.logsumexp(lw, dim=0)
