"""Plain reference of the D-dimensional standard normal, U = |q|^2 / 2, and
the benchmark's inputs for it: no data, and walkers started from the
stationary distribution, as ``bench.py``'s configuration starts them.
Imports nothing of the program."""

from __future__ import annotations

import torch

from portbench.reference.hmc import Precision


def make_data(cfg: dict, seed: int, device) -> dict:
    return {}


def init_q(cfg: dict, num_walkers: int, gen: torch.Generator) -> torch.Tensor:
    return torch.randn(num_walkers, cfg["num_dims"], generator=gen,
                       device=gen.device)


def value_and_grad(data: dict, prec: Precision):
    def vg(q):
        return 0.5 * torch.sum(q * q, dim=1), q
    return vg
