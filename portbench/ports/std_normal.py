"""The program's D-dimensional standard normal, as its CLI builds
``builtin:std_normal_32d`` (a diagonal quadratic: kernel A)."""

from __future__ import annotations


def potential(data: dict, cfg: dict, device):
    from physicsbasedbayesianinference_tpu_torch.ops.potentials import (
        make_standard_normal)
    return make_standard_normal(cfg["num_dims"])
