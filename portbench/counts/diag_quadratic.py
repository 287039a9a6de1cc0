"""Kernel A (``diag_quadratic_kernel``): a whole transition of U = 0.5 sum_d
k_d (q_d - mu_d)^2, counted once a walker."""

from __future__ import annotations

from portbench.counts.common import bound_s, draw_ops, transition_bytes


def ops(w: int, d: int, steps: int) -> float:
    """Per dim 4 a leapfrog step (drift, q - mu, times k, kick) and some 10
    for the two energies and the half kicks, and the draws."""
    return w * (d * (4 * steps + 10) + draw_ops(d))


def transition_bound_s(w: int, d: int, steps: int, cfg: dict) -> float:
    return bound_s(transition_bytes(w, d, False), ops(w, d, steps))
