"""Kernel B's logistic form (``generic_kernel<LogisticForm>``): a whole
transition of Bayesian logistic regression over N rows, counted once a
walker."""

from __future__ import annotations

from portbench.counts.common import (SASS_EXPF, SASS_RCP, b_ops, bound_s,
                                     transition_bytes)


def gradient_ops(n: int, d: int) -> float:
    """z = x w + b and x^T r: N D multiply-adds each; a row's sigmoid (its
    negation, exponential, 1 + e and reciprocal) and residual and their
    bookkeeping, about 6 besides the two functions."""
    return 2 * n * d + n * (6 + SASS_EXPF + SASS_RCP)


def transition_bound_s(w: int, d: int, steps: int, cfg: dict) -> float:
    return bound_s(transition_bytes(w, d, True),
                   b_ops(w, d, steps, gradient_ops(cfg["num_rows"], d)))
