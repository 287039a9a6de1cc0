"""Warmup adaptation: dual-averaging step size + cross-walker metric (port
of the JAX package's ``adaptation.py``).

Every state is a dataclass of tensors on the sampler's device: an update
is a handful of device ops and never reads a value back to the host, so
the warmup loop does not synchronise on each transition.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import torch

from .device import resolve_device

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Dual averaging (step size)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DualAveragingState:
    log_step: Tensor
    log_avg_step: Tensor
    h_bar: Tensor
    t: Tensor
    mu: Tensor


def da_init(step_size, *, mu_factor: float = 10.0) -> DualAveragingState:
    """Start dual averaging at ``step_size`` (a float or a 0-d tensor,
    whose device the state takes; a float goes to
    ``device.default_device()``)."""
    log_step = torch.log(torch.as_tensor(
        step_size, dtype=torch.float32,
        device=resolve_device(None, step_size)))
    z = torch.zeros_like(log_step)
    return DualAveragingState(log_step=log_step, log_avg_step=log_step,
                              h_bar=z, t=z, mu=math.log(mu_factor) + log_step)


def da_update(
    state: DualAveragingState,
    accept_prob: Tensor,
    *,
    target: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
    enabled: bool = True,
) -> DualAveragingState:
    """One dual-averaging update from the ensemble-mean acceptance
    (Hoffman & Gelman 2014, eq. 6)."""
    if not enabled:
        return state
    t = state.t + 1.0
    eta_h = 1.0 / (t + t0)
    h_bar = (1.0 - eta_h) * state.h_bar + eta_h * (target - accept_prob)
    log_step = state.mu - torch.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_avg_step = eta * log_step + (1.0 - eta) * state.log_avg_step
    return DualAveragingState(log_step=log_step, log_avg_step=log_avg_step,
                              h_bar=h_bar, t=t, mu=state.mu)


# ---------------------------------------------------------------------------
# Streaming cross-walker variance (diagonal metric)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VarianceState:
    mean: Tensor  # [D]
    m2: Tensor  # [D]
    count: Tensor  # scalar


def variance_init(num_dims: int, dtype=torch.float32,
                  device=None) -> VarianceState:
    device = resolve_device(device)
    return VarianceState(
        mean=torch.zeros((num_dims,), dtype=dtype, device=device),
        m2=torch.zeros((num_dims,), dtype=dtype, device=device),
        count=torch.zeros((), dtype=dtype, device=device))


def _valid_rows(q: Tensor, max_abs: float) -> Tensor:
    """[W] mask of walkers safe to stream into a metric estimate: finite and
    below ``max_abs`` in every coordinate (a finite |q| ~ 1e13 overflows the
    squared moments in float32). Excluded from the estimate only, never from
    the chain."""
    return torch.all(torch.isfinite(q) & (torch.abs(q) < max_abs), dim=-1)


def variance_batch(q: Tensor, *, max_abs: float = 1e6):
    """A [W, D] slab's terms for :func:`variance_merge`: ``(w, batch mean,
    batch m2)`` over its valid rows (``w`` their count)."""
    valid = _valid_rows(q, max_abs)
    w = torch.sum(valid.to(q.dtype))
    vcol = valid[:, None].to(q.dtype)
    # zero non-finite ENTRIES before any masked arithmetic: 0 * inf = NaN
    qf = torch.where(torch.isfinite(q), q, 0.0)
    batch_mean = torch.sum(qf * vcol, dim=0) / torch.clamp_min(w, 1.0)
    batch_m2 = torch.sum(((qf - batch_mean) * vcol) ** 2, dim=0)
    return w, batch_mean, batch_m2


def variance_merge(state: VarianceState, w: Tensor, batch_mean: Tensor,
                   batch_m2: Tensor) -> VarianceState:
    """Chan et al.'s merge of a batch's terms into the running estimate (a
    sharded run merges each rank's batch in rank order)."""
    n_new = state.count + w
    delta = batch_mean - state.mean
    mean = state.mean + delta * (w / torch.clamp_min(n_new, 1.0))
    m2 = (state.m2 + batch_m2
          + delta**2 * (state.count * w / torch.clamp_min(n_new, 1.0)))
    return VarianceState(mean=mean, m2=m2, count=n_new)


def variance_update(state: VarianceState, q: Tensor, *,
                    max_abs: float = 1e6) -> VarianceState:
    """Chan et al. parallel-Welford batch update with a [W, D] slab."""
    return variance_merge(state, *variance_batch(q, max_abs=max_abs))


def regularized_mass(state: VarianceState, *, shrink: float = 5.0,
                     floor: float = 1e-3) -> Tensor:
    """Variance shrunk toward ``floor``: n/(n+shrink) var + floor
    shrink/(n+shrink). The metric (mass) is its reciprocal."""
    n = torch.clamp_min(state.count, 2.0)
    var = state.m2 / (n - 1.0)
    w = n / (n + shrink)
    return w * var + (1.0 - w) * floor


# ---------------------------------------------------------------------------
# Cross-walker DENSE covariance
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CovarianceState:
    mean: Tensor  # [D]
    m2: Tensor  # [D, D] centred cross-moment sum
    count: Tensor  # scalar


def covariance_init(num_dims: int, dtype=torch.float32,
                    device=None) -> CovarianceState:
    device = resolve_device(device)
    return CovarianceState(
        mean=torch.zeros((num_dims,), dtype=dtype, device=device),
        m2=torch.zeros((num_dims, num_dims), dtype=dtype, device=device),
        count=torch.zeros((), dtype=dtype, device=device))


def covariance_batch(q: Tensor, *, max_abs: float = 1e6):
    """A [W, D] slab's terms for :func:`covariance_merge`: ``(w, batch
    mean, batch m2 [D, D])`` over its valid rows (``w`` their count)."""
    valid = _valid_rows(q, max_abs)
    w = torch.sum(valid.to(q.dtype))
    vcol = valid[:, None].to(q.dtype)
    qf = torch.where(torch.isfinite(q), q, 0.0)
    batch_mean = torch.sum(qf * vcol, dim=0) / torch.clamp_min(w, 1.0)
    qc = (qf - batch_mean) * vcol
    return w, batch_mean, qc.T @ qc


def covariance_merge(state: CovarianceState, w: Tensor, batch_mean: Tensor,
                     batch_m2: Tensor) -> CovarianceState:
    """Chan et al.'s merge of a batch's terms into the running estimate
    (dense form; a sharded run merges each rank's batch in rank order)."""
    n_new = state.count + w
    delta = batch_mean - state.mean
    mean = state.mean + delta * (w / torch.clamp_min(n_new, 1.0))
    m2 = (state.m2 + batch_m2
          + torch.outer(delta, delta)
          * (state.count * w / torch.clamp_min(n_new, 1.0)))
    return CovarianceState(mean=mean, m2=m2, count=n_new)


def covariance_update(state: CovarianceState, q: Tensor, *,
                      max_abs: float = 1e6) -> CovarianceState:
    """Chan et al. batch merge with a [W, D] slab (dense form)."""
    return covariance_merge(state, *covariance_batch(q, max_abs=max_abs))


def regularized_covariance(state: CovarianceState, *, shrink: float = 5.0,
                           floor: float = 1e-3) -> Tensor:
    """cov_reg = n/(n+shrink) cov + floor shrink/(n+shrink) I."""
    n = torch.clamp_min(state.count, 2.0)
    cov = state.m2 / (n - 1.0)
    w = n / (n + shrink)
    eye = torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
    return w * cov + (1.0 - w) * floor * eye


def batch_terms(q: Tensor, *, dense: bool = False) -> tuple:
    """A slab's batch terms as the pieces ``(w [1], mean, m2)`` of one
    vector (``m2`` of :func:`variance_batch`, or of :func:`covariance_batch`
    flattened with ``dense``): the caller joins them into a rank's row of
    the samplers' all-reduce with whatever else the row carries."""
    w, mean, m2 = (covariance_batch if dense else variance_batch)(q)
    return w.reshape(1), mean, m2.reshape(-1)


def merge_batch_terms(state, rows: Tensor):
    """``state`` (a :class:`VarianceState` or :class:`CovarianceState`)
    merged with each row of joined :func:`batch_terms` in order: a sharded
    run's ranks, rank by rank (an unsharded run's one row)."""
    d = state.mean.shape[0]
    for row in rows:
        if isinstance(state, CovarianceState):
            state = covariance_merge(state, row[0], row[1:1 + d],
                                     row[1 + d:].reshape(d, d))
        else:
            state = variance_merge(state, row[0], row[1:1 + d], row[1 + d:])
    return state


# ---------------------------------------------------------------------------
# Warmup schedule
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WarmupSegment:
    index: int
    length: int
    update_mass: bool


def build_warmup_schedule(num_warmup: int, *, adapt_mass: bool = True
                          ) -> List[WarmupSegment]:
    """Stan-like three-phase warmup: ~15% step size only; ~60% in expanding
    windows that refresh the metric (and restart dual averaging); ~25% step
    size only under the final metric."""
    if num_warmup <= 0:
        return []
    if not adapt_mass or num_warmup < 20:
        return [WarmupSegment(0, num_warmup, update_mass=False)]

    n1 = max(1, int(0.15 * num_warmup))
    n3 = max(1, int(0.25 * num_warmup))
    n2 = num_warmup - n1 - n3
    segments = [WarmupSegment(0, n1, update_mass=False)]
    num_windows = 3 if n2 >= 12 else 1
    base = n2 // (2**num_windows - 1) if num_windows > 1 else n2
    base = max(base, 1)
    used = 0
    idx = 1
    for k in range(num_windows):
        length = base * (2**k)
        if k == num_windows - 1:
            length = n2 - used
        length = max(length, 1)
        used += length
        segments.append(WarmupSegment(idx, length, update_mass=True))
        idx += 1
    segments.append(WarmupSegment(idx, n3, update_mass=False))
    return segments
