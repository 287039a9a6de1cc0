"""MCMC diagnostics over ``[T, W, D]`` sample tensors (port of the JAX
package's ``diagnostics.py``): FFT autocorrelation, Geyer ESS, split-R-hat
and a posterior summary, all on the samples' device; and the host-side
profiling helpers (a named profiler region, a wall-clock region, throttled
metrics logging)."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

Tensor = torch.Tensor


def autocorrelation(x: Tensor, max_lag: Optional[int] = None) -> Tensor:
    """Normalised autocorrelation over the leading (time) axis via FFT.
    x: [T, ...] -> [max_lag, ...]."""
    t = x.shape[0]
    if max_lag is None:
        max_lag = t
    x = x - torch.mean(x, dim=0, keepdim=True)
    n_fft = 2 * t
    f = torch.fft.rfft(x, n=n_fft, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=n_fft, dim=0)[:t]
    lags = torch.arange(t, 0, -1, dtype=x.dtype, device=x.device)
    acov = acov / lags.reshape((-1,) + (1,) * (x.ndim - 1))
    return (acov / acov[0])[:max_lag]


def effective_sample_size(samples: Tensor,
                          max_lag: Optional[int] = None) -> Tensor:
    """ESS per dimension from [T, W, D] samples: walker-averaged
    autocorrelations with Geyer (1992) initial-monotone truncation;
    tau = -1 + 2 sum_m Gamma_m, ESS = T W / tau."""
    t, w = samples.shape[0], samples.shape[1]
    rho = torch.mean(autocorrelation(samples, max_lag), dim=1)  # [L, D]
    num_pairs = rho.shape[0] // 2
    gamma = rho[0:2 * num_pairs:2] + rho[1:2 * num_pairs:2]   # [m, D]
    positive = torch.cumprod((gamma > 0.0).to(torch.int32), dim=0) > 0
    gamma = torch.where(positive, gamma, 0.0)
    gamma = torch.cummin(gamma, dim=0).values
    tau = -1.0 + 2.0 * torch.sum(torch.clamp_min(gamma, 0.0), dim=0)
    tau = torch.clamp_min(tau, 1.0 / (t * w))
    return t * w / tau


def split_rhat(samples: Tensor) -> Tensor:
    """Split-R-hat per dimension from [T, W, D] samples over the 2W
    half-chains (Gelman et al., BDA3 eq. 11.4)."""
    t = samples.shape[0] - (samples.shape[0] % 2)
    half = t // 2
    x = samples[:t]
    chains = torch.cat([x[:half], x[half:]], dim=1)  # [half, 2W, D]
    mean_c = torch.mean(chains, dim=0)
    var_c = torch.var(chains, dim=0, correction=1)
    w_var = torch.mean(var_c, dim=0)
    b_var = half * torch.var(mean_c, dim=0, correction=1)
    var_plus = (half - 1) / half * w_var + b_var / half
    return torch.sqrt(var_plus / w_var)


def _quantiles(flat: Tensor, qs) -> Tensor:
    """Quantiles ``qs`` of every column of ``flat`` ``[N, D]`` -> ``[len(qs),
    D]``, by linear interpolation between order statistics as
    ``jnp.quantile``'s default (the position ``q (N - 1)`` and its weights
    in float32); a column holding a NaN gives NaN.

    ``torch.quantile`` refuses more than 2^24 rows; this sorts one column
    at a time instead, so the extra memory is one column and its indices
    at any N."""
    n = flat.shape[0]
    pos = np.asarray(qs, np.float32) * np.float32(n - 1)
    low = np.clip(np.floor(pos), 0, n - 1).astype(np.int64)
    high = np.clip(np.ceil(pos), 0, n - 1).astype(np.int64)
    high_w = torch.as_tensor(pos - np.floor(pos), device=flat.device)
    low_w = 1.0 - high_w
    low_i = torch.as_tensor(low, device=flat.device)
    high_i = torch.as_tensor(high, device=flat.device)
    cols = []
    for j in range(flat.shape[1]):
        s = torch.sort(flat[:, j]).values
        cols.append(s[low_i] * low_w.to(s.dtype) + s[high_i]
                    * high_w.to(s.dtype))
    out = torch.stack(cols, dim=1)
    return torch.where(torch.isnan(flat).any(dim=0), torch.nan, out)


def summary(samples: Tensor, quantiles=(0.05, 0.5, 0.95)) -> dict:
    """Posterior summary dict from [T, W, D] samples (per dimension)."""
    flat = samples.reshape(-1, samples.shape[-1])
    return {
        "mean": torch.mean(flat, dim=0),
        "sd": torch.std(flat, dim=0, correction=0),
        "quantiles": _quantiles(flat, quantiles),
        "ess": effective_sample_size(samples),
        "rhat": split_rhat(samples),
    }


# ---------------------------------------------------------------------------
# Profiling / tracing
# ---------------------------------------------------------------------------


def trace_annotation(name: str):
    """Named profiler region: a ``torch.profiler.record_function`` range,
    which ``torch.profiler`` traces show beside the card's kernels."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def wall_clock(label: str, sink: Optional[Callable[[str], None]] = print):
    """Host-side wall-clock region; ``sink`` gets ``"[label] 1.234s"``."""
    t0 = time.perf_counter()
    yield
    if sink is not None:
        sink(f"[{label}] {time.perf_counter() - t0:.3f}s")


@dataclasses.dataclass
class MetricsLogger:
    """Throttled scalar metrics logging: every ``every``-th step goes to
    ``sink`` as ``"step=N  name=value  ..."``."""

    every: int = 100
    sink: Callable[[str], None] = print

    def log(self, step: int, metrics: dict) -> None:
        if step % self.every != 0:
            return
        parts = [f"step={step}"]
        for k, v in metrics.items():
            try:
                parts.append(f"{k}={float(v):.4g}")
            except (TypeError, ValueError, RuntimeError):
                parts.append(f"{k}={v}")
        self.sink("  ".join(parts))

    def log_series(self, metrics: dict) -> None:
        """Log a whole series ({name: [T] tensor or array}) at cadence."""
        series = {k: torch.as_tensor(v) for k, v in metrics.items()}
        (t,) = {v.shape[0] for v in series.values()}
        for step in range(0, t, self.every):
            self.log(step, {k: v[step] for k, v in series.items()})
