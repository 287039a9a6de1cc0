"""MCMC diagnostics over ``[T, W, D]`` sample tensors (port of the JAX
package's ``diagnostics.py``): FFT autocorrelation, Geyer ESS, split-R-hat
and a posterior summary, all on the samples' device."""

from __future__ import annotations

from typing import Optional

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


def summary(samples: Tensor, quantiles=(0.05, 0.5, 0.95)) -> dict:
    """Posterior summary dict from [T, W, D] samples (per dimension)."""
    flat = samples.reshape(-1, samples.shape[-1])
    qs = torch.quantile(
        flat, torch.as_tensor(quantiles, dtype=flat.dtype,
                              device=flat.device), dim=0)
    return {
        "mean": torch.mean(flat, dim=0),
        "sd": torch.std(flat, dim=0, correction=0),
        "quantiles": qs,
        "ess": effective_sample_size(samples),
        "rhat": split_rhat(samples),
    }
