"""The benchmark's definition of the effective sample size: a frozen plain
torch copy of the program's ``diagnostics.effective_sample_size``
arithmetic, split so that the walker average can be summed over chunks
and over the ranks of a sharded run.

For S draws of W walkers: each walker's and dim's normalised
autocorrelation (FFT), averaged over a fixed subset of walkers; Geyer's
initial-monotone sequence truncates the sums of adjacent pairs; tau = -1
+ 2 sum_m Gamma_m; ESS = S W / tau, W the whole ensemble's walkers.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor
CHUNK = 4096  # walkers an FFT takes at once


def autocorrelation_sum(x: Tensor) -> Tensor:
    """x [S, n, D] (float32) -> [S, D]: the sum over the n walkers of each
    series' normalised autocorrelation at lags 0 .. S - 1."""
    s = x.shape[0]
    out = torch.zeros(s, x.shape[2], dtype=torch.float64, device=x.device)
    lags = torch.arange(s, 0, -1, dtype=x.dtype, device=x.device)[:, None,
                                                                   None]
    for a in range(0, x.shape[1], CHUNK):
        c = x[:, a:a + CHUNK]
        c = c - torch.mean(c, dim=0, keepdim=True)
        f = torch.fft.rfft(c, n=2 * s, dim=0)
        acov = torch.fft.irfft(f * torch.conj(f), n=2 * s, dim=0)[:s] / lags
        out += torch.sum(acov / acov[0], dim=1).to(torch.float64)
    return out


def ess_from_rho(rho: Tensor, num_draws: int, num_walkers: int) -> Tensor:
    """[D] ESS from the walker-averaged autocorrelation ``rho`` [S, D]."""
    pairs = rho.shape[0] // 2
    gamma = rho[0:2 * pairs:2] + rho[1:2 * pairs:2]
    positive = torch.cumprod((gamma > 0.0).to(torch.int32), dim=0) > 0
    gamma = torch.where(positive, gamma, 0.0)
    gamma = torch.cummin(gamma, dim=0).values
    tau = -1.0 + 2.0 * torch.sum(torch.clamp_min(gamma, 0.0), dim=0)
    tau = torch.clamp_min(tau, 1.0 / (num_draws * num_walkers))
    return num_draws * num_walkers / tau


def min_ess(samples: Tensor, subset: Tensor, num_walkers: int,
            subset_total: int, reduce=None) -> float:
    """The job's min-over-dims ESS from its draws ``samples`` [S, w, D]
    (this rank's walkers), averaging over the rows ``subset`` of them;
    ``reduce`` sums the rank's autocorrelation sums over the group, whose
    subset holds ``subset_total`` walkers."""
    rho = autocorrelation_sum(samples[:, subset])
    if reduce is not None:
        rho = reduce(rho)
    ess = ess_from_rho(rho / subset_total, samples.shape[0], num_walkers)
    return float(torch.min(ess))
