"""The frozen ESS on AR(1) series of known integrated autocorrelation time
tau = (1 + phi) / (1 - phi)."""

import pytest
import torch

from portbench import ess


@pytest.mark.parametrize("phi", [0.0, 0.5, 0.8])
def test_ess_of_ar1(phi):
    s, w, d = 2000, 256, 3
    gen = torch.Generator().manual_seed(3)
    eps = torch.randn(s, w, d, generator=gen)
    x = torch.empty_like(eps)
    x[0] = eps[0] / (1.0 - phi**2) ** 0.5
    for t in range(1, s):
        x[t] = phi * x[t - 1] + eps[t]
    tau = (1.0 + phi) / (1.0 - phi)
    subset = torch.arange(w)
    got = ess.min_ess(x, subset, w, w)
    want = s * w / tau
    assert 0.85 * want < got < 1.1 * want


def test_subset_sums_add_over_ranks():
    """Two ranks' autocorrelation sums, added, are the one-process sum."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(64, 32, 2, generator=gen).cumsum(0)
    whole = ess.autocorrelation_sum(x)
    halves = ess.autocorrelation_sum(x[:, :16]) + ess.autocorrelation_sum(
        x[:, 16:])
    # float32 transforms of other batch shapes round apart
    torch.testing.assert_close(whole, halves, rtol=1e-5, atol=1e-5)
