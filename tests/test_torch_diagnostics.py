"""Diagnostics of the torch port against the JAX package on the same
[T, W, D] samples (float32; rtol=1e-5, FFTs in another order)."""

import jax.numpy as jnp
import numpy as np
import torch

from physicsbasedbayesianinference_tpu import diagnostics as jd
from physicsbasedbayesianinference_tpu_torch import diagnostics as td


def _ar1(t=200, w=16, d=3, phi=0.7, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((t, w, d), np.float32)
    x[0] = rng.normal(size=(w, d))
    for i in range(1, t):
        x[i] = phi * x[i - 1] + rng.normal(size=(w, d))
    return x + np.float32([0.0, 1.0, -2.0])


def test_autocorrelation_ess_rhat_summary_match_jax():
    x = _ar1()
    xj, xt = jnp.asarray(x), torch.as_tensor(x)
    np.testing.assert_allclose(td.autocorrelation(xt, 50).numpy(),
                               np.asarray(jd.autocorrelation(xj, 50)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(td.effective_sample_size(xt).numpy(),
                               np.asarray(jd.effective_sample_size(xj)),
                               rtol=1e-4)
    np.testing.assert_allclose(td.split_rhat(xt).numpy(),
                               np.asarray(jd.split_rhat(xj)), rtol=1e-5)
    sj, st = jd.summary(xj), td.summary(xt)
    assert set(sj) == set(st)
    for key in ("mean", "sd", "quantiles", "rhat"):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(sj[key]),
                                   rtol=1e-5, atol=1e-5)
    # AR(1) with phi=0.7: tau = (1+phi)/(1-phi) = 5.67
    ess = td.effective_sample_size(xt).numpy()
    np.testing.assert_allclose(ess, 200 * 16 / 5.67, rtol=0.25)


def test_summary_past_torch_quantiles_row_limit_matches_jax():
    """[256, 65537, 1]: 16.8M rows, over the 2^24 that ``torch.quantile``
    takes. Mean and sd to rtol 1e-5 (float32 sums in another order, atol
    1e-6 for the mean near 0), every quantile exactly: both packages
    interpolate between the same two order statistics with float32
    weights."""
    x = np.random.default_rng(5).normal(size=(256, 65537, 1)).astype(
        np.float32)
    sj, st = jd.summary(jnp.asarray(x)), td.summary(torch.as_tensor(x))
    np.testing.assert_allclose(st["mean"].numpy(), np.asarray(sj["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(st["sd"].numpy(), np.asarray(sj["sd"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(st["quantiles"].numpy(),
                                  np.asarray(sj["quantiles"]))


def test_quantiles_match_jax_at_small_shapes_and_nan():
    x = _ar1(t=37, w=5)
    x[3, 2, 1] = np.nan
    for qs in ((0.05, 0.5, 0.95), (0.0, 0.25, 1.0)):
        sj = jd.summary(jnp.asarray(x), quantiles=qs)
        st = td.summary(torch.as_tensor(x), quantiles=qs)
        np.testing.assert_allclose(st["quantiles"].numpy(),
                                   np.asarray(sj["quantiles"]), rtol=1e-6)
        assert np.isnan(st["quantiles"][:, 1].numpy()).all()
