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
