"""The example models, written in the DSL (port of the JAX package's
``models/examples.py``), and the data they are run on.

  * coin_toss: two independent coin biases, Uniform priors, Bernoulli
    observations;
  * eight_schools: Normal mu, HalfCauchy tau, a plate over J schools, in
    the centred form and in the non-centred form HMC samples well;
  * logistic_regression, linear_regression;
  * funnel: Neal's funnel as a hierarchical model.
"""

from __future__ import annotations

import numpy as np
import torch

from . import distributions as dist
from .core import plate, sample


def coin_toss(c1, c2):
    """Two independent coin biases with flat priors."""
    theta1 = sample("p1", dist.Uniform(0, 1))
    theta2 = sample("p2", dist.Uniform(0, 1))
    sample("obs1", dist.Bernoulli(theta1), obs=c1)
    sample("obs2", dist.Bernoulli(theta2), obs=c2)


def eight_schools(J, sigma, y):
    """Centred hierarchical model: funnel geometry, kept for parity
    studies."""
    mu = sample("mu", dist.Normal(0.0, 5.0))
    tau = sample("tau", dist.HalfCauchy(5.0))
    with plate("J", J):
        theta = sample("theta", dist.Normal(mu, tau))
        sample("obs", dist.Normal(theta, sigma), obs=y)


def eight_schools_noncentered(J, sigma, y):
    """Non-centred form: theta = mu + tau * theta_raw with theta_raw ~
    N(0, 1). Same posterior, geometry HMC samples well."""
    mu = sample("mu", dist.Normal(0.0, 5.0))
    tau = sample("tau", dist.HalfCauchy(5.0))
    with plate("J", J):
        theta_raw = sample("theta_raw", dist.Normal(0.0, 1.0))
        theta = mu + tau * theta_raw
        sample("obs", dist.Normal(theta, sigma), obs=y)


def logistic_regression(x, labels):
    """Bayesian logistic regression: w ~ N(0, 1)^P, b ~ N(0, 1),
    labels ~ Bernoulli(logits = x @ w + b)."""
    num_features = x.shape[-1]
    with plate("features", num_features):
        w = sample("w", dist.Normal(0.0, 1.0))
    b = sample("b", dist.Normal(0.0, 1.0))
    logits = x @ w + b
    sample("obs", dist.BernoulliLogits(logits), obs=labels)


def linear_regression(x, y, prior_scale=10.0):
    """Linear model with Normal noise."""
    num_features = x.shape[-1]
    with plate("features", num_features):
        w = sample("w", dist.Normal(0.0, prior_scale))
    b = sample("b", dist.Normal(0.0, prior_scale))
    noise = sample("noise", dist.HalfNormal(1.0))
    mean = x @ w + b
    sample("obs", dist.Normal(mean, noise), obs=y)


def funnel(dim=15, scale=3.0):
    """Neal's funnel as a hierarchical model: x's prior scale depends on
    the latent v, so ``make_model_potential(funnel, reparam="auto")``
    decenters it. The decentered coordinates are a standard normal; the
    funnel geometry moves into the deterministic readout."""
    v = sample("v", dist.Normal(0.0, scale))
    with plate("dim", dim):
        sample("x", dist.Normal(0.0, torch.exp(0.5 * v)))


EXAMPLE_MODELS = {
    "coin_toss": coin_toss,
    "eight_schools": eight_schools,
    "eight_schools_noncentered": eight_schools_noncentered,
    "logistic_regression": logistic_regression,
    "linear_regression": linear_regression,
    "funnel": funnel,
}


EIGHT_SCHOOLS_DATA = {
    # Rubin (1981) eight-schools data
    "J": 8,
    "y": np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0], np.float32),
    "sigma": np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0],
                      np.float32),
}


def logistic_regression_data(num_rows: int = 256, num_features: int = 31,
                             seeds=(7, 8, 9)):
    """Synthetic data for :func:`logistic_regression`, numpy float32
    ``(x [N, P], labels [N])``: normal features from ``default_rng(seeds[0]
    )``, true weights from ``seeds[1]``, and labels ``uniform < sigmoid(x @
    w_true)`` from ``seeds[2]`` (the recipe of the JAX package's
    ``benchmarks/model_bench.py`` target ``logreg_32_n256``, with numpy
    seeds so that it needs no JAX)."""
    x = np.random.default_rng(seeds[0]).normal(
        size=(num_rows, num_features)).astype(np.float32)
    w_true = np.random.default_rng(seeds[1]).normal(
        size=num_features).astype(np.float32)
    u = np.random.default_rng(seeds[2]).uniform(size=num_rows)
    labels = (u < 1.0 / (1.0 + np.exp(-(x @ w_true)))).astype(np.float32)
    return x, labels
