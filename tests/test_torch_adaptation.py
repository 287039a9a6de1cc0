"""Warmup adaptation of the torch port against the JAX package: dual
averaging on a fixed acceptance sequence, the variance/covariance streams
on slabs with planted non-finite and huge rows, and the warmup schedule.
Tolerance rtol=1e-6 (float32; 1e-7 absolute where a value cancels toward
zero) or exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import adaptation as ja
from physicsbasedbayesianinference_tpu_torch import adaptation as ta
from _torch_cpu import cpu_requested  # noqa: F401  (the CPU, asked for)


def test_dual_averaging_sequence():
    acc = np.random.default_rng(0).uniform(0.3, 1.0, 60).astype(np.float32)
    sj, st = ja.da_init(0.1), ta.da_init(0.1)
    for a in acc:
        sj = ja.da_update(sj, jnp.float32(a), target=0.75)
        st = ta.da_update(st, torch.tensor(a), target=0.75)
        for f in ("log_step", "log_avg_step", "h_bar", "t", "mu"):
            np.testing.assert_allclose(float(getattr(st, f)),
                                       float(getattr(sj, f)), rtol=1e-6,
                                       atol=1e-7)
    assert ta.da_update(st, torch.tensor(0.1), enabled=False) is st


def _slab(seed, w=200, d=5):
    q = np.random.default_rng(seed).normal(size=(w, d)).astype(np.float32)
    q[3, 1] = np.inf
    q[7, 0] = -np.inf
    q[11, 2] = np.nan
    q[19, 4] = 1e13  # finite, but its square overflows float32 moments
    return q


def test_variance_stream_with_planted_outliers():
    vj, vt = ja.variance_init(5), ta.variance_init(5)
    for seed in range(3):
        q = _slab(seed)
        vj = ja.variance_update(vj, jnp.asarray(q))
        vt = ta.variance_update(vt, torch.as_tensor(q))
    assert float(vt.count) == float(vj.count) == 3 * 196
    # rtol 1e-6, plus 1e-7 absolute for means that cancel to ~1e-3
    for f in ("mean", "m2"):
        np.testing.assert_allclose(getattr(vt, f).numpy(),
                                   np.asarray(getattr(vj, f)), rtol=1e-6,
                                   atol=1e-7)
    assert bool(torch.isfinite(vt.m2).all())
    np.testing.assert_allclose(ta.regularized_mass(vt).numpy(),
                               np.asarray(ja.regularized_mass(vj)),
                               rtol=1e-6)


def test_covariance_stream_with_planted_outliers():
    cj, ct = ja.covariance_init(5), ta.covariance_init(5)
    for seed in range(3):
        q = _slab(seed + 10)
        cj = ja.covariance_update(cj, jnp.asarray(q))
        ct = ta.covariance_update(ct, torch.as_tensor(q))
    np.testing.assert_allclose(ct.mean.numpy(), np.asarray(cj.mean),
                               rtol=1e-6, atol=1e-7)
    # [D, D] products: float32 sums in another order
    np.testing.assert_allclose(ct.m2.numpy(), np.asarray(cj.m2), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(ta.regularized_covariance(ct).numpy(),
                               np.asarray(ja.regularized_covariance(cj)),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("adapt_mass", [True, False])
def test_warmup_schedules_identical(adapt_mass):
    for n in (0, 1, 5, 19, 20, 21, 37, 150, 200, 300, 1000, 4097):
        a = ja.build_warmup_schedule(n, adapt_mass=adapt_mass)
        b = ta.build_warmup_schedule(n, adapt_mass=adapt_mass)
        assert [(s.index, s.length, s.update_mass) for s in a] == \
            [(s.index, s.length, s.update_mass) for s in b]
        assert sum(s.length for s in b) == n
