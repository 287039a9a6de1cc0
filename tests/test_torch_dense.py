"""``run_hmc(metric="dense")`` of the torch port against the JAX package's
dense-metric HMC.

* The step: the port's deterministic ``transition``, fed the momentum
  normals and log-uniforms that the JAX kernel draws from its key, equals
  the JAX step on the same state, covariance and inverse Cholesky factor
  to float32 tolerance: positions, momenta, energies and gradients to
  rtol = atol = 1e-5 (the trajectory's matmuls sum in another order), the
  energy error and acceptance probability to 1e-5 of the walker's energy
  scale, the accept decisions exactly.
* The run: on the 8-dim correlated target of ``tests/test_hmc.py``'s dense
  test at W = 512, the posterior moments and the adapted covariance of
  both packages sit within Monte-Carlo error of the truth and of each
  other (limits below, each over three standard errors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import hmc as jh
from physicsbasedbayesianinference_tpu.ops import potentials as jp
import physicsbasedbayesianinference_tpu_torch as pt
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp
from physicsbasedbayesianinference_tpu_torch.utils import convert


def _target(d=8):
    """The target of ``tests/test_hmc.py::test_dense_metric_whitens_...``:
    cov = a a^T + 0.1 I, a from RandomState(0), mean 0..7."""
    a = np.random.RandomState(0).randn(d, d)
    cov = (a @ a.T + 0.1 * np.eye(d)).astype(np.float32)
    mean = np.arange(float(d), dtype=np.float32)
    return mean, cov


def _jax_state_numpy(state):
    ens = state.ensemble
    values = (ens.q, ens.p, ens.mass, ens.log_weight,
              state.potential_energy, state.grad)
    return {k: np.array(v) for k, v in zip(convert.STATE_KEYS, values)}


@pytest.mark.parametrize("step_size", [0.05, 0.4])
def test_dense_transition_matches_jax_on_the_jax_draws(step_size):
    mean, cov = _target()
    w, steps = 256, 8
    rng = np.random.default_rng(1)
    q0 = (mean + rng.normal(size=(w, 8)) * 1.5).astype(np.float32)
    # a metric that is not the target's: a perturbed covariance
    b = rng.normal(size=(8, 8)) * 0.3
    metric = (cov + b @ b.T).astype(np.float32)
    inv_chol = np.linalg.inv(np.linalg.cholesky(metric)).astype(np.float32)

    jk = jh.build_dense_hmc_kernel(jp.make_gaussian(mean, cov=cov),
                                   num_steps=steps)
    tk = pt.build_dense_hmc_kernel(
        tp.make_gaussian(mean, cov=cov, device="cpu"), num_steps=steps)
    js = jk.init(jnp.asarray(q0))
    key = jax.random.key(7)
    jnew, jinfo = jk.step(key, js, jnp.float32(step_size),
                          jnp.asarray(metric), jnp.asarray(inv_chol))
    # the draws of the JAX step, as it takes them from its key
    key_mom, key_acc = jax.random.split(key)
    z = jax.random.normal(key_mom, q0.shape, dtype=jnp.float32)
    log_u = jnp.log(jax.random.uniform(
        key_acc, (w,), dtype=jnp.float32,
        minval=jnp.finfo(jnp.float32).tiny))

    ts = convert.hmc_state_from_jax(_jax_state_numpy(js), device="cpu")
    tnew, tinfo = tk.transition(
        ts, torch.as_tensor(np.array(z)), torch.as_tensor(np.array(log_u)),
        torch.tensor(step_size), torch.as_tensor(metric),
        torch.as_tensor(inv_chol))
    accepted = np.asarray(jinfo.accepted)
    assert 0 < accepted.sum() < w or step_size == 0.05
    np.testing.assert_array_equal(tinfo.accepted.numpy(), accepted)
    np.testing.assert_array_equal(tinfo.divergent.numpy(),
                                  np.asarray(jinfo.divergent))
    # the energy error is a difference of two energies of up to ~100: it
    # is held to 1e-5 of the walker's energy scale 1 + |U0| + |U1|
    scale = 1.0 + np.abs(np.asarray(js.potential_energy)) + np.abs(
        np.asarray(jinfo.potential_energy))
    for t, j in ((tinfo.energy_error, jinfo.energy_error),
                 (tinfo.accept_prob, jinfo.accept_prob)):
        assert np.all(np.abs(t.numpy() - np.asarray(j)) <= 1e-5 * scale)
    for t, j in ((tnew.ensemble.q, jnew.ensemble.q),
                 (tnew.ensemble.p, jnew.ensemble.p),
                 (tnew.potential_energy, jnew.potential_energy),
                 (tnew.grad, jnew.grad)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    # step() is the draw and then the same transition
    a, _ = tk.step((3, 4), ts, torch.tensor(step_size),
                   torch.as_tensor(metric), torch.as_tensor(inv_chol))
    b2, _ = tk.step((3, 4), ts, torch.tensor(step_size),
                    torch.as_tensor(metric), torch.as_tensor(inv_chol))
    assert torch.equal(a.ensemble.q, b2.ensemble.q)


def test_dense_transition_guards():
    """A non-finite energy error is +inf and divergent, and the accept is
    a select: a walker whose proposal is NaN keeps its state."""
    mean, cov = _target(2)
    tk = pt.build_dense_hmc_kernel(
        tp.make_gaussian(mean, cov=cov, device="cpu"), num_steps=2)
    q = torch.zeros(4, 2)
    st = tk.init(q)
    z = torch.zeros(4, 2)
    z[1, 0] = float("nan")
    eye = torch.eye(2)
    new, info = tk.transition(st, z, torch.full((4,), -1e-3),
                              torch.tensor(0.1), eye, eye)
    assert torch.isinf(info.energy_error[1]) and info.divergent[1]
    assert not info.accepted[1] and info.accept_prob[1] == 0.0
    assert torch.equal(new.ensemble.q[1], q[1])
    assert bool(info.accepted[0])


def test_run_hmc_dense_matches_jax_moments_and_metric_cov():
    mean, cov = _target()
    w = 512
    q0 = np.random.default_rng(0).normal(size=(w, 8)).astype(np.float32)
    kw = dict(num_warmup=400, num_samples=400, num_steps=8,
              collect="moments")
    rj = jh.run_hmc(jax.random.key(1), jp.make_gaussian(mean, cov=cov),
                    jnp.asarray(q0), metric="dense", **kw)
    rt = pt.run_hmc(1, tp.make_gaussian(mean, cov=cov, device="cpu"),
                    torch.as_tensor(q0), metric="dense", **kw)
    assert (rt.kernel_used, rt.kernel_variant) == ("dense", "dense")
    assert rj.kernel_used == "dense"
    assert rt.num_grad_evals == rj.num_grad_evals
    sd = np.sqrt(np.diag(cov))
    # each walker's 400 draws counted as ~4 independent ones: the mean's
    # standard error is sd / sqrt(2048) = 0.022 sd, the variance's
    # sqrt(2 / 2048) = 0.031; the gates are 0.1 sd and 0.15
    for m, v in ((rt.mean.numpy(), rt.var.numpy()),
                 (np.asarray(rj.mean), np.asarray(rj.var))):
        np.testing.assert_allclose((m - mean) / sd, 0.0, atol=0.1)
        np.testing.assert_allclose(v / sd**2, 1.0, atol=0.15)
    np.testing.assert_allclose(rt.mean.numpy(), np.asarray(rj.mean),
                               atol=0.15 * sd.min())
    # the adapted Sigma: the JAX test's criterion against the truth, and
    # the two packages' within 15% of each other (Frobenius); the last
    # window holds ~60 x 512 correlated draws
    cj, ct = np.asarray(rj.metric_cov), rt.metric_cov.numpy()
    for c in (cj, ct):
        assert np.max(np.abs(c - cov) / (np.abs(cov) + 0.1)) < 0.5
    assert np.linalg.norm(ct - cj) / np.linalg.norm(cj) < 0.15
    np.testing.assert_allclose(rt.mass.numpy(), 1.0 / np.diag(ct))
    assert float(rt.step_size) == pytest.approx(float(rj.step_size),
                                                rel=0.2)
    assert 0.6 < float(rt.accept_rate) <= 1.0


def test_dense_metric_routing():
    std = tp.make_standard_normal(2)
    q = torch.zeros(8, 2)
    kw = dict(num_warmup=0, num_samples=2, num_steps=2, metric="dense")
    for kernel in ("auto", "composed"):
        res = pt.run_hmc(0, std, q, kernel=kernel, **kw)
        assert res.kernel_used == "dense"
        assert res.metric_cov.shape == (2, 2)
    for kernel in ("fused", "xla"):
        with pytest.raises(ValueError, match="dense"):
            pt.run_hmc(0, std, q, kernel=kernel, **kw)
    with pytest.raises(ValueError, match="metric"):
        pt.run_hmc(0, std, q, num_warmup=0, num_samples=1, num_steps=2,
                   metric="bogus")
    with pytest.raises(ValueError, match="integrat"):
        pt.run_hmc(0, std, q, integrator="yoshida4", **kw)
    assert pt.run_hmc(0, std, q, num_warmup=0, num_samples=1,
                      num_steps=2).metric_cov is None
