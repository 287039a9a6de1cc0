"""The port's ``tempering`` against the JAX package's: the ladder, the
partner tables and the swap phase exactly on the same inputs, the sampler
within Monte-Carlo error and against closed forms, and the fused replica
step (a per-call beta and its thermal momenta, on the CPU the plain
kernel B) against the same statistics written out."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import tempering as jtemp
from physicsbasedbayesianinference_tpu.ops import potentials as jp
import physicsbasedbayesianinference_tpu_torch as pt
from physicsbasedbayesianinference_tpu_torch import tempering
from physicsbasedbayesianinference_tpu_torch.hmc import FusedTransition
from physicsbasedbayesianinference_tpu_torch.ops import philox
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp
from physicsbasedbayesianinference_tpu_torch.ops.integrators import (
    get_integrator)


@pytest.mark.parametrize("num_replicas", [1, 2, 3, 4, 5, 6, 8, 16])
@pytest.mark.parametrize("beta_min", [0.02, 0.05, 0.1])
def test_geometric_ladder_matches_jax_exactly(num_replicas, beta_min):
    """Exact at these sizes; both sides take a float32 power, whose libm
    results differ by an ulp at a few other points (R=32, beta_min=0.3)."""
    got = tempering.geometric_ladder(num_replicas, beta_min, device="cpu")
    want = np.asarray(jtemp.geometric_ladder(num_replicas, beta_min))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[0]) == 1.0 and bool(torch.all(torch.diff(got) < 0))


@pytest.mark.parametrize("num_replicas", [1, 2, 5, 8])
def test_partner_tables_match_jax_and_are_involutions(num_replicas):
    for t, jt in zip(tempering._partner_tables(num_replicas),
                     jtemp._partner_tables(num_replicas)):
        np.testing.assert_array_equal(t, jt)
        assert np.array_equal(t[t], np.arange(num_replicas))


@pytest.mark.parametrize("parity", [0, 1])
def test_swap_phase_matches_jax_exactly(parity):
    """The JAX transition with no leapfrog step leaves every replica where
    it was (H1 = H0, accepted), so its output is the swap phase alone; the
    port's swap phase fed the JAX key's uniforms gives the same bits."""
    r, w, d = 5, 512, 3
    rng = np.random.default_rng(parity)
    q = (3.0 * rng.normal(size=(r, w, d))).astype(np.float32)
    target_j = jp.make_standard_normal(d)
    betas = jtemp.geometric_ladder(r, 0.05)
    trans, _, vg = jtemp.build_pt_transition(
        target_j, betas=betas, num_dims=d, num_steps=0, kernel="xla")
    u, g = jax.vmap(vg)(jnp.asarray(q))
    key = jax.random.key(11)
    jq, ju, jg, _, jswaps = trans(key, jnp.asarray(q), u, g,
                                  jnp.full((r,), 0.1), parity)
    _, k_swap = jax.random.split(key)
    uniform = jax.random.uniform(k_swap, (r, w), dtype=jnp.float32,
                                 minval=jnp.finfo(jnp.float32).tiny)
    partner = torch.as_tensor(tempering._partner_tables(r)[parity])
    tq, tu, tg, tswaps = tempering.swap_phase(
        torch.as_tensor(q), torch.as_tensor(np.asarray(u)),
        torch.as_tensor(np.asarray(g)), torch.as_tensor(np.asarray(betas)),
        partner, torch.as_tensor(np.asarray(uniform)))
    for a, b in ((tq, jq), (tu, ju), (tg, jg), (tswaps, jswaps)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0.0 < float(tswaps.max()) < 1.0
    unpaired = 4 if parity == 0 else 0  # (0,1)(2,3) / (1,2)(3,4)
    assert float(tswaps[unpaired]) == 0.0


def _normal(seed, shape, scale=1.0):
    return torch.as_tensor(
        (scale * np.random.default_rng(seed).normal(size=shape)).astype(
            np.float32))


def test_pt_gaussian_moments_against_jax():
    """The cold replica is unbiased (the swaps keep the invariant
    distribution): the JAX test's limits (mean 0.1, variance 0.25), and
    the JAX run from the same numpy positions within 0.1 / 0.25."""
    mean, cov = np.float32([1.0, -2.0]), np.float32([[1.0, 0.5],
                                                     [0.5, 2.0]])
    init = _normal(1, (1024, 2))
    kw = dict(num_replicas=4, beta_min=0.1, num_warmup=150, num_samples=300,
              num_steps=8, collect="moments")
    res = pt.run_parallel_tempering(
        0, tp.make_gaussian(mean, cov=cov, device="cpu"), init, **kw)
    assert res.kernel_used == "composed"
    np.testing.assert_allclose(res.mean.numpy(), mean, atol=0.1)
    np.testing.assert_allclose(res.var.numpy(), [1.0, 2.0], atol=0.25)
    assert float(res.accept_rate.min()) > 0.5
    assert float(res.swap_rate.max()) > 0.05
    jres = jtemp.run_parallel_tempering(
        jax.random.key(0), jp.make_gaussian(mean, cov=cov),
        jnp.asarray(init.numpy()), kernel="xla", **kw)
    np.testing.assert_allclose(res.mean.numpy(), np.asarray(jres.mean),
                               atol=0.1)
    np.testing.assert_allclose(res.var.numpy(), np.asarray(jres.var),
                               atol=0.25)


def test_pt_mixes_bimodal_where_hmc_cannot():
    """Two modes at (+-6, 0): PT started in the left mode visits both in
    proportion ([0.25, 0.75], the JAX test's limits); plain HMC stays."""
    target = tp.make_gaussian_mixture(torch.tensor([[-6.0, 0.0],
                                                    [6.0, 0.0]]),
                                      device="cpu")
    init = torch.tensor([-6.0, 0.0]) + _normal(2, (256, 2), 0.3)
    res = pt.run_parallel_tempering(
        3, target, init, num_replicas=6, beta_min=0.02, num_warmup=200,
        num_samples=400, num_steps=10, collect="samples")
    assert res.samples.shape == (400, 256, 2)
    frac_pt = float((res.samples[:, :, 0] > 0).float().mean())
    res_hmc = pt.run_hmc(3, target, init, num_warmup=200, num_samples=400,
                         num_steps=10, adapt_mass=False)
    frac_hmc = float((res_hmc.samples[:, :, 0] > 0).float().mean())
    assert 0.25 < frac_pt < 0.75, frac_pt
    assert frac_hmc < 0.05, frac_hmc
    assert float(res.accept_rate.min()) > 0.5
    assert float(res.swap_rate.max()) > 0.05


def _hyperbolic():
    """U = sum sqrt(1 + q^2): its curvature (1 + q^2)^(-3/2) stays positive
    and falls away from the origin, where the hot replicas spend their
    time."""
    def potential(q):
        return torch.sum(torch.sqrt(1.0 + q * q), dim=-1)

    potential.analytic_grad = lambda q: q / torch.sqrt(1.0 + q * q)
    return potential


def test_pt_hot_replicas_take_larger_steps():
    """Where the curvature falls off with |q| the hot replicas adapt larger
    steps, rung by rung. (On a Gaussian, which the JAX test uses, the best
    step does not depend on beta: the momenta's 1 / sqrt(beta) and the
    ratio's beta cancel, and the order of the adapted steps is the noise's.
    Where the curvature turns negative between modes, as in the bimodal
    mixture or a Student-t's tails, the hot replicas take smaller ones.)"""
    res = pt.run_parallel_tempering(
        4, _hyperbolic(), _normal(5, (512, 4)), num_replicas=4,
        beta_min=0.05, num_warmup=150, num_samples=10, num_steps=8,
        collect="none")
    s = res.step_sizes
    assert bool(torch.all(torch.diff(s) > 0)), s
    assert float(s[-1]) > 1.3 * float(s[0]), s
    assert res.samples is None and res.mean is None


def test_pt_single_replica_is_hmc():
    res = pt.run_parallel_tempering(
        6, tp.make_standard_normal(2), _normal(7, (256, 2)), num_replicas=1,
        num_warmup=100, num_samples=200, num_steps=8, collect="moments")
    assert float(res.mean.abs().max()) < 0.15
    assert float(res.swap_rate.max()) == 0.0
    assert res.betas.tolist() == [1.0]


def test_pt_validates_inputs_and_the_engine():
    target = tp.make_standard_normal(2)
    q = _normal(0, (64, 2))
    with pytest.raises(ValueError, match="collect"):
        pt.run_parallel_tempering(0, target, q, collect="bogus")
    with pytest.raises(ValueError, match="replica"):
        tempering.geometric_ladder(0)
    with pytest.raises(ValueError, match="leading axis"):
        pt.run_parallel_tempering(0, target, q.expand(3, 64, 2),
                                  num_replicas=4)
    with pytest.raises(ValueError, match="cannot run"):
        pt.run_parallel_tempering(0, target, q, kernel="fused")
    with pytest.raises(ValueError, match="auto|fused|composed"):
        pt.run_parallel_tempering(0, target, q, kernel="xla")
    res = pt.run_parallel_tempering(0, target, q, num_replicas=3,
                                    num_warmup=4, num_samples=3,
                                    collect="none", kernel="composed")
    assert res.kernel_used == "composed" and res.q.shape == (3, 64, 2)


@pytest.mark.parametrize("beta", [1.0, 0.21])
def test_fused_replica_step_at_a_beta(beta):
    """``FusedTransition(beta=...)`` on CPU tensors (the plain kernel B,
    mixture form): momenta thermal at beta (std sqrt(m / beta)) and the
    Metropolis ratio exp(-beta dH), as the statistics written out give them
    from the same Philox draws (float32, sums in another order:
    rtol=atol=1e-5)."""
    target = tp.make_gaussian_mixture(torch.tensor([[-3.0, 0.0],
                                                    [3.0, 0.0]]),
                                      device="cpu")
    q = _normal(8, (256, 2), 3.0)
    w, d = q.shape
    vg = tp.batched_value_and_grad(target)
    u, g = vg(q)
    mass = torch.tensor([1.0, 2.0])
    state = pt.hmc.init_state(lambda x: (u, g), q, mass)
    new, info, _ = FusedTransition(target)(
        (5, 3), state, 0.6, num_steps=5, beta=torch.tensor(beta))
    p0 = torch.sqrt(mass / beta) * philox.momentum_normals(5, 3, w, d,
                                                           q.device)
    q1, p1, u1, g1 = get_integrator("leapfrog")(
        vg, q, p0, step_size=0.6, num_steps=5, inv_mass=1 / mass, grad=g,
        potential_energy=u)
    h0 = 0.5 * torch.sum(p0 * p0 / mass, -1) + u
    h1 = 0.5 * torch.sum(p1 * p1 / mass, -1) + u1
    derr = beta * (h1 - h0)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(info.energy_error.numpy(), derr.numpy(), **tol)
    log_u = torch.log(philox.accept_uniforms(5, 3, w, q.device))
    accepted = log_u < -derr
    clear = (log_u + derr).abs() > 1e-4
    assert torch.equal(info.accepted[clear], accepted[clear])
    both = info.accepted & accepted
    np.testing.assert_allclose(new.ensemble.q[both].numpy(),
                               q1[both].numpy(), **tol)
    assert 0.2 < float(info.accepted.float().mean()) < 1.0
