"""The port's ChEES-HMC (``chees.py``) against the JAX package's on the same
numpy arrays, and ``run_chees_hmc`` on the CPU (the composed engine).

Tolerances: the adaptation arithmetic rtol=1e-6 (atol=1e-7, float32); a
composed step with the JAX step's momentum and uniform injected,
rtol=atol=1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import chees as jc
from physicsbasedbayesianinference_tpu import models as jm
from physicsbasedbayesianinference_tpu.ops import potentials as jp
import physicsbasedbayesianinference_tpu_torch as pt
from physicsbasedbayesianinference_tpu_torch import chees as tc
from physicsbasedbayesianinference_tpu_torch import models as tm
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp
from physicsbasedbayesianinference_tpu_torch.utils import convert

TIGHT = dict(rtol=1e-6, atol=1e-7)
TOL = dict(rtol=1e-5, atol=1e-5)


def _randn(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_halton_sequence_matches_jax():
    for base in (2, 3):
        np.testing.assert_array_equal(tc.halton_sequence(300, base),
                                      jc.halton_sequence(300, base))
    h = tc.halton_sequence(256)
    assert 0.0 < h.min() and h.max() < 1.0 and abs(h.mean() - 0.5) < 0.01


def test_chees_update_matches_jax_including_nan():
    jst = jc.chees_init(0.7)
    tst = tc.chees_init(0.7, device="cpu")
    grads = np.float32([1.0, -0.3, np.nan, 2.5, np.inf, -4.0, 0.0, 1e-3])
    for g in grads:
        jst = jc.chees_update(jst, jnp.float32(g), lr=0.05)
        tst = tc.chees_update(tst, torch.tensor(g), lr=0.05)
        have = convert.chees_adapt_to_numpy(tst)
        for key in convert.CHEES_KEYS:
            np.testing.assert_allclose(have[key],
                                       np.asarray(getattr(jst, key)), **TIGHT)
    assert np.isfinite(have["log_tau"])
    # the state crosses between the packages as numpy
    back = convert.chees_adapt_from_numpy(
        {k: np.asarray(getattr(jst, k)) for k in convert.CHEES_KEYS}, "cpu")
    assert all(torch.equal(getattr(back, k), torch.as_tensor(np.asarray(
        getattr(jst, k)))) for k in convert.CHEES_KEYS)
    with pytest.raises(KeyError, match="lacks"):
        convert.chees_adapt_from_numpy({"log_tau": np.float32(0.0)}, "cpu")


def test_chees_gradient_matches_jax():
    q0, q1, p1 = _randn(0, 300, 5), _randn(1, 300, 5) * 1.5, _randn(2, 300, 5)
    acc = np.random.default_rng(3).uniform(size=300).astype(np.float32)
    acc[:10] = 0.0
    im = np.random.default_rng(4).uniform(0.5, 2.0, 5).astype(np.float32)
    want = jc.chees_gradient(*map(jnp.asarray, (q0, q1, p1, acc)),
                             jnp.float32(0.375), jnp.asarray(im))
    got = tc.chees_gradient(*map(torch.as_tensor, (q0, q1, p1, acc)),
                            torch.tensor(0.375), torch.as_tensor(im))
    # sums over 300 walkers in another order: 1e-5 relative
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_steps_for_matches_the_jax_rule():
    """clip(round(2 h tau / eps), 1, max_steps) as int32, on ties (round
    half to even on both sides) and at both ends."""
    taus = np.float32([0.1, 1.0, 1.7, 3.0, 50.0])
    hs = np.float32([0.5, 0.25, 0.8125, 0.003, 0.999])
    eps = np.float32([0.2, 0.5, 0.1, 1.0, 0.01])
    for tau in taus:
        for h in hs:
            for e in eps:
                want = jnp.clip(jnp.round(2.0 * jnp.float32(h)
                                          * jnp.float32(tau)
                                          / jnp.float32(e)).astype(jnp.int32),
                                1, 64)
                got = tc.steps_for(torch.tensor(tau), torch.tensor(h),
                                   torch.tensor(e), 64)
                assert got.dtype == torch.int32 and got.shape == (1,)
                assert int(got) == int(want), (tau, h, e)


@pytest.mark.parametrize("target", ["gaussian", "funnel"])
def test_jittered_step_matches_jax_with_injected_draws(target):
    """One composed transition against the JAX step: the JAX step's own
    momentum and uniform (from its key) are handed to the port's step."""
    w, d, max_steps = 128, 4, 16
    rng = np.random.default_rng(5)
    if target == "gaussian":
        mean = _randn(6, d)
        a = rng.normal(size=(d, d))
        cov = (a @ a.T / d + 0.5 * np.eye(d)).astype(np.float32)
        jfn, tfn = jp.make_gaussian(mean, cov=cov), tp.make_gaussian(
            mean, cov=cov, device="cpu")
        q = (mean + _randn(7, w, d)).astype(np.float32)
    else:
        jfn, tfn = jp.make_funnel(d), tp.make_funnel(d, device="cpu")
        q = 0.5 * _randn(7, w, d)
    mass = rng.uniform(0.5, 2.0, d).astype(np.float32)
    jinit, jstep = jc.build_jittered_hmc_kernel(jfn, max_steps=max_steps)
    tinit, tstep = tc.build_jittered_hmc_kernel(tfn, max_steps=max_steps)
    jstate = jinit(jnp.asarray(q), mass=jnp.asarray(mass))
    tstate = tinit(torch.as_tensor(q), mass=torch.as_tensor(mass))
    for n in (1, 5, 40):  # 40 clips to max_steps
        key = jax.random.key(n)
        key_mom, key_acc = jax.random.split(key)
        p0 = np.sqrt(mass) * np.asarray(
            jax.random.normal(key_mom, (w, d), jnp.float32))
        uniform = np.asarray(jax.random.uniform(
            key_acc, (w,), dtype=jnp.float32,
            minval=jnp.finfo(jnp.float32).tiny))
        jst, jinfo, (jq1, jp1) = jstep(key, jstate, jnp.float32(0.15),
                                       jnp.int32(n))
        tst, tinfo, (tq1, tp1) = tstep(
            (0, n), tstate, torch.tensor(0.15), torch.tensor(n),
            momentum=torch.as_tensor(p0), uniform=torch.as_tensor(uniform))
        np.testing.assert_allclose(tq1.numpy(), np.asarray(jq1), **TOL)
        np.testing.assert_allclose(tp1.numpy(), np.asarray(jp1), **TOL)
        np.testing.assert_allclose(tinfo.energy_error.numpy(),
                                   np.asarray(jinfo.energy_error),
                                   rtol=1e-4, atol=1e-4)
        same = tinfo.accepted.numpy() == np.asarray(jinfo.accepted)
        assert same.mean() > 0.98
        np.testing.assert_allclose(tst.ensemble.q.numpy()[same],
                                   np.asarray(jst.ensemble.q)[same], **TOL)
        np.testing.assert_allclose(tst.potential_energy.numpy()[same],
                                   np.asarray(jst.potential_energy)[same],
                                   rtol=1e-4, atol=1e-4)


def test_composed_step_reads_the_count_once_a_transition():
    """The composed route's cost, counted: one host read of the leapfrog
    count per transition, and no other route reads it."""
    target = tp.make_standard_normal(3)
    q0 = torch.as_tensor(_randn(0, 64, 3))
    before = tc._host_count.reads
    res = pt.run_chees_hmc(0, target, q0, num_warmup=30, num_samples=20,
                           max_steps=16, collect="none")
    assert tc._host_count.reads - before == 50
    assert (res.kernel_used, res.warmup_kernel_used) == ("composed",
                                                         "composed")
    assert res.samples is None and res.mean is None
    res = pt.run_chees_hmc(0, target, q0, num_warmup=0, num_samples=3,
                           max_steps=16)
    assert res.warmup_kernel_used == "none" and res.samples.shape == (3, 64,
                                                                      3)
    res = pt.run_chees_hmc(0, target, q0, num_warmup=0, num_samples=0)
    assert np.isnan(float(res.accept_rate)) and res.samples.shape == (0, 64,
                                                                      3)


def test_chees_adapts_tau_and_samples_correctly():
    """Standard normal: warmup grows tau from far below into the band
    around the ChEES-optimal O(pi / 2), the posterior stays right."""
    res = pt.run_chees_hmc(
        0, tp.make_standard_normal(8), torch.as_tensor(_randn(1, 1024, 8)),
        num_warmup=300, num_samples=300, init_tau=0.1, init_step_size=0.2,
        collect="moments")
    assert 0.5 < float(res.trajectory_time) < 6.0
    assert float(res.accept_rate) > 0.6
    assert 1.0 <= float(res.mean_num_steps) <= 1024.0
    np.testing.assert_allclose(res.mean.numpy(), 0.0, atol=0.1)
    np.testing.assert_allclose(res.var.numpy(), 1.0, atol=0.2)


def test_chees_handles_anisotropic_target():
    mean = np.float32([1.0, -1.0])
    cov = np.float32([[2.0, 0.9], [0.9, 1.0]])
    res = pt.run_chees_hmc(
        2, tp.make_gaussian(mean, cov=cov, device="cpu"),
        torch.as_tensor(mean + _randn(3, 1024, 2)), num_warmup=300,
        num_samples=300, init_tau=0.5, init_step_size=0.2,
        collect="moments")
    np.testing.assert_allclose(res.mean.numpy(), mean, atol=0.15)
    np.testing.assert_allclose(res.var.numpy(), np.diag(cov), atol=0.4)


def test_chees_mass_adaptation_scales_step():
    """On a badly scaled Gaussian the adapted mass absorbs the variances
    (mass ~ 1 / var) and dual averaging settles at a much larger step than
    without it, the posterior variances still right."""
    scales = np.float32([0.1, 0.1, 1.0, 1.0, 10.0, 10.0, 1.0, 1.0])
    target = tp.make_harmonic(1.0 / scales**2, device="cpu")
    q0 = torch.as_tensor(scales * _randn(0, 1024, 8))
    kw = dict(num_warmup=400, num_samples=200, init_step_size=0.05,
              collect="moments")
    on = pt.run_chees_hmc(1, target, q0, adapt_mass=True, **kw)
    off = pt.run_chees_hmc(1, target, q0, adapt_mass=False, **kw)
    mass = on.state.ensemble.mass.numpy()
    assert mass.shape == (8,) and 30.0 < mass[0] / mass[2] < 300.0, mass
    assert float(on.step_size) > 2.0 * float(off.step_size)
    np.testing.assert_allclose(on.var.numpy(), scales**2, rtol=0.25)


def test_chees_validates_its_options():
    target = tp.make_standard_normal(2)
    q0 = torch.zeros(8, 2)
    with pytest.raises(ValueError, match="collect"):
        pt.run_chees_hmc(0, target, q0, num_warmup=0, num_samples=1,
                         collect="bad")
    # the JAX package's name for the composed engine is not taken silently
    with pytest.raises(ValueError, match="auto\\|fused\\|composed"):
        pt.run_chees_hmc(0, target, q0, num_warmup=0, num_samples=1,
                         kernel="xla")
    # kernel="fused" on CPU tensors raises (the JAX package falls back)
    with pytest.raises(ValueError, match="cannot run.*cpu"):
        pt.run_chees_hmc(0, target, q0, num_warmup=1, num_samples=1,
                         kernel="fused")
    with pytest.raises(ValueError, match="no fused kernel takes"):
        tc.build_fused_jittered_step(lambda q: q.sum(-1), num_dims=2)
    step = tc.build_fused_jittered_step(target, num_dims=2, max_steps=4)
    init, _ = tc.build_jittered_hmc_kernel(target)
    with pytest.raises(ValueError, match="int32 tensor"):
        step((0, 0), init(q0), 0.1, 3)


def test_fused_jittered_step_on_cpu_tensors_runs_the_plain_kernels():
    """The fused step on CPU tensors is the kernels' plain versions: the
    count clips at max_steps, the proposal comes with emit_proposal, and a
    diag-quadratic target samples its closed form through it."""
    target = tp.make_harmonic(np.float32([0.5, 2.0, 1.0]), device="cpu")
    init, _ = tc.build_jittered_hmc_kernel(target)
    state = init(torch.as_tensor(_randn(0, 2000, 3)))
    step = tc.build_fused_jittered_step(target, num_dims=3, max_steps=8)
    warm = tc.build_fused_jittered_step(target, num_dims=3, max_steps=8,
                                        emit_proposal=True)
    n = torch.tensor([100], dtype=torch.int32)
    a, _ = step((1, 0), state, torch.tensor(0.3), n)
    b, _, (q1, p1) = warm((1, 0), state, torch.tensor(0.3),
                          torch.tensor([8], dtype=torch.int32))
    np.testing.assert_allclose(a.ensemble.q.numpy(), b.ensemble.q.numpy(),
                               **TOL)
    assert q1.shape == p1.shape == (2000, 3)
    qs = []
    hs = tc.halton_sequence(60)
    for t in range(60):
        count = tc.steps_for(torch.tensor(1.5), torch.tensor(hs[t]),
                             torch.tensor(0.3), 8)
        state, info = step((1, t), state, torch.tensor(0.3), count)
        if t >= 20:
            qs.append(state.ensemble.q)
    var = torch.cat(qs).var(0).numpy()
    np.testing.assert_allclose(var, [2.0, 0.5, 1.0], rtol=0.1)


def test_eight_schools_posterior_matches_the_jax_run():
    """Non-centred eight schools through both packages' ChEES (composed
    engines, their own random streams): posterior means of mu and tau
    within Monte-Carlo error. 512 walkers x 150 kept transitions; the two
    runs' means of mu (posterior sd 3.3) differ by well under 0.3, of tau
    (sd 3.2, heavy-tailed) by under 0.4."""
    data = tm.EIGHT_SCHOOLS_DATA
    tmp = tm.make_model_potential(tm.eight_schools_noncentered, (), data,
                                  device="cpu")
    jmp = jm.make_model_potential(
        jm.examples.eight_schools_noncentered, (),
        {"J": 8, "sigma": jnp.asarray(data["sigma"]),
         "y": jnp.asarray(data["y"])})
    q0 = np.random.default_rng(0).uniform(-2, 2, (512, 10)).astype(np.float32)
    kw = dict(num_warmup=150, num_samples=150, init_step_size=0.22,
              max_steps=64, collect="samples")
    tres = pt.run_chees_hmc(0, tmp.potential, torch.as_tensor(q0), **kw)
    jres = jc.run_chees_hmc(jax.random.key(0), jmp.potential,
                            jnp.asarray(q0), kernel="xla", **kw)
    tpost = tmp.constrain_samples(tres.samples)
    jpost = jmp.constrain_samples(jres.samples)
    assert float(tres.accept_rate) > 0.6 and tres.kernel_used == "composed"
    for name, tol in (("mu", 0.3), ("tau", 0.4)):
        have, want = float(tpost[name].mean()), float(jpost[name].mean())
        assert abs(have - want) < tol, (name, have, want)
    np.testing.assert_allclose(float(tpost["mu"].mean()), 4.4, atol=0.4)
