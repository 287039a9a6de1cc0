"""Plain versions of the fused CUDA kernels against the JAX Pallas kernels
(run in interpret mode on the CPU, as tests/test_pallas_interpret.py runs
them), plus the CPU dispatch of the wrappers.

With ``p_std=0`` a trajectory starts from rest, so energy_error and
accept_prob do not depend on either side's random stream: they are
compared elementwise, and q', u', g' on walkers both sides accepted, all
at rtol=atol=1e-5 (float32, sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu.ops import pallas_kernels as jk
from physicsbasedbayesianinference_tpu.ops import potentials as jp
import physicsbasedbayesianinference_tpu_torch as pt
from physicsbasedbayesianinference_tpu_torch.ops import kernels as tk
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp
from physicsbasedbayesianinference_tpu_torch.utils import convert
from _torch_cpu import cpu_requested  # noqa: F401  (the CPU, asked for)

pytestmark = pytest.mark.skipif(
    jax.default_backend() == "tpu",
    reason="the JAX side runs the Pallas kernels in interpret mode")

TOL = dict(rtol=1e-5, atol=1e-5)


def _compare(jout, tout, names):
    j = dict(zip(names, (np.asarray(x) for x in jout)))
    t = dict(zip(names, (x.numpy() for x in tout)))
    np.testing.assert_allclose(t["energy_error"], j["energy_error"], **TOL)
    np.testing.assert_allclose(t["accept_prob"], j["accept_prob"], **TOL)
    both = j["accepted"] & t["accepted"]
    assert both.mean() > 0.5
    for key in ("q", "u", "g"):
        np.testing.assert_allclose(t[key][both], j[key][both], **TOL)
    return t, both


# (scale, beta): the potential scale SMC's mutations give the kernels and
# the per-call beta of a parallel-tempering rung, each at 1 and not
_SCALE_BETA = [pytest.param(1.0, None, id="1.0"),
               pytest.param(0.5, None, id="0.5"),
               pytest.param(0.37, 1.0, id="0.37-beta1.0"),
               pytest.param(1.0, 0.21, id="1.0-beta0.21"),
               pytest.param(0.5, 0.21, id="0.5-beta0.21")]


@pytest.mark.parametrize("scale,beta", _SCALE_BETA)
def test_diag_quadratic_plain_matches_pallas(scale, beta):
    w, d, steps = 256, 32, 4
    rng = np.random.default_rng(0)
    q = rng.normal(size=(w, d)).astype(np.float32)
    k = rng.uniform(0.5, 2.0, d).astype(np.float32)
    mu = rng.normal(size=d).astype(np.float32)
    im = rng.uniform(0.5, 2.0, d).astype(np.float32)
    step, beta = 0.2, 1.3 if beta is None else beta
    jout = jk.make_fused_hmc_diag_quadratic(num_steps=steps)(
        jnp.int32(5), jnp.asarray(q), step_size=jnp.float32(step),
        p_std=0.0, inv_mass=jnp.asarray(im), beta=beta,
        k_diag=jnp.asarray(k), mean=jnp.asarray(mu),
        scale=jnp.float32(scale))
    tout = tk.fused_hmc_diag_quadratic_plain(
        5, 0, torch.as_tensor(q),
        scalars=torch.tensor([step, beta, scale]),
        p_std=torch.zeros(d), inv_mass=torch.as_tensor(im),
        k_diag=torch.as_tensor(k), mean=torch.as_tensor(mu),
        num_steps=steps)
    t, both = _compare(jout, tout, ("q", "g", "u", "accept_prob",
                                    "accepted", "energy_error"))
    # (u, g) stay unscaled whatever the scale
    qc = t["q"] - mu
    np.testing.assert_allclose(t["u"], 0.5 * np.sum(k * qc * qc, axis=1),
                               rtol=1e-5)
    np.testing.assert_allclose(t["g"], k * qc, rtol=1e-5, atol=1e-6)


# kernel A's bfloat16 trajectory: one bf16 unit in the last place of |q'|,
# 2^-7 |q'|, for q' and g' (XLA may keep a bf16 intermediate in float32
# inside its fused loop, which moves the trajectory's last bits; on this
# jax the interpret-mode kernel rounds every operation, as the plain
# version does, and q' agrees bit for bit); the energy error and u' to
# 1e-3 absolute and relative, what such a last-bit move of q' makes of
# them over 32 dims. A float32 trajectory is 0.47-0.51 off in the energy
# error and 0.06-0.13 in q' at these settings, so the test tells the two
# apart; q' must also be representable in bfloat16.
BF16_ULP = 2.0**-7


@pytest.mark.parametrize("steps,step,scale", [(4, 0.2, 1.0),
                                              (16, 0.6, 0.5)])
def test_diag_quadratic_bf16_trajectory_matches_pallas(steps, step, scale):
    w, d, beta = 256, 32, 1.3
    rng = np.random.default_rng(0)
    q = rng.normal(size=(w, d)).astype(np.float32)
    k = rng.uniform(0.5, 2.0, d).astype(np.float32)
    mu = rng.normal(size=d).astype(np.float32)
    im = rng.uniform(0.5, 2.0, d).astype(np.float32)
    jout = jk.make_fused_hmc_diag_quadratic(
        num_steps=steps, trajectory_dtype=jnp.bfloat16)(
        jnp.int32(5), jnp.asarray(q), step_size=jnp.float32(step),
        p_std=0.0, inv_mass=jnp.asarray(im), beta=beta,
        k_diag=jnp.asarray(k), mean=jnp.asarray(mu),
        scale=jnp.float32(scale))
    kw = dict(scalars=torch.tensor([step, beta, scale]),
              p_std=torch.zeros(d), inv_mass=torch.as_tensor(im),
              k_diag=torch.as_tensor(k), mean=torch.as_tensor(mu),
              num_steps=steps)
    tout = tk.fused_hmc_diag_quadratic(
        5, 0, torch.as_tensor(q), trajectory_dtype=torch.bfloat16, **kw)
    names = ("q", "g", "u", "accept_prob", "accepted", "energy_error")
    j = dict(zip(names, (np.asarray(x) for x in jout)))
    t = dict(zip(names, (x.numpy() for x in tout)))
    both = j["accepted"] & t["accepted"]
    assert both.mean() > 0.5
    for key in ("energy_error", "accept_prob"):
        np.testing.assert_allclose(t[key], j[key], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(t["u"][both], j["u"][both], rtol=1e-3,
                               atol=1e-3)
    ulp = BF16_ULP * np.abs(j["q"][both])
    assert (np.abs(t["q"][both] - j["q"][both]) <= ulp).all()
    assert (np.abs(t["g"][both] - j["g"][both]) <= k * ulp + 1e-6).all()
    q_out = tout[0]
    assert torch.equal(q_out.to(torch.bfloat16).float(), q_out)
    f32 = tk.fused_hmc_diag_quadratic(5, 0, torch.as_tensor(q), **kw)
    assert (f32[5] - tout[5]).abs().max() > 0.1
    with pytest.raises(ValueError, match="trajectory_dtype"):
        tk.fused_hmc_diag_quadratic(5, 0, torch.as_tensor(q),
                                    trajectory_dtype=torch.float16, **kw)


def _target(kind, rng, w):
    """(JAX potential, numpy parameters, start positions, step size)."""
    if kind == "gaussian":
        d = 5
        a = rng.normal(size=(d, d))
        params = {"mean": rng.normal(size=d).astype(np.float32),
                  "cov": (a @ a.T / d + 0.5 * np.eye(d)).astype(np.float32)}
        return (jp.make_gaussian(params["mean"], cov=params["cov"]), params,
                rng.normal(size=(w, d)), 0.15)
    if kind == "funnel":
        params = {"num_dims": 6, "sigma": 3.0}
        return (jp.make_funnel(6, 3.0), params,
                0.5 * rng.normal(size=(w, 6)), 0.15)
    if kind == "banana":
        params = {"a": 1.0, "b": 10.0}
        return (jp.make_banana(1.0, 10.0), params,
                0.5 * rng.normal(size=(w, 2)), 0.05)
    if kind == "mixture":
        params = {"means": 2.0 * rng.normal(size=(3, 4)).astype(np.float32),
                  "sigma": 1.2,
                  "log_weights": np.float32([0.0, -0.4, 0.2])}
        return (jp.make_gaussian_mixture(params["means"], 1.2,
                                         params["log_weights"]),
                params, 2.0 * rng.normal(size=(w, 4)), 0.15)
    params = {"mass": rng.uniform(0.5, 1.5, 4).astype(np.float32),
              "num_bodies": 4, "softening": 0.5}
    return (jp.make_nbody_potential(params["mass"], 4, softening=0.5),
            params, 1.5 * rng.normal(size=(w, 12)), 0.15)


@pytest.mark.parametrize("kind", ["gaussian", "funnel", "banana", "mixture",
                                  "nbody"])
@pytest.mark.parametrize("scale,beta", _SCALE_BETA)
def test_generic_plain_matches_pallas(kind, scale, beta):
    w, steps = 64, 4
    rng = np.random.default_rng(1)
    jfn, params, q, step = _target(kind, rng, w)
    q = q.astype(np.float32)
    d = q.shape[1]
    vg = jp.batched_value_and_grad(jfn)
    u, g = (np.array(x) for x in vg(jnp.asarray(q)))
    im = rng.uniform(0.5, 2.0, d).astype(np.float32)
    beta = 1.0 if beta is None else beta
    jout = jk.make_fused_hmc_transition(vg, num_steps=steps)(
        jnp.int32(3), jnp.asarray(q), jnp.asarray(u), jnp.asarray(g),
        step_size=jnp.float32(step), p_std=0.0, inv_mass=jnp.asarray(im),
        beta=beta, scale=jnp.float32(scale))
    form = convert.potential_params_from_numpy(kind, params).device_form
    tout = tk.fused_hmc_transition_plain(
        form, 3, 0, torch.as_tensor(q), torch.as_tensor(u),
        torch.as_tensor(g), scalars=torch.tensor([step, beta, scale]),
        p_std=torch.zeros(d), inv_mass=torch.as_tensor(im), num_steps=steps)
    t, both = _compare(jout, tout, ("q", "u", "g", "accept_prob",
                                    "accepted", "energy_error"))
    uu, gg = vg(jnp.asarray(t["q"][both]))  # unscaled (u, g) of q'
    np.testing.assert_allclose(t["u"][both], np.asarray(uu), **TOL)
    np.testing.assert_allclose(t["g"][both], np.asarray(gg), **TOL)


def _fused_moments(fn, q0, step, n, burn):
    kern = pt.build_fused_hmc_kernel(fn, num_steps=8)
    st = kern.init(torch.as_tensor(q0))
    qs, accs = [], []
    for i in range(n):
        st, info = kern.step((17, i), st, torch.tensor(step))
        if i >= burn:
            qs.append(st.ensemble.q)
            accs.append(float(info.accept_prob.mean()))
    return torch.cat(qs).double(), float(np.mean(accs)), kern


def test_plain_kernels_sample_the_closed_form():
    """p_std = 1 through the CPU fused engine (the plain versions): the
    equilibrium moments of a diagonal and a correlated Gaussian. MC error
    bounds: 1000 walkers x 50 kept transitions."""
    rng = np.random.default_rng(2)
    k = np.float32([0.5, 1.0, 2.0, 4.0])
    mu = np.float32([1.0, -2.0, 0.5, 0.0])
    diag = tp.make_gaussian(mu, precision=np.diag(k))
    q, acc, kern = _fused_moments(diag, rng.normal(size=(1000, 4)) * 0.5
                                  + mu, 0.35, 70, 20)
    assert kern.variant_for(1000, 4, 1) == "diag" and 0.6 < acc <= 1.0
    np.testing.assert_allclose(q.mean(0).numpy(), mu, atol=0.05)
    np.testing.assert_allclose(q.var(0).numpy(), 1.0 / k, rtol=0.06)

    mean = np.float32([2.0, -1.0])
    cov = np.float32([[1.0, 0.8], [0.8, 2.0]])
    corr = tp.make_gaussian(mean, cov=cov)
    q, acc, kern = _fused_moments(corr, rng.normal(size=(1000, 2)) + mean,
                                  0.25, 70, 20)
    assert kern.variant_for(1000, 2, 1) == "generic" and 0.6 < acc <= 1.0
    np.testing.assert_allclose(q.mean(0).numpy(), mean, atol=0.06)
    np.testing.assert_allclose(np.cov(q.numpy().T), cov, atol=0.1)


def test_wrappers_on_cpu_run_the_plain_version_and_count_nothing():
    q = torch.randn(10, 3, generator=torch.Generator().manual_seed(0))
    kw = dict(scalars=torch.tensor([0.1, 1.0, 1.0]), p_std=torch.ones(3),
              inv_mass=torch.ones(3), num_steps=3)
    before = tk.launch_counts()
    a = tk.fused_hmc_diag_quadratic(9, 4, q, k_diag=torch.ones(3),
                                    mean=torch.zeros(3), **kw)
    b = tk.fused_hmc_diag_quadratic_plain(9, 4, q, k_diag=torch.ones(3),
                                          mean=torch.zeros(3), **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    form = tp.make_gaussian(np.zeros(3), cov=np.eye(3)).device_form
    u, g = tk.device_value_and_grad(form)(q)
    c = tk.fused_hmc_transition(form, 9, 4, q, u, g, **kw)
    d = tk.fused_hmc_transition_plain(form, 9, 4, q, u, g, **kw)
    for x, y in zip(c, d):
        assert torch.equal(x, y)
    assert tk.launch_counts() == before
    # the same (seed, transition) draws the same bits; the next one not
    e = tk.fused_hmc_diag_quadratic(9, 5, q, k_diag=torch.ones(3),
                                    mean=torch.zeros(3), **kw)
    assert not torch.equal(a[5], e[5])


def test_wrappers_refuse_other_devices():
    q = torch.empty(4, 3, device="meta")
    vec = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.fused_hmc_diag_quadratic(
            0, 0, q, scalars=torch.empty(3, device="meta"), p_std=vec,
            inv_mass=vec, k_diag=vec, mean=vec, num_steps=2)
    with pytest.raises(ValueError, match="unknown device form"):
        tk.device_value_and_grad(("rosenbrock", ()))


# ---------------------------------------------------------------------------
# Kernel D: the leapfrog trajectory (make_pallas_leapfrog in interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["std_normal", "funnel"])
def test_leapfrog_plain_matches_pallas(kind):
    """q', p', u', g' to rtol=atol=1e-5 (float32): the standard normal as a
    diagonal-quadratic form, the funnel as its device form, whose JAX side
    is autodiff traced into the kernel."""
    rng = np.random.default_rng(4)
    if kind == "std_normal":
        w, d, steps, step = 512, 8, 10, 0.1
        jfn = jp.make_standard_normal(d)
        form = ("diag", (torch.ones(d), torch.zeros(d)))
        q = rng.normal(size=(w, d))
    else:
        w, d, steps, step = 256, 4, 5, 0.05
        jfn = jp.make_funnel(d)
        form = tp.make_funnel(d).device_form
        q = 0.3 * rng.normal(size=(w, d))
    q = q.astype(np.float32)
    p = rng.normal(size=(w, d)).astype(np.float32)
    im = rng.uniform(0.5, 2.0, d).astype(np.float32)
    jout = jk.make_pallas_leapfrog(128)(
        jp.batched_value_and_grad(jfn), jnp.asarray(q), jnp.asarray(p),
        step_size=jnp.float32(step), num_steps=steps,
        inv_mass=jnp.asarray(im))
    tout = tk.leapfrog_trajectory_plain(
        form, torch.as_tensor(q), torch.as_tensor(p),
        step_size=torch.tensor(step), num_steps=steps,
        inv_mass=torch.as_tensor(im))
    for a, b in zip(tout, jout):  # q', p', u', g'
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_leapfrog_wrapper_on_cpu_and_its_integrator():
    """On CPU tensors the wrapper is its plain version and launches
    nothing; the cached (u, g) gives what a fresh evaluation gives; the
    registered integrator is the plain leapfrog there."""
    from physicsbasedbayesianinference_tpu_torch.ops import integrators as ti
    gen = torch.Generator().manual_seed(3)
    q, p = torch.randn(20, 6, generator=gen), torch.randn(20, 6, generator=gen)
    target = tp.make_gaussian(np.zeros(6), cov=np.eye(6) + 0.4)
    form = target.device_form
    kw = dict(step_size=torch.tensor(0.1), num_steps=4,
              inv_mass=torch.full((6,), 0.8))
    before = tk.launch_counts()
    a = tk.leapfrog_trajectory(form, q, p, **kw)
    b = tk.leapfrog_trajectory_plain(form, q, p, **kw)
    u, g = tk.device_value_and_grad(form)(q)
    c = tk.leapfrog_trajectory(form, q, p, grad=g, potential_energy=u, **kw)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    vg = tp.batched_value_and_grad(target)
    assert vg.device_form is form and vg.diag_quadratic is None
    d = ti.get_integrator("pallas_leapfrog")(vg, q, p, **kw)
    e = ti.leapfrog(vg, q, p, **kw)
    for x, y in zip(d, e):
        assert torch.equal(x, y)
    assert tk.launch_counts() == before


def test_pallas_leapfrog_off_the_cpu_needs_a_device_form():
    """Off the CPU the integrator runs kernel D, which needs a device form:
    a potential without one raises before any launch, naming the form."""
    from physicsbasedbayesianinference_tpu_torch.ops import integrators as ti

    def plain(q):
        return 0.5 * torch.sum(q * q, dim=-1)

    q = torch.empty(4, 3, device="meta")
    integ = ti.get_integrator("pallas_leapfrog")
    with pytest.raises(ValueError, match="device_form"):
        integ(tp.batched_value_and_grad(plain), q, q, step_size=0.1,
              num_steps=2, inv_mass=1.0)
    # with a form it reaches the wrapper, which takes CPU or CUDA only
    with pytest.raises(ValueError, match="CPU or CUDA"):
        integ(tp.batched_value_and_grad(tp.make_standard_normal(3)), q, q,
              step_size=0.1, num_steps=2, inv_mass=1.0)
    with pytest.raises(ValueError, match="D <= 128"):
        integ(tp.batched_value_and_grad(tp.make_standard_normal(129)),
              torch.empty(4, 129, device="meta"),
              torch.empty(4, 129, device="meta"), step_size=0.1,
              num_steps=2, inv_mass=1.0)


def test_run_hmc_pallas_leapfrog_end_to_end():
    """run_hmc(integrator="pallas_leapfrog") on the CPU, moments as
    tests/test_pallas.py checks the JAX run: 256 walkers x 100 kept
    transitions of a 4-dim standard normal."""
    q0 = np.random.default_rng(1).normal(size=(256, 4)).astype(np.float32)
    res = pt.run_hmc(0, tp.make_standard_normal(4), torch.as_tensor(q0),
                     num_warmup=100, num_samples=100, num_steps=8,
                     integrator="pallas_leapfrog", collect="moments")
    assert res.kernel_used == "composed"
    np.testing.assert_allclose(res.mean.numpy(), 0.0, atol=0.1)
    np.testing.assert_allclose(res.var.numpy(), 1.0, atol=0.15)
    assert float(res.accept_rate) > 0.6
    assert res.num_grad_evals == 200 * 256 * 9


# ---------------------------------------------------------------------------
# The leapfrog count on the device and the proposal outputs
# ---------------------------------------------------------------------------


def _count(n):
    return torch.tensor([n], dtype=torch.int32)


@pytest.mark.parametrize("kernel", ["A", "B"])
def test_tensor_count_is_the_int_count_bit_for_bit_and_clips(kernel):
    """A tensor num_steps gives the bits of the int it holds, and is
    clipped to [1, max_steps] at both ends; an int takes no max_steps."""
    rng = np.random.default_rng(6)
    q = torch.as_tensor(rng.normal(size=(50, 6)).astype(np.float32))
    kw = dict(scalars=torch.tensor([0.2, 1.0, 1.0]), p_std=torch.ones(6),
              inv_mass=torch.full((6,), 1.3))
    if kernel == "A":
        kw.update(k_diag=torch.linspace(0.5, 2.0, 6), mean=torch.zeros(6))

        def run(**steps):
            return tk.fused_hmc_diag_quadratic(4, 2, q, **kw, **steps)
    else:
        form = tp.make_funnel(6).device_form
        u, g = tk.device_value_and_grad(form)(q)

        def run(**steps):
            return tk.fused_hmc_transition(form, 4, 2, q, u, g, **kw, **steps)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    assert same(run(num_steps=_count(7), max_steps=16), run(num_steps=7))
    assert same(run(num_steps=_count(40), max_steps=16), run(num_steps=16))
    assert same(run(num_steps=_count(0), max_steps=16), run(num_steps=1))
    assert same(run(num_steps=_count(-3), max_steps=16), run(num_steps=1))
    assert not same(run(num_steps=7), run(num_steps=8))
    with pytest.raises(ValueError, match="needs max_steps"):
        run(num_steps=_count(7))
    with pytest.raises(ValueError, match="goes with a tensor"):
        run(num_steps=7, max_steps=16)


def test_proposal_is_the_flipped_endpoint_for_every_walker():
    """emit_proposal adds (q1, -p1), the trajectory's endpoint from the
    transition's own momentum draw, for accepted and rejected walkers
    alike; the first six outputs are those without it, bit for bit."""
    rng = np.random.default_rng(8)
    form = tp.make_gaussian(np.zeros(5, np.float32),
                            cov=(np.eye(5) + 0.3).astype(np.float32)
                            ).device_form
    q = torch.as_tensor(rng.normal(size=(200, 5)).astype(np.float32))
    u, g = tk.device_value_and_grad(form)(q)
    im = torch.as_tensor(rng.uniform(0.5, 2.0, 5).astype(np.float32))
    kw = dict(scalars=torch.tensor([0.45, 1.0, 1.0]),
              p_std=torch.sqrt(1.0 / im), inv_mass=im, num_steps=6)
    plain = tk.fused_hmc_transition(form, 9, 1, q, u, g, **kw)
    out = tk.fused_hmc_transition(form, 9, 1, q, u, g, emit_proposal=True,
                                  **kw)
    assert len(plain) == 6 and len(out) == 8
    for a, b in zip(plain, out):
        assert torch.equal(a, b)
    accepted = out[4]
    assert 20 < int(accepted.sum()) < 200  # both kinds are there
    p0 = tk._momenta(9, 1, q, kw["p_std"])
    q1, p1, _, _ = tk.leapfrog_trajectory_plain(
        form, q, p0, step_size=torch.tensor(0.45), num_steps=6, inv_mass=im)
    np.testing.assert_allclose(out[6].numpy(), q1.numpy(), **TOL)
    np.testing.assert_allclose(out[7].numpy(), -p1.numpy(), **TOL)
    assert torch.equal(out[6][accepted], out[0][accepted])
    assert torch.equal(out[0][~accepted], q[~accepted])


@pytest.mark.parametrize("kind", ["gaussian", "funnel"])
def test_counted_plain_with_proposal_matches_pallas(kind):
    """Kernel B's plain version with a tensor count and emit_proposal
    against the TPU kernel with dynamic_steps=True, emit_proposal=True in
    interpret mode, from rest (p_std = 0), so that nothing depends on
    either side's draws: energy_error, accept_prob and the proposal of
    every walker, to rtol=atol=1e-5; a count over max_steps clips on both
    sides."""
    w, max_steps = 64, 6
    rng = np.random.default_rng(1)
    jfn, params, q, step = _target(kind, rng, w)
    q = q.astype(np.float32)
    d = q.shape[1]
    vg = jp.batched_value_and_grad(jfn)
    u, g = (np.array(x) for x in vg(jnp.asarray(q)))
    im = rng.uniform(0.5, 2.0, d).astype(np.float32)
    trans = jk.make_fused_hmc_transition(
        vg, num_steps=max_steps, dynamic_steps=True, emit_proposal=True)
    form = convert.potential_params_from_numpy(kind, params).device_form
    for n in (1, 4, 9):
        jout = trans(jnp.int32(3), jnp.asarray(q), jnp.asarray(u),
                     jnp.asarray(g), step_size=jnp.float32(step), p_std=0.0,
                     inv_mass=jnp.asarray(im), beta=1.0,
                     num_steps=jnp.int32(min(n, max_steps)))
        tout = tk.fused_hmc_transition_plain(
            form, 3, 0, torch.as_tensor(q), torch.as_tensor(u),
            torch.as_tensor(g), scalars=torch.tensor([step, 1.0, 1.0]),
            p_std=torch.zeros(d), inv_mass=torch.as_tensor(im),
            num_steps=_count(n), max_steps=max_steps, emit_proposal=True)
        _compare(jout[:6], tout[:6], ("q", "u", "g", "accept_prob",
                                      "accepted", "energy_error"))
        np.testing.assert_allclose(tout[6].numpy(), np.asarray(jout[6]),
                                   **TOL)
        np.testing.assert_allclose(tout[7].numpy(), np.asarray(jout[7]),
                                   **TOL)


def test_kernel_b_takes_the_diagonal_form_for_the_proposal():
    """Kernel A has no proposal outputs, so the fused engine sends a
    diag-quadratic target through kernel B's diagonal form when the
    proposal is asked for; both give the same transition."""
    from physicsbasedbayesianinference_tpu_torch import hmc
    target = tp.make_harmonic(np.float32([0.5, 1.0, 2.0]))
    fused = hmc.FusedTransition(target)
    assert fused.variant_for(100, 3) == "diag"
    state = hmc.init_state(tp.batched_value_and_grad(target),
                           torch.randn(100, 3,
                                       generator=torch.Generator(
                                       ).manual_seed(0)))
    a, info_a, none = fused((5, 0), state, 0.3, num_steps=4)
    b, info_b, prop = fused((5, 0), state, 0.3, num_steps=4,
                            emit_proposal=True)
    assert none is None and prop[0].shape == (100, 3)
    assert torch.equal(info_a.accepted, info_b.accepted)
    np.testing.assert_allclose(a.ensemble.q.numpy(), b.ensemble.q.numpy(),
                               **TOL)
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), **TOL)


def _form_at_offsets(name, rng, w):
    """(device form, q) for each form kernel B takes."""
    if name == "diag":
        d = 6
        return (("diag", (torch.as_tensor(rng.uniform(0.5, 2.0, d),
                                          dtype=torch.float32),
                          torch.as_tensor(rng.normal(size=d),
                                          dtype=torch.float32))),
                rng.normal(size=(w, d)))
    if name == "logistic":
        d, n = 5, 20
        return (("logistic", (
            torch.as_tensor(rng.normal(size=(n, d - 1)), dtype=torch.float32),
            torch.as_tensor(rng.integers(0, 2, n), dtype=torch.float32))),
            0.3 * rng.normal(size=(w, d)))
    if name == "eight_schools_nc":
        j = 8
        return (("eight_schools_nc", (
            torch.as_tensor(10 * rng.normal(size=j), dtype=torch.float32),
            torch.as_tensor(rng.uniform(9, 18, j), dtype=torch.float32),
            torch.tensor([1.5]))), 0.3 * rng.normal(size=(w, j + 2)))
    _, params, q, _ = _target(name, rng, w)
    return convert.potential_params_from_numpy(name, params).device_form, q


@pytest.mark.parametrize("name", ["gaussian", "funnel", "banana", "mixture",
                                  "nbody", "diag", "logistic",
                                  "eight_schools_nc"])
def test_plain_kernels_at_offsets_join_to_the_whole(name):
    """The rows [0, W/2) at walker offset 0 and [W/2, W) at offset W/2 are
    the whole launch's rows, bit for bit: kernel B for every form, kernel
    A for the diagonal one (the draws name the global walker)."""
    w, rng = 64, np.random.default_rng(8)
    form, q = _form_at_offsets(name, rng, w)
    q = torch.as_tensor(q, dtype=torch.float32)
    d = q.shape[1]
    u, g = tk.device_value_and_grad(form)(q)
    im = torch.as_tensor(rng.uniform(0.5, 2.0, d), dtype=torch.float32)
    # a step at which some walkers are accepted and some rejected
    step = {"gaussian": 0.8, "banana": 0.2, "mixture": 0.8,
            "nbody": 0.8}.get(name, 0.4)
    kw = dict(scalars=torch.tensor([step, 1.0, 1.0]),
              p_std=torch.sqrt(1.0 / im), inv_mass=im, num_steps=4)
    halves = (slice(0, w // 2), slice(w // 2, w))
    whole = tk.fused_hmc_transition(form, 3, 5, q, u, g, **kw)
    parts = [tk.fused_hmc_transition(form, 3, 5, q[s], u[s], g[s],
                                     walker_offset=s.start, **kw)
             for s in halves]
    for a, b0, b1 in zip(whole, *parts):
        assert torch.equal(a, torch.cat([b0, b1]))
    assert 0 < int(whole[4].sum()) < w  # accepted and rejected walkers
    if name == "diag":
        k_diag, mean = form[1]
        whole = tk.fused_hmc_diag_quadratic(3, 5, q, k_diag=k_diag,
                                            mean=mean, **kw)
        parts = [tk.fused_hmc_diag_quadratic(
            3, 5, q[s], k_diag=k_diag, mean=mean, walker_offset=s.start,
            **kw) for s in halves]
        for a, b0, b1 in zip(whole, *parts):
            assert torch.equal(a, torch.cat([b0, b1]))
    with pytest.raises(ValueError, match="walker_offset"):
        tk.fused_hmc_transition(form, 3, 5, q, u, g, walker_offset=-1, **kw)
    with pytest.raises(ValueError, match="walker_offset"):
        tk.fused_hmc_transition(form, 3, 5, q, u, g,
                                walker_offset=(1 << 32) - w + 1, **kw)
