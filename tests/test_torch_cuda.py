"""The fused CUDA kernels against their plain-torch versions, on the card.

Marked ``cuda``; every test skips without a CUDA device (decided inside the
fixture, never at import). On a GPU machine without JAX, run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``tests/conftest.py`` imports JAX; this file does not need it).
"""

import numpy as np
import pytest
import torch

import physicsbasedbayesianinference_tpu_torch as pt
from physicsbasedbayesianinference_tpu_torch.ops import kernels, philox
from physicsbasedbayesianinference_tpu_torch.ops import potentials as pot

pytestmark = pytest.mark.cuda

A_ORDER = ("q", "g", "u", "accept_prob", "accepted", "energy_error")
B_ORDER = ("q", "u", "g", "accept_prob", "accepted", "energy_error")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _t(x, dev):
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _assert_match(out_k, out_p, seed, counter):
    """energy_error/accept_prob to 1e-4 (1 + |x|): float32 sums in another
    order and libm ulps in the Box-Muller draws; decisions equal away from
    the accept boundary; q', u', g' to 1e-5 where decisions agree."""
    derr_k, derr_p = out_k["energy_error"], out_p["energy_error"]
    both_inf = torch.isinf(derr_k) & torch.isinf(derr_p)
    for key in ("energy_error", "accept_prob"):
        k, p = out_k[key], out_p[key]
        err = torch.where(both_inf, 0.0, (k - p).abs()).nan_to_num(
            nan=float("inf"))
        assert bool((err <= 1e-4 * (1 + p.abs().nan_to_num(0.0))).all()), key
    log_u = torch.log(philox.accept_uniforms(seed, counter, derr_p.shape[0],
                                             derr_p.device))
    agree = out_k["accepted"] == out_p["accepted"]
    clear = (log_u + derr_p).abs() > 1e-4
    assert bool((agree | ~clear).all())
    for key in ("q", "u", "g"):
        torch.testing.assert_close(out_k[key][agree], out_p[key][agree],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("w,d", [(1, 1), (37, 5), (300, 32), (64, 33),
                                 (50, 257)])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_diag_kernel_matches_plain(dev, w, d, scale):
    rng = np.random.default_rng(w * 1000 + d)
    q = _t(rng.normal(size=(w, d)), dev)
    im = _t(rng.uniform(0.5, 2.0, d), dev)
    kw = dict(scalars=_t([0.2, 1.3, scale], dev), p_std=torch.sqrt(1 / im),
              inv_mass=im, k_diag=_t(rng.uniform(0.5, 2.0, d), dev),
              mean=_t(rng.normal(size=d), dev), num_steps=12)
    before = kernels.fused_hmc_diag_quadratic.launches
    out_k = dict(zip(A_ORDER, kernels.fused_hmc_diag_quadratic(
        99, 5, q, **kw)))
    assert kernels.fused_hmc_diag_quadratic.launches == before + 1
    out_p = dict(zip(A_ORDER, kernels.fused_hmc_diag_quadratic_plain(
        99, 5, q, **kw)))
    torch.cuda.synchronize()
    assert out_k["accepted"].dtype == torch.bool
    _assert_match(out_k, out_p, 99, 5)


def _forms(d, dev):
    rng = np.random.default_rng(d)
    a = rng.normal(size=(d, d)) / np.sqrt(d)
    forms = [pot.make_gaussian(rng.normal(size=d),
                               cov=a @ a.T + 0.5 * np.eye(d),
                               device=dev).device_form]
    if d >= 2:
        forms.append(pot.make_funnel(d, device=dev).device_form)
    if d == 2:
        forms.append(pot.make_banana(1.0, 10.0, device=dev).device_form)
    forms.append(pot.make_gaussian_mixture(
        2.0 * rng.normal(size=(3, d)), 1.2, rng.normal(size=3),
        device=dev).device_form)
    if d % 3 == 0:
        forms.append(pot.make_nbody_potential(
            rng.uniform(0.5, 1.5, d // 3), d // 3, softening=0.5,
            device=dev).device_form)
    return forms


@pytest.mark.parametrize("w,d", [(1, 1), (45, 2), (300, 10), (64, 32),
                                 (50, 24), (40, 77), (33, 126), (33, 128)])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_generic_kernel_matches_plain(dev, w, d, scale):
    rng = np.random.default_rng(w + d)
    for form in _forms(d, dev):
        q = _t(0.5 * rng.normal(size=(w, d)), dev)
        u, g = kernels.device_value_and_grad(form)(q)
        im = _t(rng.uniform(0.5, 2.0, d), dev)
        kw = dict(scalars=_t([0.1, 1.0, scale], dev),
                  p_std=torch.sqrt(1 / im), inv_mass=im, num_steps=12)
        before = kernels.fused_hmc_transition.launches
        out_k = dict(zip(B_ORDER, kernels.fused_hmc_transition(
            form, 7, 3, q, u, g, **kw)))
        assert kernels.fused_hmc_transition.launches == before + 1
        out_p = dict(zip(B_ORDER, kernels.fused_hmc_transition_plain(
            form, 7, 3, q, u, g, **kw)))
        torch.cuda.synchronize()
        _assert_match(out_k, out_p, 7, 3)


def test_generic_kernel_rejects_wide_and_bad_inputs(dev):
    form = pot.make_gaussian(np.zeros(129), precision=np.eye(129),
                             device=dev).device_form
    q = torch.zeros(4, 129, device=dev)
    kw = dict(scalars=_t([0.1, 1.0, 1.0], dev),
              p_std=torch.ones(129, device=dev),
              inv_mass=torch.ones(129, device=dev), num_steps=2)
    with pytest.raises(ValueError, match="D <= 128"):
        kernels.fused_hmc_transition(form, 0, 0, q, q[:, 0], q, **kw)
    with pytest.raises(ValueError, match="float32"):
        kernels.fused_hmc_diag_quadratic(
            0, 0, q.double(), scalars=kw["scalars"], p_std=kw["p_std"],
            inv_mass=kw["inv_mass"], k_diag=kw["p_std"],
            mean=kw["p_std"], num_steps=2)


def test_run_hmc_generic_forms_on_cuda(dev):
    """Every built-in target without a diagonal-quadratic form runs through
    kernel B on the card."""
    for fn, d in ((pot.make_banana(1.0, 10.0), 2),
                  (pot.make_gaussian_mixture(np.float32([[-2, 0], [2, 0]])),
                   2),
                  (pot.make_nbody_potential(np.ones(4), 4, softening=0.5),
                   12)):
        q0 = torch.randn(512, d, generator=torch.Generator().manual_seed(1))
        kernels.reset_launch_counts()
        res = pt.run_hmc(5, fn, q0.to(dev), num_warmup=20, num_samples=10,
                         num_steps=4, collect="moments")
        assert (res.kernel_used, res.kernel_variant) == ("fused", "generic")
        assert kernels.launch_counts()["fused_hmc_transition"] == 30
        assert bool(torch.isfinite(res.mean).all())


def test_run_hmc_fused_on_cuda(dev):
    q0 = torch.randn(4096, 6, generator=torch.Generator().manual_seed(0))
    kernels.reset_launch_counts()
    res = pt.run_hmc(3, pot.make_standard_normal(6), q0.to(dev),
                     num_warmup=100, num_samples=100, num_steps=8,
                     collect="moments")
    assert (res.kernel_used, res.kernel_variant) == ("fused", "diag")
    assert kernels.launch_counts()["fused_hmc_diag_quadratic"] == 200
    assert float(res.mean.abs().max()) < 0.05
    assert float((res.var - 1).abs().max()) < 0.08


@pytest.mark.parametrize("kind", ["diag", "generic"])
def test_fused_step_and_adaptation_never_synchronise(dev, kind):
    """A warmup transition (fused step, dual averaging, variance stream)
    issues no host-device copy or stream synchronisation once its
    constants are on the device (the profiler records every such call)."""
    from torch.profiler import ProfilerActivity, profile

    from physicsbasedbayesianinference_tpu_torch.adaptation import (
        da_init, da_update, variance_init, variance_update)

    fn = (pot.make_standard_normal(8) if kind == "diag" else
          pot.make_gaussian(np.zeros(8), cov=np.eye(8) + 0.3, device=dev))
    kern = pt.build_fused_hmc_kernel(fn, num_steps=4)
    st = kern.init(torch.randn(256, 8, device=dev))
    da = da_init(torch.full((), 0.3, device=dev))
    var = variance_init(8, device=dev)
    st, _ = kern.step((1, 0), st, torch.exp(da.log_step))  # prepares
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for t in range(1, 6):
            st, info = kern.step((1, t), st, torch.exp(da.log_step))
            da = da_update(da, torch.mean(info.accept_prob))
            var = variance_update(var, st.ensemble.q)
    calls = {e.key: e.count for e in prof.key_averages()}
    blocking = {k: n for k, n in calls.items()
                if k in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                         "cudaMemcpy", "cudaMemcpyAsync")}
    assert not blocking, blocking
    assert calls.get("cudaLaunchKernel", 0) > 0  # the trace saw the card
    assert kern.variant_for(256, 8, 1) == kind


# ---------------------------------------------------------------------------
# Kernel D: the leapfrog trajectory
# ---------------------------------------------------------------------------


def _d_forms(d, dev):
    """Every form kernel D takes at dimension d, the diagonal one first."""
    rng = np.random.default_rng(d + 1)
    return [("diag", (_t(rng.uniform(0.5, 2.0, d), dev),
                      _t(rng.normal(size=d), dev)))] + _forms(d, dev)


@pytest.mark.parametrize("w,d", [(1, 1), (45, 2), (300, 10), (64, 32),
                                 (50, 24), (33, 128)])
@pytest.mark.parametrize("cached", [False, True])
def test_leapfrog_kernel_matches_plain(dev, w, d, cached):
    """q', p', u', g' to rtol=atol=1e-5: both sides round op by op in the
    same order (--fmad=false); only U's sum over dims differs in order."""
    rng = np.random.default_rng(w * 7 + d)
    for form in _d_forms(d, dev):
        q = _t(0.5 * rng.normal(size=(w, d)), dev)
        p = _t(rng.normal(size=(w, d)), dev)
        im = _t(rng.uniform(0.5, 2.0, d), dev)
        kw = dict(step_size=_t([0.05], dev), num_steps=12, inv_mass=im)
        if cached:
            u, g = kernels.device_value_and_grad(form)(q)
            kw.update(grad=g, potential_energy=u)
        before = kernels.leapfrog_trajectory.launches
        out_k = kernels.leapfrog_trajectory(form, q, p, **kw)
        assert kernels.leapfrog_trajectory.launches == before + 1
        out_p = kernels.leapfrog_trajectory_plain(form, q, p, **kw)
        torch.cuda.synchronize()
        for k, pl in zip(out_k, out_p):
            torch.testing.assert_close(k, pl, rtol=1e-5, atol=1e-5)


def test_run_hmc_pallas_leapfrog_on_cuda(dev):
    """The composed engine with kernel D: one launch per transition, the
    step size read on the device, moments of the standard normal."""
    q0 = torch.randn(4096, 6, generator=torch.Generator().manual_seed(0))
    kernels.reset_launch_counts()
    res = pt.run_hmc(3, pot.make_standard_normal(6), q0.to(dev),
                     num_warmup=100, num_samples=100, num_steps=8,
                     integrator="pallas_leapfrog", collect="moments")
    assert res.kernel_used == "composed"
    assert kernels.launch_counts()["leapfrog_trajectory"] == 200
    assert float(res.mean.abs().max()) < 0.05
    assert float((res.var - 1).abs().max()) < 0.08


def test_pallas_leapfrog_step_reads_the_step_size_on_the_device(dev):
    """A warmup transition of the composed engine with kernel D (step,
    dual averaging) issues no host-device copy or synchronisation once the
    form's parameters are on the device: the step size reaches the kernel
    as the tensor dual averaging holds."""
    from torch.profiler import ProfilerActivity, profile

    from physicsbasedbayesianinference_tpu_torch.adaptation import (
        da_init, da_update)

    kern = pt.build_hmc_kernel(pot.make_standard_normal(8), num_steps=4,
                               integrator="pallas_leapfrog")
    st = kern.init(torch.randn(256, 8, device=dev))
    da = da_init(torch.full((), 0.3, device=dev))
    st, _ = kern.step((1, 0), st, torch.exp(da.log_step))  # prepares
    torch.cuda.synchronize()
    before = kernels.leapfrog_trajectory.launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for t in range(1, 6):
            st, info = kern.step((1, t), st, torch.exp(da.log_step))
            da = da_update(da, torch.mean(info.accept_prob))
    calls = {e.key: e.count for e in prof.key_averages()}
    blocking = {k: n for k, n in calls.items()
                if k in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                         "cudaMemcpy", "cudaMemcpyAsync")}
    assert not blocking, blocking
    assert kernels.leapfrog_trajectory.launches == before + 5


def test_pallas_leapfrog_without_a_device_form_raises_on_cuda(dev):
    def plain(q):
        return 0.5 * torch.sum(q * q, dim=-1)

    q0 = torch.randn(64, 3, device=dev)
    with pytest.raises(ValueError, match="device_form"):
        pt.run_hmc(0, plain, q0, num_warmup=2, num_samples=2, num_steps=2,
                   integrator="pallas_leapfrog")


# ---------------------------------------------------------------------------
# Kernel E: all-pairs accelerations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 100, 129, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("softening", [0.0, 0.05])
def test_nbody_kernel_matches_plain(dev, n, dtype, softening):
    """Per body and component |a_kernel - a_plain| <= 4 u sqrt(N) S_i (the
    summation-order bound of tests/test_torch_nbody_kernel.py), with one
    body at the origin: no NaN at eps = 0."""
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.normal(size=(n, 3)), dtype=dtype, device=dev)
    x[n // 2] = 0.0
    m = torch.as_tensor(rng.uniform(0.5, 2.0, n), dtype=dtype, device=dev)
    before = kernels.nbody_accelerations_tiled.launches
    a_k = kernels.nbody_accelerations_tiled(x, m, g_const=1.5,
                                            softening=softening)
    assert kernels.nbody_accelerations_tiled.launches == before + 1
    a_p = kernels.nbody_accelerations_tiled_plain(x, m, g_const=1.5,
                                                  softening=softening)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(a_k).all())
    u = torch.finfo(dtype).eps / 2
    bound = 4.0 * u * n**0.5 * kernels.nbody_abs_sum(
        x, m, g_const=1.5, softening=softening)[:, None]
    assert bool(((a_k - a_p).abs() <= bound).all())


def test_nbody_kernel_rejects_bad_inputs(dev):
    x = torch.zeros(8, 3, device=dev)
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        kernels.nbody_accelerations_tiled(x[:, :2], x[:, 0], g_const=1.0,
                                          softening=0.0)
    with pytest.raises(ValueError, match="mass"):
        kernels.nbody_accelerations_tiled(x, x[:, 0].double(), g_const=1.0,
                                          softening=0.0)
    with pytest.raises(ValueError, match="float32 or float64"):
        kernels.nbody_accelerations_tiled(x.half(), x[:, 0].half(),
                                          g_const=1.0, softening=0.0)


def test_physics_simulate_runs_kernel_e(dev):
    """Velocity Verlet calls the accelerations twice per step: an unbatched
    [N, 3] CUDA state takes kernel E, and agrees with the plain route."""
    from physicsbasedbayesianinference_tpu_torch import physics
    sys_, _, dt = physics.load_nbody_text("examples/nbody/pl100.txt",
                                          device=dev)
    kernels.reset_launch_counts()
    traj = physics.simulate(sys_, dt, 20, save_every=10, softening=0.05)
    assert kernels.launch_counts()["nbody_accelerations_tiled"] == 40
    cpu = physics.simulate(physics.new_system(
        sys_.x.cpu(), sys_.v.cpu(), sys_.mass.cpu()), dt, 20, save_every=10,
        softening=0.05)
    torch.testing.assert_close(traj.x.cpu(), cpu.x, rtol=1e-10, atol=1e-12)
    assert float(physics.energy_drift(traj).max()) < 1e-6
