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
