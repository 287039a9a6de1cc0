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


@pytest.mark.parametrize("w,d", [(1, 1), (41, 3), (40, 4), (37, 5),
                                 (300, 32), (64, 33), (70, 128), (30, 129),
                                 (45, 200), (50, 257)])
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


def _diag_case(w, d, dev, seed=0):
    rng = np.random.default_rng(seed + 31 * d)
    im = _t(rng.uniform(0.5, 2.0, d), dev)
    return _t(rng.normal(size=(w, d)), dev), dict(
        scalars=_t([0.2, 1.0, 1.0], dev), p_std=torch.sqrt(1 / im),
        inv_mass=im, k_diag=_t(rng.uniform(0.5, 2.0, d), dev),
        mean=_t(rng.normal(size=d), dev), num_steps=8)


@pytest.mark.parametrize("d", [3, 32, 33, 128, 200])
def test_diag_kernel_all_rejected_and_all_accepted(dev, d):
    """A threshold under every energy error rejects every walker: q' is q
    bit for bit and g' = k (q - mu), from registers (D <= 128) or from the
    repair pass (D = 200). A zero step size accepts every walker
    (energy_error = 0 exactly) and leaves it where it was."""
    q, kw = _diag_case(90, d, dev)
    out = dict(zip(A_ORDER, kernels.fused_hmc_diag_quadratic(
        4, 2, q, divergence_threshold=-1e30, **kw)))
    torch.cuda.synchronize()
    assert not bool(out["accepted"].any())
    assert torch.equal(out["q"], q)
    assert torch.equal(out["g"], kw["k_diag"] * (q - kw["mean"]))
    assert bool((out["accept_prob"] == 0).all())
    plain = dict(zip(A_ORDER, kernels.fused_hmc_diag_quadratic_plain(
        4, 2, q, divergence_threshold=-1e30, **kw)))
    torch.testing.assert_close(out["u"], plain["u"], rtol=1e-5, atol=1e-5)

    kw["scalars"] = _t([0.0, 1.0, 1.0], dev)
    out = dict(zip(A_ORDER, kernels.fused_hmc_diag_quadratic(4, 2, q, **kw)))
    torch.cuda.synchronize()
    assert bool(out["accepted"].all())
    assert bool((out["energy_error"] == 0).all())
    assert torch.equal(out["q"], q)


@pytest.mark.parametrize("d", [4, 32, 128])
def test_diag_kernel_takes_a_q_that_is_not_16_byte_aligned(dev, d):
    """A contiguous view one float into its storage cannot be read in
    16-byte accesses: the launcher takes the scalar path, and the result
    is the aligned one's bit for bit."""
    q, kw = _diag_case(77, d, dev)
    storage = torch.zeros(q.numel() + 4, device=dev)
    storage[1:1 + q.numel()] = q.reshape(-1)
    shifted = storage[1:1 + q.numel()].view_as(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    assert q.data_ptr() % 16 == 0
    a = kernels.fused_hmc_diag_quadratic(8, 1, q, **kw)
    b = kernels.fused_hmc_diag_quadratic(8, 1, shifted, **kw)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert bool(storage[0] == 0) and bool((storage[-3:] == 0).all())


def test_constructors_land_on_the_card_unless_told_otherwise(dev):
    """Every family of constructors, called with no device on a machine
    with a card: the result is on the card; ``device="cpu"`` and a CPU
    tensor handed in stay on the CPU."""
    from physicsbasedbayesianinference_tpu_torch import adaptation, physics
    from physicsbasedbayesianinference_tpu_torch.utils import convert
    assert pt.default_device().type == "cuda"
    made = [pt.new_ensemble(4, 3).q,
            physics.new_system(np.zeros((2, 3)), np.zeros((2, 3)),
                               [1.0, 1.0]).x,
            physics.kepler_two_body()[0].mass,
            physics.solar_system()[0].x,
            pot.make_harmonic([1.0, 2.0]).diag_quadratic[0],
            pot.make_gaussian(np.zeros(2), cov=np.eye(2)).device_form[1][1],
            pot.make_banana().device_form[1][0],
            pot.make_funnel(4).device_form[1][0],
            pot.make_gaussian_mixture(np.zeros((2, 2))).device_form[1][1],
            pot.make_nbody_potential(np.ones(2), 2).device_form[1][0],
            adaptation.variance_init(3).mean,
            adaptation.covariance_init(3).m2,
            adaptation.da_init(0.1).log_step,
            convert.nbody_system_from_numpy(
                {"x": np.zeros((2, 3)), "v": np.zeros((2, 3)),
                 "mass": np.ones(2), "time": np.zeros(())}).x]
    assert all(t.device.type == "cuda" for t in made)
    assert pt.new_ensemble(4, 3, device="cpu").q.device.type == "cpu"
    assert pot.make_funnel(4, device="cpu").device_form[1][0].device.type \
        == "cpu"
    cpu = physics.new_system(torch.zeros(2, 3), torch.zeros(2, 3),
                             torch.ones(2))
    assert cpu.x.device.type == "cpu"


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


# the Gaussian form's walker tiles: D on and off the 16-byte path and the
# whole dim-groups, W with ragged lane groups (W % tile != 0) and blocks
GAUSS_DIMS = [2, 10, 31, 32, 33, 64, 127, 128]
GAUSS_WALKERS = [1, 5, 1000, 8193]


def _gaussian_case(w, d, dev):
    rng = np.random.default_rng(1000 * d + w)
    a = rng.normal(size=(d, d)) / np.sqrt(d)
    form = pot.make_gaussian(rng.normal(size=d),
                             cov=a @ a.T + 0.5 * np.eye(d),
                             device=dev).device_form
    q = _t(0.5 * rng.normal(size=(w, d)), dev)
    p = _t(rng.normal(size=(w, d)), dev)
    im = _t(rng.uniform(0.5, 2.0, d), dev)
    return form, q, p, im


def _shifted(x):
    """A contiguous copy of x one float into its storage: not 16-byte
    aligned, so the launcher must take the scalar accesses."""
    storage = torch.zeros(x.numel() + 4, device=x.device)
    storage[1:1 + x.numel()] = x.reshape(-1)
    view = storage[1:1 + x.numel()].view_as(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("tile", kernels.WALKER_TILES)
@pytest.mark.parametrize("d", GAUSS_DIMS)
@pytest.mark.parametrize("w", GAUSS_WALKERS)
def test_generic_kernel_gaussian_at_every_tile(dev, tile, d, w):
    """Kernel B with the Gaussian form at a forced walker tile: within
    ``_assert_match`` of the plain version (which rounds each multiply-add
    once, as the kernel's fmaf does), the same bits from a second launch,
    from tile 1 (the sums run in index order whatever the tile) and from a
    q and g that are not 16-byte aligned."""
    form, q, _, im = _gaussian_case(w, d, dev)
    u, g = kernels.device_value_and_grad(form)(q)
    kw = dict(scalars=_t([0.1, 1.0, 0.7], dev), p_std=torch.sqrt(1 / im),
              inv_mass=im, num_steps=12)
    before = kernels.fused_hmc_transition.launches
    out = kernels.fused_hmc_transition(form, 7, 3, q, u, g, tile=tile, **kw)
    assert kernels.fused_hmc_transition.launches == before + 1
    again = kernels.fused_hmc_transition(form, 7, 3, q, u, g, tile=tile,
                                         **kw)
    one = kernels.fused_hmc_transition(form, 7, 3, q, u, g, tile=1, **kw)
    off = kernels.fused_hmc_transition(form, 7, 3, _shifted(q), u,
                                       _shifted(g), tile=tile, **kw)
    plain = kernels.fused_hmc_transition_plain(form, 7, 3, q, u, g, **kw)
    torch.cuda.synchronize()
    _assert_match(dict(zip(B_ORDER, out)), dict(zip(B_ORDER, plain)), 7, 3)
    for other in (again, one, off):
        for x, y in zip(out, other):
            assert torch.equal(x, y)


@pytest.mark.parametrize("tile", kernels.WALKER_TILES)
@pytest.mark.parametrize("d", GAUSS_DIMS)
@pytest.mark.parametrize("w", GAUSS_WALKERS)
def test_leapfrog_kernel_gaussian_at_every_tile(dev, tile, d, w):
    """Kernel D with the Gaussian form at a forced walker tile, from the
    cached (u, g) and from none (one more gradient in the kernel): q', p',
    u', g' to rtol=atol=1e-5 of the plain version; the same bits from a
    second launch, from tile 1 and from misaligned q, p, g."""
    form, q, p, im = _gaussian_case(w, d, dev)
    u, g = kernels.device_value_and_grad(form)(q)
    for cached in (False, True):
        kw = dict(step_size=_t([0.05], dev), num_steps=12, inv_mass=im)
        off_kw = dict(kw)
        if cached:
            kw.update(grad=g, potential_energy=u)
            off_kw.update(grad=_shifted(g), potential_energy=u)
        out = kernels.leapfrog_trajectory(form, q, p, tile=tile, **kw)
        again = kernels.leapfrog_trajectory(form, q, p, tile=tile, **kw)
        one = kernels.leapfrog_trajectory(form, q, p, tile=1, **kw)
        off = kernels.leapfrog_trajectory(form, _shifted(q), _shifted(p),
                                          tile=tile, **off_kw)
        plain = kernels.leapfrog_trajectory_plain(form, q, p, **kw)
        torch.cuda.synchronize()
        for k, pl in zip(out, plain):
            torch.testing.assert_close(k, pl, rtol=1e-5, atol=1e-5)
        for other in (again, one, off):
            for x, y in zip(out, other):
                assert torch.equal(x, y)


@pytest.mark.parametrize("tile", kernels.WALKER_TILES)
@pytest.mark.parametrize("d", [2, 32, 33, 128])
def test_gaussian_kernels_with_no_steps_return_the_cached_values(dev, tile,
                                                                 d):
    """num_steps = 0: kernel B returns q, u, g bit for bit, accepted or
    not; kernel D returns q, p and the cached (u, g), or the form's own
    (u, g) at q without them."""
    form, q, p, im = _gaussian_case(37, d, dev)
    u, g = kernels.device_value_and_grad(form)(q)
    out = dict(zip(B_ORDER, kernels.fused_hmc_transition(
        form, 2, 9, q, u, g, scalars=_t([0.1, 1.0, 1.0], dev),
        p_std=torch.sqrt(1 / im), inv_mass=im, num_steps=0, tile=tile)))
    kw = dict(step_size=_t([0.05], dev), num_steps=0, inv_mass=im, tile=tile)
    cached = kernels.leapfrog_trajectory(form, q, p, grad=g,
                                         potential_energy=u, **kw)
    fresh = kernels.leapfrog_trajectory(form, q, p, **kw)
    torch.cuda.synchronize()
    assert bool((out["energy_error"].abs() < 1e-4).all())
    for key, want in (("q", q), ("u", u), ("g", g)):
        assert torch.equal(out[key], want)
    for got, want in zip(cached, (q, p, u, g)):
        assert torch.equal(got, want)
    assert torch.equal(fresh[0], q) and torch.equal(fresh[1], p)
    torch.testing.assert_close(fresh[2], u, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fresh[3], g, rtol=1e-5, atol=1e-5)


def test_walker_tile_is_for_the_gaussian_form_only(dev):
    """Only the tiled forms (the Gaussian and, since its register tile,
    the logistic regression) take a walker tile above 1."""
    q, u = torch.zeros(8, 4, device=dev), torch.zeros(8, device=dev)
    kw = dict(scalars=_t([0.1, 1.0, 1.0], dev),
              p_std=torch.ones(4, device=dev),
              inv_mass=torch.ones(4, device=dev), num_steps=2)
    funnel = pot.make_funnel(4, device=dev).device_form
    with pytest.raises(ValueError, match="only the gaussian form"):
        kernels.fused_hmc_transition(funnel, 0, 0, q, u, q, tile=2,
                                     **kw)
    logistic = _logistic_form(16, 4, dev)
    lu, lg = kernels.device_value_and_grad(logistic)(q)
    kernels.fused_hmc_transition(logistic, 0, 0, q, lu, lg, tile=2, **kw)
    with pytest.raises(ValueError, match="tile must be one of"):
        kernels.fused_hmc_transition(logistic, 0, 0, q, lu, lg, tile=3,
                                     **kw)
    gauss = pot.make_gaussian(np.zeros(4), precision=np.eye(4),
                              device=dev).device_form
    with pytest.raises(ValueError, match="tile must be one of"):
        kernels.fused_hmc_transition(gauss, 0, 0, q, u, q, tile=3,
                                     **kw)
    with pytest.raises(ValueError, match="tile must be one of"):
        kernels.leapfrog_trajectory(gauss, q, q, step_size=_t([0.1], dev),
                                    num_steps=2,
                                    inv_mass=torch.ones(4, device=dev),
                                    tile=8)


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


def test_a_numpy_init_q_runs_fused_on_the_card(dev):
    """A numpy ``init_q`` goes to the default device, the card: the run
    takes the fused engine, as for a tensor already there."""
    q0 = np.random.default_rng(0).normal(size=(1024, 4)).astype(np.float32)
    kernels.reset_launch_counts()
    res = pt.run_hmc(3, pot.make_standard_normal(4), q0, num_warmup=10,
                     num_samples=10, num_steps=4, collect="moments")
    assert (res.kernel_used, res.kernel_variant) == ("fused", "diag")
    assert res.state.ensemble.q.device.type == "cuda"
    assert kernels.launch_counts()["fused_hmc_diag_quadratic"] == 20


def test_cli_runs_on_the_card(dev, tmp_path):
    """The command-line driver's default device is the card: hmc in
    kernel A, a checkpointed resume bitwise the uninterrupted run."""
    from physicsbasedbayesianinference_tpu_torch import main
    base = dict(model="builtin:std_normal_32d", num_walkers=2048,
                num_warmup=20, num_steps=4, checkpoint_every=8)
    kernels.reset_launch_counts()
    s = main.run(pt.RunConfig(num_samples=16, collect="moments", **{
        k: v for k, v in base.items() if k != "checkpoint_every"}))
    assert (s["kernel_used"], s["kernel_variant"]) == ("fused", "diag")
    assert kernels.launch_counts()["fused_hmc_diag_quadratic"] == 36
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    main.run(pt.RunConfig(num_samples=8, checkpoint_dir=a, **base))
    s2 = main.run(pt.RunConfig(num_samples=16, checkpoint_dir=a, **base))
    s3 = main.run(pt.RunConfig(num_samples=16, checkpoint_dir=b, **base))
    assert s2["resumed_from"] == 8
    assert s2["posterior_mean"] == s3["posterior_mean"] == s["posterior_mean"]


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


@pytest.mark.parametrize("n", [1, 2, 31, 100, 127, 128, 129, 1000, 4097])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("softening", [0.0, 0.05])
def test_nbody_kernel_matches_plain(dev, n, dtype, softening):
    """Per body and component |a_kernel - a_plain| <= (4 sqrt(N) + 8) u S_i
    (``kernels.nbody_bound``), with one body at the origin: no NaN at
    eps = 0. A second launch gives the same bits."""
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.normal(size=(n, 3)), dtype=dtype, device=dev)
    x[n // 2] = 0.0
    m = torch.as_tensor(rng.uniform(0.5, 2.0, n), dtype=dtype, device=dev)
    before = kernels.nbody_accelerations_tiled.launches
    a_k = kernels.nbody_accelerations_tiled(x, m, g_const=1.5,
                                            softening=softening)
    assert kernels.nbody_accelerations_tiled.launches == before + 1
    again = kernels.nbody_accelerations_tiled(x, m, g_const=1.5,
                                              softening=softening)
    a_p = kernels.nbody_accelerations_tiled_plain(x, m, g_const=1.5,
                                                  softening=softening)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(a_k).all())
    assert torch.equal(a_k, again)
    bound = kernels.nbody_bound(x, m, g_const=1.5,
                                softening=softening)[:, None]
    assert bool(((a_k - a_p).abs() <= bound).all())


@pytest.mark.parametrize("split", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nbody_kernel_at_every_split(dev, split, dtype):
    """Every split the chooser can return, forced: within the bound of the
    plain version in the same split order (the same sums in the same
    order, terms rounded differently) and of the unsplit one."""
    n = 1000
    rng = np.random.default_rng(split)
    x = torch.as_tensor(rng.normal(size=(n, 3)), dtype=dtype, device=dev)
    m = torch.as_tensor(rng.uniform(0.5, 2.0, n), dtype=dtype, device=dev)
    kw = dict(g_const=1.0, softening=0.0)
    a_k = kernels.nbody_accelerations_tiled(x, m, split=split, **kw)
    assert torch.equal(a_k, kernels.nbody_accelerations_tiled(
        x, m, split=split, **kw))
    bound = kernels.nbody_bound(x, m, **kw)[:, None]
    for ref in (kernels.nbody_accelerations_tiled_plain(x, m, **kw),
                kernels.nbody_accelerations_tiled_plain(x, m, split=split,
                                                        **kw)):
        assert bool(((a_k - ref).abs() <= bound).all())
    with pytest.raises(ValueError, match="power of two"):
        kernels.nbody_accelerations_tiled(x, m, split=3, **kw)


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


# ---------------------------------------------------------------------------
# The device step count, the proposal outputs, the model forms, ChEES
# ---------------------------------------------------------------------------


def _count(n, dev):
    return torch.tensor([n], dtype=torch.int32, device=dev)


def _logistic_form(n, d, dev):
    from physicsbasedbayesianinference_tpu_torch import models
    x, y = models.logistic_regression_data(n, d - 1, seeds=(n, d, 9))
    return ("logistic", (_t(x, dev), _t(y, dev)))


def _schools_form(j, dev, name="eight_schools_nc"):
    rng = np.random.default_rng(j)
    return (name, (_t(10.0 * rng.normal(size=j), dev),
                                 _t(rng.uniform(5.0, 20.0, j), dev),
                                 _t([3.0 * j], dev)))


def _b_case(form, w, d, dev, spread=0.5, step=0.1):
    rng = np.random.default_rng(w + 7 * d)
    q = _t(spread * rng.normal(size=(w, d)), dev)
    u, g = kernels.device_value_and_grad(form)(q)
    im = _t(rng.uniform(0.5, 2.0, d), dev)
    return q, u, g, dict(scalars=_t([step, 1.0, 1.0], dev),
                         p_std=torch.sqrt(1 / im), inv_mass=im)


@pytest.mark.parametrize("n", [1, 7, 16, 40])
@pytest.mark.parametrize("case", ["gaussian tile 4", "gaussian D=33",
                                  "funnel", "diag", "logistic", "schools"])
def test_counted_kernel_b_with_proposal_matches_plain(dev, case, n):
    """Kernel B with the count read on the device (1, 7, max_steps and one
    above it, which clips) and the proposal outputs, against its plain
    version; the first six outputs are the fixed-count kernel's bits, and a
    second launch gives the same bits."""
    w, d = 777, 32
    if case == "gaussian tile 4":
        form, tile = _forms(d, dev)[0], 4
    elif case == "gaussian D=33":
        w, d = 203, 33
        form, tile = _forms(d, dev)[0], 2
    elif case == "funnel":
        w, d = 301, 10
        form, tile = pot.make_funnel(d, device=dev).device_form, None
    elif case == "diag":
        w, d = 130, 7
        form, tile = ("diag", (_t(np.linspace(0.5, 2, d), dev),
                               _t(np.zeros(d), dev))), None
    elif case == "logistic":
        w, d = 95, 12
        form, tile = _logistic_form(40, d, dev), None
    else:
        w, d = 1001, 10
        form, tile = _schools_form(8, dev), None
    q, u, g, kw = _b_case(form, w, d, dev)
    max_steps = 16
    extra = dict(num_steps=_count(n, dev), max_steps=max_steps,
                 emit_proposal=True)
    out = kernels.fused_hmc_transition(form, 7, 3, q, u, g, tile=tile, **kw,
                                       **extra)
    again = kernels.fused_hmc_transition(form, 7, 3, q, u, g, tile=tile,
                                         **kw, **extra)
    fixed = kernels.fused_hmc_transition(form, 7, 3, q, u, g, tile=tile,
                                         num_steps=min(n, max_steps), **kw)
    plain = kernels.fused_hmc_transition_plain(form, 7, 3, q, u, g, **kw,
                                               **extra)
    torch.cuda.synchronize()
    assert len(out) == 8 and len(fixed) == 6
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    for a, b in zip(out, fixed):
        assert torch.equal(a, b)
    _assert_match(dict(zip(B_ORDER, out)), dict(zip(B_ORDER, plain)), 7, 3)
    torch.testing.assert_close(out[6], plain[6], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out[7], plain[7], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [3, 32, 33, 200])
def test_counted_kernel_a_gives_the_fixed_counts_bits(dev, d):
    q, kw = _diag_case(77, d, dev)
    kw.pop("num_steps", None)
    for n, want in ((1, 1), (7, 7), (16, 16), (99, 16), (0, 1)):
        a = kernels.fused_hmc_diag_quadratic(
            3, 5, q, num_steps=_count(n, dev), max_steps=16, **kw)
        b = kernels.fused_hmc_diag_quadratic(3, 5, q, num_steps=want, **kw)
        p = kernels.fused_hmc_diag_quadratic_plain(
            3, 5, q, num_steps=_count(n, dev), max_steps=16, **kw)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        _assert_match(dict(zip(A_ORDER, a)), dict(zip(A_ORDER, p)), 3, 5)
    with pytest.raises(ValueError, match="one int32"):
        kernels.fused_hmc_diag_quadratic(
            3, 5, q, num_steps=torch.tensor([4]), max_steps=16, **kw)


def _same_bits(got, want, where=None):
    if where is not None:
        got, want = got[where], want[where]
    assert torch.equal(got, want), (got - want).abs().max()


@pytest.mark.parametrize("n", [1, 7, 40, 256, 257])
@pytest.mark.parametrize("d", list(range(1, 34)))
def test_logistic_form_matches_plain(dev, d, n):
    """Kernels B and D with the logistic form at every walker tile the
    chooser can return (1, 2, 4, forced), every D up to 33 (P = 0 to 32
    features; 1 to 16 lanes a walker, on and off the 16-byte path), N = 1,
    7, 40, 256 and 257 rows (257: one past a whole number of row chunks), W
    no multiple of the block; kernel B in its four variants (the count
    fixed or on the device, with or without the proposal outputs). Kernel
    and plain version sum in the same order and round each multiply-add
    once, so D's q', p', u', g', B's proposal and B's q', u', g' (where the
    decisions agree) are the plain version's bits; B's energy error sums
    the kinetic energy in another order (``_assert_match``). A second
    launch and every other tile give the same bits."""
    form = _logistic_form(n, d, dev)
    w = 75
    q, u, g, kw = _b_case(form, w, d, dev, spread=0.3, step=0.03)
    plain = {}
    for counted in (False, True):
        for prop in (False, True):
            extra = dict(emit_proposal=prop)
            extra.update(dict(num_steps=_count(6, dev), max_steps=8)
                         if counted else dict(num_steps=6))
            plain[counted, prop] = kernels.fused_hmc_transition_plain(
                form, 7, 3, q, u, g, **kw, **extra)
            first = None
            for tile in kernels.WALKER_TILES:
                out = kernels.fused_hmc_transition(form, 7, 3, q, u, g,
                                                   tile=tile, **kw, **extra)
                again = kernels.fused_hmc_transition(
                    form, 7, 3, q, u, g, tile=tile, **kw, **extra)
                torch.cuda.synchronize()
                for a, b in zip(out, again):
                    _same_bits(a, b)
                if first is None:
                    first = out
                    ref = dict(zip(B_ORDER, plain[counted, prop]))
                    got = dict(zip(B_ORDER, out))
                    _assert_match(got, ref, 7, 3)
                    agree = got["accepted"] == ref["accepted"]
                    for key in ("q", "u", "g"):
                        _same_bits(got[key], ref[key], agree)
                    for a, b in zip(out[6:], plain[counted, prop][6:]):
                        _same_bits(a, b)
                else:
                    for a, b in zip(out, first):
                        _same_bits(a, b)
    p = _t(np.random.default_rng(d).normal(size=(w, d)), dev)
    for cached in (False, True):
        lk = dict(step_size=_t([0.03], dev), num_steps=5,
                  inv_mass=kw["inv_mass"])
        if cached:
            lk.update(grad=g, potential_energy=u)
        want = kernels.leapfrog_trajectory_plain(form, q, p, **lk)
        for tile in kernels.WALKER_TILES:
            out = kernels.leapfrog_trajectory(form, q, p, tile=tile, **lk)
            again = kernels.leapfrog_trajectory(form, q, p, tile=tile, **lk)
            torch.cuda.synchronize()
            for a, b, c in zip(out, again, want):
                _same_bits(a, b)
                _same_bits(a, c)


def test_logistic_tile_chooser_on_cuda(dev):
    """Without a forced tile the wrappers take ``kernels.logistic_tile``:
    at W = 8192 and D = 32, tile 2, the same bits as tile 2 forced; a tile
    whose block would not fit in shared memory is refused before any
    launch."""
    form = _logistic_form(256, 32, dev)
    assert kernels.logistic_tile(8192, 256, 32) == 2
    q, u, g, kw = _b_case(form, 8192, 32, dev, spread=0.3, step=0.03)
    auto = kernels.fused_hmc_transition(form, 7, 3, q, u, g, num_steps=4,
                                        **kw)
    two = kernels.fused_hmc_transition(form, 7, 3, q, u, g, num_steps=4,
                                       tile=2, **kw)
    torch.cuda.synchronize()
    for a, b in zip(auto, two):
        _same_bits(a, b)
    # 768 rows at D = 33 (16 lanes a walker) fit at tile 2, not at 4
    big = _logistic_form(768, 33, dev)
    assert kernels.generic_unsupported(big, 33) is None
    assert kernels.logistic_tile(102400, 768, 33) == 2
    qb, ub, gb, kwb = _b_case(big, 64, 33, dev, spread=0.3, step=0.03)
    before = kernels.fused_hmc_transition.launches
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fused_hmc_transition(big, 7, 3, qb, ub, gb, num_steps=2,
                                     tile=4, **kwb)
    assert kernels.fused_hmc_transition.launches == before


def _check_thread_layout(dev, form, w, d, spread=0.5, bits=False):
    """Kernel B in its four variants (the count fixed or on the device,
    with or without the proposal) against the plain version
    (``_assert_match``; the proposal to 1e-5), kernel D with and without the
    cached pair to 1e-5; a second launch gives the same bits, and so does
    the lane-group layout forced where the thread layout runs (the forms'
    arithmetic is the same in both). ``bits``: B's q', u', g' where the
    decisions agree and its proposal, and all of D's outputs, are the plain
    version's bits. Forcing the thread layout past the chooser raises."""
    layout_b = kernels.form_layout(form, d, "B")
    layout_d = kernels.form_layout(form, d, "D")
    layouts = (None, "group") if layout_b == "thread" else (None,)
    d_layouts = (None, "group") if layout_d == "thread" else (None,)
    q, u, g, kw = _b_case(form, w, d, dev, spread=spread)
    for counted in (False, True):
        for prop in (False, True):
            extra = dict(emit_proposal=prop)
            extra.update(dict(num_steps=_count(8, dev), max_steps=8)
                         if counted else dict(num_steps=8))
            want = kernels.fused_hmc_transition_plain(form, 7, 3, q, u, g,
                                                      **kw, **extra)
            first = None
            for layout in layouts:
                before = dict(kernels.fused_hmc_transition.launches_by_layout)
                out = kernels.fused_hmc_transition(
                    form, 7, 3, q, u, g, _layout=layout, **kw, **extra)
                again = kernels.fused_hmc_transition(
                    form, 7, 3, q, u, g, _layout=layout, **kw, **extra)
                torch.cuda.synchronize()
                ran = layout or layout_b
                assert kernels.fused_hmc_transition.launches_by_layout[
                    ran] == before[ran] + 2
                for a, b in zip(out, again):
                    _same_bits(a, b)
                if first is None:
                    first = out
                    _assert_match(dict(zip(B_ORDER, out)),
                                  dict(zip(B_ORDER, want)), 7, 3)
                    for a, b in zip(out[6:], want[6:]):
                        torch.testing.assert_close(a, b, rtol=1e-5,
                                                   atol=1e-5)
                    if bits:
                        agree = out[4] == want[4]
                        for a, b in zip(out[:3], want[:3]):
                            _same_bits(a, b, agree)
                        for a, b in zip(out[6:], want[6:]):
                            _same_bits(a, b)
                else:
                    for a, b in zip(out, first):
                        _same_bits(a, b)
    p = _t(np.random.default_rng(d).normal(size=(w, d)), dev)
    for cached in (False, True):
        lk = dict(step_size=_t([0.1], dev), num_steps=8,
                  inv_mass=kw["inv_mass"])
        if cached:
            lk.update(grad=g, potential_energy=u)
        want = kernels.leapfrog_trajectory_plain(form, q, p, **lk)
        first = None
        for layout in d_layouts:
            before = dict(kernels.leapfrog_trajectory.launches_by_layout)
            out = kernels.leapfrog_trajectory(form, q, p, _layout=layout,
                                              **lk)
            again = kernels.leapfrog_trajectory(form, q, p, _layout=layout,
                                                **lk)
            torch.cuda.synchronize()
            ran = layout or layout_d
            assert kernels.leapfrog_trajectory.launches_by_layout[
                ran] == before[ran] + 2
            for a, b in zip(out, again):
                _same_bits(a, b)
            if first is None:
                first = out
                for a, b in zip(out, want):
                    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
                    if bits:
                        _same_bits(a, b)
            else:
                for a, b in zip(out, first):
                    _same_bits(a, b)
    if layout_b == "group":
        with pytest.raises(ValueError, match="no thread layout"):
            kernels.fused_hmc_transition(form, 7, 3, q, u, g, num_steps=2,
                                         _layout="thread", **kw)
    if layout_d == "group":
        with pytest.raises(ValueError, match="no thread layout"):
            kernels.leapfrog_trajectory(form, q, p, _layout="thread", **lk)
    return q, u, kw


@pytest.mark.parametrize("w,j", [(1, 1), (37, 3), (1001, 8), (64, 30),
                                 (129, 14), (75, 15), (257, 6), (97, 10),
                                 (65, 11)])
@pytest.mark.parametrize("name", ["eight_schools_nc", "eight_schools"])
def test_eight_schools_form_matches_plain(dev, w, j, name):
    """Both eight-schools forms in kernels B and D at J on both sides of
    the thread layout's limits (D = 16; D = 12 for the centred form in
    kernel D) and W no multiple of its block (``_check_thread_layout``)."""
    form = _schools_form(j, dev, name)
    d = j + 2
    assert kernels.walker_layout(name, d, "B") == ("thread" if d <= 16
                                                   else "group")
    d_limit = 16 if name == "eight_schools_nc" else 12
    assert kernels.walker_layout(name, d, "D") == ("thread" if d <= d_limit
                                                   else "group")
    q, u, kw = _check_thread_layout(dev, form, w, d)
    with pytest.raises(ValueError, match="takes D="):
        kernels.fused_hmc_transition(form, 7, 3, torch.zeros(4, d + 1,
                                                             device=dev),
                                     u[:4], torch.zeros(4, d + 1, device=dev),
                                     num_steps=2, **kw)


def _funnel_form(name, d, dev):
    if name == "funnel":
        return pot.make_funnel(d, device=dev).device_form
    return ("funnel_model", (_t([18.0, 0.5 * (d - 1)], dev),
                             _t([0.25 * d], dev)))


def _nbody_form(n, s, eps, dev):
    rng = np.random.default_rng(10 * n + s)
    return pot.make_nbody_potential(rng.uniform(0.5, 1.5, n), n, s,
                                    softening=eps, device=dev).device_form


@pytest.mark.parametrize("w,d", [(1, 2), (1000, 10), (129, 16), (37, 17),
                                 (257, 5), (64, 12), (100, 13)])
@pytest.mark.parametrize("name", ["funnel", "funnel_model"])
def test_funnel_forms_match_plain_in_both_layouts(dev, w, d, name):
    """The two funnel forms in kernels B and D at D on both sides of the
    thread layout's limit (16) and W off its block of 128
    (``_check_thread_layout``)."""
    form = _funnel_form(name, d, dev)
    for kernel in ("B", "D"):
        assert kernels.walker_layout(name, d, kernel) == (
            "thread" if d <= 16 else "group")
    _check_thread_layout(dev, form, w, d)


@pytest.mark.parametrize("w,n,s", [(1000, 8, 3), (129, 9, 3), (37, 2, 3),
                                   (257, 12, 2), (64, 13, 2), (100, 5, 2),
                                   (75, 7, 3), (1, 1, 3), (50, 2, 4),
                                   (33, 20, 1)])
@pytest.mark.parametrize("eps", [0.0, 0.3])
def test_nbody_form_matches_plain_bitwise_in_both_layouts(dev, w, n, s, eps):
    """The N-body form in kernels B and D at D = n s on both sides of the
    thread layout's limit (24) and in 1, 2, 3 and 4 space dims (the thread
    layout takes 2 and 3), with and without softening: both layouts and
    the plain version take every pair's inverse distance with the same
    operations and sum each body's partners in the same order, so B's q',
    u', g' and proposal and all of D's outputs are the plain version's bits
    (``_check_thread_layout`` with ``bits``)."""
    form = _nbody_form(n, s, eps, dev)
    d = n * s
    for kernel in ("B", "D"):
        assert kernels.form_layout(form, d, kernel) == (
            "thread" if d <= 24 and s in (2, 3) else "group")
    _check_thread_layout(dev, form, w, d, spread=2.0, bits=True)


def _mixture_form(k, d, dev):
    rng = np.random.default_rng(10 * k + d)
    return pot.make_gaussian_mixture(2.0 * rng.normal(size=(k, d)), 1.2,
                                     rng.normal(size=k),
                                     device=dev).device_form


def _coin_form(d, dev):
    rng = np.random.default_rng(d)
    return ("coin", (_t(rng.uniform(1.0, 50.0, d), dev),
                     _t(rng.uniform(1.0, 50.0, d), dev)))


@pytest.mark.parametrize("w,k,d", [(1, 2, 2), (1000, 2, 2), (300, 1, 3),
                                   (257, 3, 5), (129, 2, 16), (100, 1, 12),
                                   (75, 2, 9), (37, 2, 17), (64, 8, 3)])
def test_mixture_form_matches_plain_bitwise_in_both_layouts(dev, w, k, d):
    """The mixture in kernels B and D at D and K on both sides of the
    thread layout's limits (D = 16, 2 components; K padded to 2 there)
    and W off its block of 128: both layouts and the plain version
    take every term, max, exponential, sum and division in the same
    order, so B's q', u', g' and proposal and all of D's outputs are the
    plain version's bits, and the lane groups forced give the thread
    layout's (``_check_thread_layout`` with ``bits``)."""
    form = _mixture_form(k, d, dev)
    for kernel in ("B", "D"):
        assert kernels.form_layout(form, d, kernel) == (
            "thread" if d <= 16 and k <= 2 else "group")
    _check_thread_layout(dev, form, w, d, spread=2.0, bits=True)


@pytest.mark.parametrize("w,d", [(1, 1), (1000, 2), (300, 7), (129, 16),
                                 (64, 12), (37, 17)])
def test_coin_form_matches_plain_bitwise(dev, w, d):
    """The coin form in kernels B and D, in the lane groups at every D:
    one exponential and one division a dim in the kernels and the plain
    version, so B's q', u', g' and proposal and D's outputs are the plain
    version's bits, and a forced thread layout raises
    (``_check_thread_layout`` with ``bits``)."""
    form = _coin_form(d, dev)
    for kernel in ("B", "D"):
        assert kernels.form_layout(form, d, kernel) == "group"
    _check_thread_layout(dev, form, w, d, spread=2.0, bits=True)


def test_coin_form_is_finite_in_the_tails_on_the_card(dev):
    """|x| up to 100 with the example's counts and with a = b = 1: kernel
    D's gradient and value (with no step it evaluates them at q) are finite
    and the plain version's bits."""
    x = torch.tensor([100.0, -100.0, 60.0, -60.0, 17.0, -17.0, 0.5, 0.0])
    q = torch.stack(torch.meshgrid(x, x, indexing="ij"), -1).reshape(
        -1, 2).to(dev)
    for a, b in (([76.0, 33.0], [26.0, 69.0]), ([1.0, 1.0], [1.0, 1.0])):
        form = ("coin", (_t(a, dev), _t(b, dev)))
        lk = dict(step_size=_t([0.1], dev), num_steps=0,
                  inv_mass=torch.ones(2, device=dev))
        out = kernels.leapfrog_trajectory(form, q, q, **lk)
        want = kernels.leapfrog_trajectory_plain(form, q, q, **lk)
        torch.cuda.synchronize()
        for got, ref in zip(out[2:], want[2:]):
            assert bool(torch.isfinite(got).all())
            _same_bits(got, ref)


@pytest.mark.parametrize("k,d", [(2, 2), (1, 7)])
@pytest.mark.parametrize("variant", ["fixed", "counted+proposal"])
def test_mixture_rung_launch_in_the_thread_layout_is_the_lane_groups(
        dev, k, d, variant):
    """Kernel B on q [3, 300, D] of the mixture, one launch in the thread
    layout: every output the lane groups' (forced) bits, and q', u', g'
    where the decisions agree and the proposal the plain version's bits;
    each rung within ``_assert_match``."""
    form = _mixture_form(k, d, dev)
    assert kernels.form_layout(form, d, "B") == "thread"
    q, seeds, kw = _rung_case(dev, d)
    vg = kernels.device_value_and_grad(form)
    u, g = (torch.stack(x) for x in zip(*(vg(x) for x in q)))
    if variant == "fixed":
        kw.update(num_steps=10)
    else:
        kw.update(num_steps=_count(10, dev), max_steps=16,
                  emit_proposal=True)
    before = dict(kernels.fused_hmc_transition.launches_by_layout)
    got = kernels.fused_hmc_transition(form, seeds, 3, q, u, g, **kw)
    group = kernels.fused_hmc_transition(form, seeds, 3, q, u, g,
                                         _layout="group", **kw)
    plain = kernels.fused_hmc_transition_plain(form, seeds, 3, q, u, g, **kw)
    torch.cuda.synchronize()
    after = kernels.fused_hmc_transition.launches_by_layout
    assert (after["thread"], after["group"]) == (before["thread"] + 1,
                                                 before["group"] + 1)
    for a, b in zip(got, group, strict=True):
        _same_bits(a, b)
    agree = got[4] == plain[4]
    for a, b in zip(got[:3], plain[:3]):
        _same_bits(a, b, agree)
    for a, b in zip(got[6:], plain[6:]):
        _same_bits(a, b)
    for r, key in enumerate(seeds):
        _assert_match({k: v[r] for k, v in zip(B_ORDER, got)},
                      {k: v[r] for k, v in zip(B_ORDER, plain)}, key, 3)


@pytest.mark.parametrize("name", ["eight_schools_nc", "eight_schools",
                                  "funnel", "funnel_model", "nbody",
                                  "mixture"])
def test_thread_layout_offset_halves_join_to_the_whole_launch(dev, name):
    """Kernel B in the thread layout on two blocks of walkers at their
    global offsets gives the whole launch's bits, in each variant."""
    if name == "nbody":
        form, d = _nbody_form(8, 3, 0.3, dev), 24
    elif name == "mixture":
        form, d = _mixture_form(1, 5, dev), 5
    elif name.startswith("funnel"):
        form, d = _funnel_form(name, 16, dev), 16
    else:
        form, d = _schools_form(8, dev, name), 10
    assert kernels.form_layout(form, d, "B") == "thread"
    w = 1001
    q, u, g, kw = _b_case(form, w, d, dev)
    rows = (slice(0, w // 3), slice(w // 3, w))
    for extra in (dict(num_steps=8),
                  dict(num_steps=_count(8, dev), max_steps=8,
                       emit_proposal=True)):
        whole = kernels.fused_hmc_transition(form, 5, 2, q, u, g, **kw,
                                             **extra)
        parts = [kernels.fused_hmc_transition(
            form, 5, 2, q[r].contiguous(), u[r].contiguous(),
            g[r].contiguous(), walker_offset=r.start, **kw, **extra)
            for r in rows]
        torch.cuda.synchronize()
        for a, b0, b1 in zip(whole, *parts):
            _same_bits(a, torch.cat([b0, b1]))


def _models_on(dev):
    from physicsbasedbayesianinference_tpu_torch import models
    x, y = models.logistic_regression_data(64, 7)
    return {
        "logistic": models.make_model_potential(
            models.logistic_regression, (x, y), {}, device=dev),
        "schools": models.make_model_potential(
            models.eight_schools_noncentered, (), models.EIGHT_SCHOOLS_DATA,
            device=dev)}


@pytest.mark.parametrize("name", ["logistic", "schools"])
def test_run_chees_on_a_model_runs_both_phases_in_kernel_b(dev, name):
    mp = _models_on(dev)[name]
    assert mp.potential.device_form[1][0].device.type == "cuda"
    q0 = 0.3 * torch.randn(4096, mp.num_dims, device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
    kw = dict(num_warmup=100, num_samples=60, max_steps=64,
              init_step_size=0.1, collect="moments")
    kernels.reset_launch_counts()
    res = pt.run_chees_hmc(4, mp.potential, q0, **kw)
    assert (res.kernel_used, res.warmup_kernel_used) == ("fused", "fused")
    assert kernels.launch_counts() == {
        "fused_hmc_diag_quadratic": 0, "fused_hmc_transition": 160,
        "leapfrog_trajectory": 0, "nbody_accelerations_tiled": 0}
    assert kernels.fused_hmc_transition.launches_by == {
        "fixed": 0, "fixed+proposal": 0, "counted": 60,
        "counted+proposal": 100}
    assert 0.6 < float(res.accept_rate) < 0.99
    assert float(res.divergence_rate) < 0.01
    # the composed engine samples the same posterior (autograd through the
    # DSL, its own random stream): 4096 walkers x 60 draws each
    ref = pt.run_chees_hmc(4, mp.potential, q0, kernel="composed", **kw)
    assert ref.kernel_used == "composed"
    sd = torch.sqrt(ref.var)
    assert float(((res.mean - ref.mean) / sd).abs().max()) < 0.1
    assert float((res.var / ref.var - 1).abs().max()) < 0.15


def test_chees_routes_on_cuda(dev):
    """auto keeps a diag-quadratic target's warmup composed and samples it
    in kernel A; fused forces warmup through kernel B's diagonal form; a
    model without a form runs composed, one host read a transition."""
    from physicsbasedbayesianinference_tpu_torch import chees, models
    q0 = torch.randn(2048, 6, device=dev)
    kw = dict(num_warmup=40, num_samples=30, max_steps=32, collect="moments")
    kernels.reset_launch_counts()
    res = pt.run_chees_hmc(1, pot.make_standard_normal(6), q0, **kw)
    assert (res.kernel_used, res.warmup_kernel_used) == ("fused", "composed")
    assert kernels.launch_counts()["fused_hmc_diag_quadratic"] == 30
    assert kernels.launch_counts()["fused_hmc_transition"] == 0
    kernels.reset_launch_counts()
    res = pt.run_chees_hmc(1, pot.make_standard_normal(6), q0,
                           kernel="fused", **kw)
    assert (res.kernel_used, res.warmup_kernel_used) == ("fused", "fused")
    assert kernels.launch_counts()["fused_hmc_diag_quadratic"] == 30
    assert kernels.fused_hmc_transition.launches_by[
        "counted+proposal"] == 40
    assert float((res.var - 1).abs().max()) < 0.1
    # a site dict, not "auto": the same decentred funnel without a form
    mp = models.make_model_potential(models.funnel, (), {"dim": 3},
                                     reparam={"x": True}, device=dev)
    assert mp.potential.device_form is None
    kernels.reset_launch_counts()
    before = chees._host_count.reads
    res = pt.run_chees_hmc(1, mp.potential, mp.init(0, 512), **kw)
    assert (res.kernel_used, res.warmup_kernel_used) == ("composed",
                                                         "composed")
    assert chees._host_count.reads - before == 70
    assert sum(kernels.launch_counts().values()) == 0
    with pytest.raises(ValueError, match="cannot run"):
        pt.run_chees_hmc(1, mp.potential, mp.init(0, 64), kernel="fused",
                         **kw)


@pytest.mark.parametrize("name", ["logistic", "schools", "diag fused"])
def test_fused_chees_loops_never_synchronise(dev, name):
    """run_chees_hmc with the fused engine in both phases: the blocking
    calls of a whole run (its set-up copies, the synchronisations around
    its two timed phases) do not grow with the number of transitions, so
    neither loop reads anything back."""
    from torch.profiler import ProfilerActivity, profile
    if name == "diag fused":
        fn, d, kernel = pot.make_standard_normal(8), 8, "fused"
    else:
        mp = _models_on(dev)[name]
        fn, d, kernel = mp.potential, mp.num_dims, "auto"
    q0 = 0.3 * torch.randn(512, d, device=dev)
    kw = dict(max_steps=16, init_step_size=0.1, collect="moments",
              kernel=kernel)
    pt.run_chees_hmc(2, fn, q0, num_warmup=3, num_samples=3, **kw)  # builds

    def blocking(num_warmup, num_samples):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            res = pt.run_chees_hmc(2, fn, q0, num_warmup=num_warmup,
                                   num_samples=num_samples, **kw)
        assert (res.kernel_used, res.warmup_kernel_used) == ("fused",
                                                             "fused")
        calls = {e.key: e.count for e in prof.key_averages()}
        assert calls.get("cudaLaunchKernel", 0) > num_warmup + num_samples
        return {k: calls.get(k, 0) for k in (
            "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
            "cudaMemcpyAsync")}

    # 8 and 19 warmup transitions are one segment each
    assert blocking(8, 5) == blocking(19, 25)


# ---------------------------------------------------------------------------
# Tempered transitions: SMC's potential scale, a parallel-tempering beta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("beta,scale", [(1.0, 0.37), (0.21, 1.0),
                                        (0.21, 0.37)])
@pytest.mark.parametrize("w,d", [(300, 2), (1000, 24), (64, 33)])
def test_kernels_at_a_beta_and_a_scale_match_plain(dev, beta, scale, w, d):
    """Kernels A and B with (beta, scale) != (1, 1) in their device
    scalars, momenta thermal at beta: within ``_assert_match`` of the plain
    versions, which read the same scalars."""
    rng = np.random.default_rng(w + d)
    im = _t(rng.uniform(0.5, 2.0, d), dev)
    kw = dict(scalars=_t([0.15, beta, scale], dev),
              p_std=torch.sqrt(1 / (im * beta)), inv_mass=im, num_steps=10)
    q = _t(1.5 * rng.normal(size=(w, d)), dev)
    k_diag, mean = _t(rng.uniform(0.5, 2.0, d), dev), _t(rng.normal(size=d),
                                                         dev)
    out_k = dict(zip(A_ORDER, kernels.fused_hmc_diag_quadratic(
        3, 5, q, k_diag=k_diag, mean=mean, **kw)))
    out_p = dict(zip(A_ORDER, kernels.fused_hmc_diag_quadratic_plain(
        3, 5, q, k_diag=k_diag, mean=mean, **kw)))
    torch.cuda.synchronize()
    _assert_match(out_k, out_p, 3, 5)
    for form in _forms(d, dev):
        u, g = kernels.device_value_and_grad(form)(q)
        out_k = dict(zip(B_ORDER, kernels.fused_hmc_transition(
            form, 3, 5, q, u, g, **kw)))
        out_p = dict(zip(B_ORDER, kernels.fused_hmc_transition_plain(
            form, 3, 5, q, u, g, **kw)))
        torch.cuda.synchronize()
        _assert_match(out_k, out_p, 3, 5)


def _rung_case(dev, d, r=3, w=300, seed=0):
    """Rungs of W = 300 walkers (no multiple of any block): q [R, W, D],
    each rung's step size, beta, potential scale, momentum std and key."""
    rng = np.random.default_rng(seed + d)
    betas = rng.uniform(0.1, 1.0, r)
    im = rng.uniform(0.5, 2.0, d)
    q = _t(1.2 * rng.normal(size=(r, w, d)), dev)
    kw = dict(scalars=_t(np.stack([rng.uniform(0.05, 0.2, r), betas,
                                   rng.uniform(0.5, 1.0, r)], 1), dev),
              p_std=_t(np.sqrt(1.0 / (im * betas[:, None])), dev),
              inv_mass=_t(im, dev), walker_offset=17)
    return q, [int(k) for k in rng.integers(0, 2**63, r)], kw


@pytest.mark.parametrize("d", [2, 5, 32, 200])
@pytest.mark.parametrize("counted", [False, True])
def test_kernel_a_rung_launch_is_its_rungs_launches(dev, d, counted):
    """Kernel A on q [3, 300, D], one launch: every output each rung's
    own launch bit for bit, and each rung the plain version's within
    ``_assert_match``; D = 200 runs the loop over dim-groups."""
    q, seeds, kw = _rung_case(dev, d)
    rng = np.random.default_rng(d)
    kw.update(k_diag=_t(rng.uniform(0.5, 2.0, d), dev),
              mean=_t(rng.normal(size=d), dev),
              **(dict(num_steps=_count(9, dev), max_steps=12) if counted
                 else dict(num_steps=9)))
    rung_kw = dict(kw)
    scalars, p_std = rung_kw.pop("scalars"), rung_kw.pop("p_std")
    before = kernels.fused_hmc_diag_quadratic.launches
    got = kernels.fused_hmc_diag_quadratic(seeds, 5, q, **kw)
    assert kernels.fused_hmc_diag_quadratic.launches == before + 1
    per_rung = kernels._stack_rungs(
        kernels.fused_hmc_diag_quadratic(
            key, 5, q[r], scalars=scalars[r], p_std=p_std[r], **rung_kw)
        for r, key in enumerate(seeds))
    plain = kernels.fused_hmc_diag_quadratic_plain(seeds, 5, q, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, per_rung, strict=True):
        _same_bits(a, b)
    for r, key in enumerate(seeds):
        _assert_match({k: v[r] for k, v in zip(A_ORDER, got)},
                      {k: v[r] for k, v in zip(A_ORDER, plain)}, key, 5)


def _rung_forms(dev):
    """Kernel B's forms over rungs: the mixture and the Gaussian (the
    lane groups, the Gaussian at its tile), non-centred eight schools and
    the funnel model (one walker a thread)."""
    rng = np.random.default_rng(4)
    return {"mixture D=2": pot.make_gaussian_mixture(
                torch.tensor([[-6.0, 0.0], [6.0, 0.0]]),
                device=dev).device_form,
            "gaussian D=10": _forms(10, dev)[0],
            "eight_schools_nc D=10": _schools_form(8, dev),
            "funnel_model D=12": _funnel_form("funnel_model", 12, dev),
            "mixture D=33": pot.make_gaussian_mixture(
                2.0 * rng.normal(size=(3, 33)), device=dev).device_form}


@pytest.mark.parametrize("name", ["mixture D=2", "gaussian D=10",
                                  "eight_schools_nc D=10",
                                  "funnel_model D=12", "mixture D=33"])
@pytest.mark.parametrize("variant", ["fixed", "counted+proposal"])
def test_kernel_b_rung_launch_is_its_rungs_launches(dev, name, variant):
    """Kernel B on q [3, 300, D] in both walker layouts (the thread layout
    for eight schools and the funnel model), one launch: every output,
    the proposal included, each rung's own launch bit for bit, and each
    rung the plain version's within ``_assert_match``."""
    form = _rung_forms(dev)[name]
    d = int(name.split("D=")[1])
    q, seeds, kw = _rung_case(dev, d)
    vg = kernels.device_value_and_grad(form)
    u, g = (torch.stack(x) for x in zip(*(vg(x) for x in q)))
    if variant == "fixed":
        kw.update(num_steps=10)
    else:
        kw.update(num_steps=_count(10, dev), max_steps=16,
                  emit_proposal=True)
    rung_kw = dict(kw)
    scalars, p_std = rung_kw.pop("scalars"), rung_kw.pop("p_std")
    layout = kernels.form_layout(form, d, "B")
    before = dict(kernels.fused_hmc_transition.launches_by_layout)
    got = kernels.fused_hmc_transition(form, seeds, 3, q, u, g, **kw)
    assert kernels.fused_hmc_transition.launches_by_layout[layout] == (
        before[layout] + 1)
    per_rung = kernels._stack_rungs(
        kernels.fused_hmc_transition(form, key, 3, q[r], u[r], g[r],
                                     scalars=scalars[r], p_std=p_std[r],
                                     **rung_kw)
        for r, key in enumerate(seeds))
    plain = kernels.fused_hmc_transition_plain(form, seeds, 3, q, u, g, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(per_rung) == (6 if variant == "fixed" else 8)
    for a, b in zip(got, per_rung, strict=True):
        _same_bits(a, b)
    for r, key in enumerate(seeds):
        _assert_match({k: v[r] for k, v in zip(B_ORDER, got)},
                      {k: v[r] for k, v in zip(B_ORDER, plain)}, key, 3)


def test_a_ladder_longer_than_a_launch_takes_blocks_of_rungs(dev):
    """MAX_RUNGS + 2 rungs: two launches of the same kernels, counted as
    two, every output the rungs' own launches' bits; the C entries refuse
    a launch of more rungs than they hold keys for."""
    r = kernels.MAX_RUNGS + 2
    q, seeds, kw = _rung_case(dev, 2, r=r, w=70)
    form = pot.make_gaussian_mixture(torch.tensor([[-2.0, 0.0], [2.0, 0.0]]),
                                     device=dev).device_form
    u, g = (torch.stack(x) for x in zip(
        *(kernels.device_value_and_grad(form)(x) for x in q)))
    rung_kw = dict(kw, num_steps=6)
    scalars, p_std = rung_kw.pop("scalars"), rung_kw.pop("p_std")
    kernels.reset_launch_counts()
    got_b = kernels.fused_hmc_transition(form, seeds, 1, q, u, g,
                                         num_steps=6, **kw)
    got_a = kernels.fused_hmc_diag_quadratic(
        seeds, 1, q, k_diag=torch.ones(2, device=dev),
        mean=torch.zeros(2, device=dev), num_steps=6, **kw)
    assert kernels.launch_counts()["fused_hmc_transition"] == 2
    assert kernels.launch_counts()["fused_hmc_diag_quadratic"] == 2
    want_b = kernels._stack_rungs(
        kernels.fused_hmc_transition(form, key, 1, q[i], u[i], g[i],
                                     scalars=scalars[i], p_std=p_std[i],
                                     **rung_kw)
        for i, key in enumerate(seeds))
    want_a = kernels._stack_rungs(
        kernels.fused_hmc_diag_quadratic(
            key, 1, q[i], scalars=scalars[i], p_std=p_std[i],
            k_diag=torch.ones(2, device=dev),
            mean=torch.zeros(2, device=dev), **rung_kw)
        for i, key in enumerate(seeds))
    torch.cuda.synchronize()
    for a, b in zip((*got_b, *got_a), (*want_b, *want_a), strict=True):
        _same_bits(a, b)
    from physicsbasedbayesianinference_tpu_torch.ops._build import (
        load_library)
    rc = load_library().pbbi_fused_hmc_diag_quadratic(
        q.data_ptr(), *[torch.ones(2, device=dev).data_ptr()] * 4,
        kw["scalars"].data_ptr(), *[torch.empty_like(q).data_ptr()] * 6,
        None, 0, 70, 2, 6, 1000.0, r, kernels._key_array(seeds), 1, 0,
        torch.cuda.current_stream().cuda_stream)
    assert rc != 0


@pytest.mark.parametrize("name", ["diag", "nbody"])
def test_run_smc_mutates_in_the_fused_kernels(dev, name):
    """run_smc(kernel="auto") on CUDA: every mutation one launch of kernel
    A (a diag target) or B (the N-body form), one host read a stage plus
    the last, the same bits from the same seed, moments and evidence
    beside the composed engine's."""
    from physicsbasedbayesianinference_tpu_torch import smc
    if name == "diag":
        fn, d, wanted = pot.make_standard_normal(4), 4, \
            "fused_hmc_diag_quadratic"
        q0 = torch.randn(4096, 4, device=dev) / 0.1**0.5
        kw = dict(beta0=0.1, init_step_size=0.8)
    else:
        fn, d, wanted = pot.make_nbody_potential(
            np.ones(4), 4, softening=0.3), 12, "fused_hmc_transition"
        q0 = 2.0 * torch.randn(4096, 12, device=dev)
        kw = dict(beta0=0.05, init_step_size=0.3, num_leapfrog_steps=8)
    kernels.reset_launch_counts()
    reads = smc._host_read.reads
    res = pt.run_smc(1, fn, q0, max_stages=30, **kw)
    assert res.kernel_used == "fused"
    counts = kernels.launch_counts()
    assert counts[wanted] == 3 * res.num_stages
    assert sum(counts.values()) == counts[wanted]
    assert smc._host_read.reads - reads == res.num_stages + 1
    again = pt.run_smc(1, fn, q0, max_stages=30, **kw)
    assert torch.equal(again.q, res.q)
    assert torch.equal(again.log_evidence, res.log_evidence)
    ref = pt.run_smc(2, fn, q0, max_stages=30, kernel="composed", **kw)
    assert float(res.log_evidence) == pytest.approx(
        float(ref.log_evidence), abs=0.3)
    if name == "diag":
        assert float(res.log_evidence) == pytest.approx(2 * np.log(0.1),
                                                        abs=0.25)
        assert float(res.q.var()) == pytest.approx(1.0, abs=0.1)


def test_smc_stage_and_pt_loops_never_synchronise(dev):
    """An SMC stage (body) on the fused route and a parallel-tempering run's
    loops issue no blocking call that grows with the stages or the
    transitions."""
    from torch.profiler import ProfilerActivity, profile

    from physicsbasedbayesianinference_tpu_torch import smc
    nbody = pot.make_nbody_potential(np.ones(4), 4, softening=0.3)
    m = smc.build_smc_machinery(nbody, 1024, torch.float32, num_dims=12,
                                beta0=0.05, device=dev)
    carry = m["body"](m["init_carry"](0, 2 * torch.randn(1024, 12,
                                                         device=dev)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            carry = m["body"](carry)
    calls = {e.key: e.count for e in prof.key_averages()}
    assert not {k: n for k, n in calls.items() if k in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
        "cudaMemcpyAsync")}
    assert m["kernel_used"] == "fused"

    fn = pot.make_gaussian_mixture(np.float32([[-3.0, 0.0], [3.0, 0.0]]))
    q0 = torch.randn(512, 2, device=dev)
    pt.run_parallel_tempering(0, fn, q0, num_replicas=3, num_warmup=2,
                              num_samples=2)  # builds

    def blocking(num_warmup, num_samples):
        # moments: collect="samples" copies the cold replica on the device
        # once a transition, a cudaMemcpyAsync to the profiler
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            res = pt.run_parallel_tempering(
                0, fn, q0, num_replicas=3, num_warmup=num_warmup,
                num_samples=num_samples, collect="moments")
        assert res.kernel_used == "fused"
        # the three rungs in one launch a transition
        assert kernels.launch_counts()["fused_hmc_transition"] == (
            num_warmup + num_samples)
        calls = {e.key: e.count for e in prof.key_averages()}
        return {k: calls.get(k, 0) for k in (
            "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
            "cudaMemcpyAsync")}

    assert blocking(3, 4) == blocking(11, 17)


def test_run_nuts_on_cuda_reads_only_its_loop_conditions(dev):
    from physicsbasedbayesianinference_tpu_torch import nuts
    sds = torch.logspace(0.0, 1.0, 8)
    fn = pot.make_gaussian(np.zeros(8), cov=np.diag(sds.numpy() ** 2))
    q0 = torch.randn(4096, 8, device=dev) * sds.to(dev)
    kernels.reset_launch_counts()
    res = pt.run_nuts(0, fn, q0, num_warmup=100, num_samples=100)
    assert sum(kernels.launch_counts().values()) == 0  # no fused kernel
    flat = res.samples.reshape(-1, 8)
    sd = sds.to(dev)
    assert float((flat.mean(0) / sd).abs().max()) < 0.05
    assert float((flat.var(0) / sd**2 - 1).abs().max()) < 0.1
    reads = nuts._host_read.reads
    k = nuts.build_nuts_kernel(fn)
    _, info = k.step((0, 0), res.state, res.step_size)
    depth = int(info.depth.max())
    # the outer condition once a doubling (and once more if the tree
    # stops before max_depth); doubling j's after leaves 1, 2, ..., 2^(j-1)
    assert depth <= nuts._host_read.reads - reads <= depth + 1 + sum(
        range(depth))


@pytest.mark.parametrize("w,d", [(1000, 32), (999, 5), (64, 200)])
def test_offset_halves_join_to_the_whole_launch(dev, w, d):
    """Kernels A and B on two blocks of walkers at their global offsets
    give the whole launch's bits (the draws name the global walker)."""
    gen = torch.Generator(device="cpu").manual_seed(w + d)
    q = torch.randn(w, d, generator=gen).to(dev)
    im = (0.5 + torch.rand(d, generator=gen)).to(dev)
    kw = dict(scalars=torch.tensor([0.3, 1.0, 1.0], device=dev),
              p_std=torch.sqrt(1.0 / im), inv_mass=im, num_steps=8)
    k, mu = torch.ones(d, device=dev), torch.zeros(d, device=dev)
    rows = (slice(0, w // 3), slice(w // 3, w))
    whole = kernels.fused_hmc_diag_quadratic(5, 2, q, k_diag=k, mean=mu,
                                             **kw)
    parts = [kernels.fused_hmc_diag_quadratic(
        5, 2, q[r].contiguous(), k_diag=k, mean=mu, walker_offset=r.start,
        **kw) for r in rows]
    for a, b0, b1 in zip(whole, *parts):
        assert torch.equal(a, torch.cat([b0, b1]))
    if d <= kernels.MAX_GENERIC_DIMS:
        a_ = torch.randn(d, d, generator=gen) / d**0.5
        form = pot.make_gaussian(torch.zeros(d), cov=a_ @ a_.T + torch.eye(d),
                                 device=dev).device_form
        u, g = kernels.device_value_and_grad(form)(q)
        whole = kernels.fused_hmc_transition(form, 5, 2, q, u, g, **kw)
        parts = [kernels.fused_hmc_transition(
            form, 5, 2, q[r].contiguous(), u[r].contiguous(),
            g[r].contiguous(), walker_offset=r.start, **kw) for r in rows]
        for a, b0, b1 in zip(whole, *parts):
            assert torch.equal(a, torch.cat([b0, b1]))
        # the second block against the plain version at the same offset
        plain = kernels.fused_hmc_transition_plain(
            form, 5, 2, q[rows[1]], u[rows[1]], g[rows[1]],
            walker_offset=rows[1].start, **kw)
        out_k = dict(zip(B_ORDER, parts[1]))
        out_p = dict(zip(B_ORDER, plain))
        for key in ("energy_error", "accept_prob"):
            torch.testing.assert_close(out_k[key], out_p[key], rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("n,softening", [(1000, 0.05), (1000, 0.0),
                                         (4097, 0.05)])
def test_source_block_launches(dev, n, softening):
    """Kernel E with the bodies as their own sources is the one-set launch
    bit for bit; over two source blocks, summed, within the bound of the
    one-set launch; launches counted by form."""
    gen = torch.Generator(device="cpu").manual_seed(n)
    x = torch.randn(n, 3, generator=gen).to(dev)
    m = (0.5 + torch.rand(n, generator=gen)).to(dev)
    kw = dict(g_const=1.0, softening=softening)
    kernels.reset_launch_counts()
    one = kernels.nbody_accelerations_tiled(x, m, **kw)
    assert torch.equal(one, kernels.nbody_accelerations_tiled(
        x, None, sources=(x, m), **kw))
    half = n // 2
    two = sum(kernels.nbody_accelerations_tiled(
        x, None, sources=(x[r].contiguous(), m[r].contiguous()), **kw)
        for r in (slice(0, half), slice(half, n)))
    bound = kernels.nbody_bound(x, m, g_const=1.0, softening=softening)
    assert bool(((two - one).abs().double() <= bound[:, None]).all())
    assert kernels.nbody_accelerations_tiled.launches_by == {
        "one_set": 1, "source_block": 3}
    with pytest.raises(ValueError, match="x_src"):
        kernels.nbody_accelerations_tiled(x, None, sources=(x[:, :2], m),
                                          **kw)


# ---------------------------------------------------------------------------
# Kernel A's bfloat16 trajectory and the example models' forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w,d", [(1, 1), (41, 3), (37, 5), (300, 32),
                                 (64, 33), (70, 128)])
def test_diag_kernel_bf16_from_rest_is_the_plain_versions_bits(dev, w, d):
    """From rest (p_std = 0) kernel and plain version round the same
    operations of the bfloat16 chain, each once: q' and g' are the plain
    version's bits where the decisions agree, and q' is a bfloat16 value;
    the energies sum in another order (``_assert_match``). Above D = 128
    the bfloat16 trajectory is refused before any launch."""
    rng = np.random.default_rng(w * 1000 + d)
    q = _t(rng.normal(size=(w, d)), dev)
    im = _t(rng.uniform(0.5, 2.0, d), dev)
    kw = dict(scalars=_t([0.4, 1.3, 0.5], dev), p_std=torch.zeros_like(im),
              inv_mass=im, k_diag=_t(rng.uniform(0.5, 2.0, d), dev),
              mean=_t(rng.normal(size=d), dev), num_steps=12,
              trajectory_dtype=torch.bfloat16)
    before = dict(kernels.fused_hmc_diag_quadratic.launches_by)
    out_k = dict(zip(A_ORDER, kernels.fused_hmc_diag_quadratic(
        99, 5, q, **kw)))
    assert kernels.fused_hmc_diag_quadratic.launches_by["bfloat16"] == \
        before["bfloat16"] + 1
    out_p = dict(zip(A_ORDER, kernels.fused_hmc_diag_quadratic_plain(
        99, 5, q, **kw)))
    torch.cuda.synchronize()
    _assert_match(out_k, out_p, 99, 5)
    agree = out_k["accepted"] == out_p["accepted"]
    _same_bits(out_k["q"], out_p["q"], agree)
    _same_bits(out_k["g"], out_p["g"], agree)
    assert torch.equal(out_k["q"].to(torch.bfloat16).float()[agree],
                       out_p["q"][agree])
    wide = _t(rng.normal(size=(4, 129)), dev)
    ones = torch.ones(129, device=dev)
    launches = kernels.fused_hmc_diag_quadratic.launches
    with pytest.raises(ValueError, match="bfloat16 trajectory up to"):
        kernels.fused_hmc_diag_quadratic(
            99, 5, wide, scalars=kw["scalars"], p_std=ones, inv_mass=ones,
            k_diag=ones, mean=0 * ones, num_steps=2,
            trajectory_dtype=torch.bfloat16)
    assert kernels.fused_hmc_diag_quadratic.launches == launches


def test_diag_kernel_bf16_samples_the_standard_normal(dev):
    """The TPU kernel's test (tests/test_pallas.py, TPU-only there): 100
    transitions at W = 16384, D = 32, L = 16, step 0.6 from a standard
    normal start: mean |dE| < 2 over the last 50, acceptance in (0.3, 1],
    the mean 0 +- 0.02 and the variance 1 +- 3%."""
    w, d = 16384, 32
    q = torch.randn(w, d, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    one = torch.ones(d, device=dev)
    kw = dict(scalars=_t([0.6, 1.0, 1.0], dev), p_std=one, inv_mass=one,
              k_diag=one, mean=0 * one, num_steps=16,
              trajectory_dtype=torch.bfloat16)
    accs, errs = [], []
    for t in range(100):
        q, _, _, acc, _, derr = kernels.fused_hmc_diag_quadratic(
            11, t, q, **kw)
        accs.append(acc.mean())
        errs.append(derr.abs().mean())
    assert float(torch.stack(errs[50:]).mean()) < 2.0
    assert 0.3 < float(torch.stack(accs[50:]).mean()) <= 1.0
    assert abs(float(q.mean())) < 0.02
    assert abs(float(q.var()) - 1.0) < 0.03
    assert abs(float(q.var(0).mean()) - 1.0) < 0.03


def _example_forms(dev):
    """Every example model's ``(form, D)`` at a few shapes, built by the
    registry from the models (data on the card)."""
    from physicsbasedbayesianinference_tpu_torch import models
    coin = _coin_data()
    made = {}
    for n, p in ((256, 30), (7, 4), (40, 33), (257, 1)):
        made[f"linear N={n} D={p + 2}"] = models.make_model_potential(
            models.linear_regression, models.linear_regression_data(n, p),
            {}, device=dev)
    made["eight_schools"] = models.make_model_potential(
        models.eight_schools, (), models.EIGHT_SCHOOLS_DATA, device=dev)
    made["coin"] = models.make_model_potential(models.coin_toss, (), coin,
                                               device=dev)
    for dim in (5, 15):
        made[f"funnel dim={dim}"] = models.make_model_potential(
            models.funnel, (), {"dim": dim}, device=dev)
        made[f"funnel dim={dim} auto"] = models.make_model_potential(
            models.funnel, (), {"dim": dim}, reparam="auto", device=dev)
    return {k: (mp.potential.device_form, mp.num_dims)
            for k, mp in made.items()}


EXAMPLE_FORMS = ["linear N=256 D=32", "linear N=7 D=6", "linear N=40 D=35",
                 "linear N=257 D=3", "eight_schools", "coin",
                 "funnel dim=5", "funnel dim=15", "funnel dim=5 auto",
                 "funnel dim=15 auto"]


@pytest.mark.parametrize("name", EXAMPLE_FORMS)
def test_example_model_forms_match_plain(dev, name):
    """Kernels B (its four variants: the count fixed or on the device, with
    or without the proposal) and D (with and without the cached pair) on
    every example model's form, against the plain versions. The linear
    form sums and rounds as the logistic form does: B's q', u', g' where
    the decisions agree, its proposal and D's outputs are the plain
    version's bits, at every walker tile. The others: ``_assert_match``
    for B, 1e-5 for D, and their proposal to 1e-5. A second launch gives
    the same bits."""
    form, d = _example_forms(dev)[name]
    w = 75
    q, u, g, kw = _b_case(form, w, d, dev, spread=0.3, step=0.02)
    bits = form[0] == "linear"
    if bits:  # about the least-squares fit, where the steps are stable
        q = q / 6.0 + _least_squares(form)
        u, g = kernels.device_value_and_grad(form)(q)
    tiles = kernels.WALKER_TILES if bits else (None,)
    for counted in (False, True):
        for prop in (False, True):
            extra = dict(emit_proposal=prop)
            extra.update(dict(num_steps=_count(6, dev), max_steps=8)
                         if counted else dict(num_steps=6))
            want = kernels.fused_hmc_transition_plain(form, 7, 3, q, u, g,
                                                      **kw, **extra)
            for tile in tiles:
                out = kernels.fused_hmc_transition(form, 7, 3, q, u, g,
                                                   tile=tile, **kw, **extra)
                again = kernels.fused_hmc_transition(
                    form, 7, 3, q, u, g, tile=tile, **kw, **extra)
                torch.cuda.synchronize()
                for a, b in zip(out, again):
                    _same_bits(a, b)
                got, ref = dict(zip(B_ORDER, out)), dict(zip(B_ORDER, want))
                _assert_match(got, ref, 7, 3)
                agree = got["accepted"] == ref["accepted"]
                for a, b in zip(out[6:], want[6:]):
                    if bits:
                        _same_bits(a, b)
                    else:
                        torch.testing.assert_close(a, b, rtol=1e-5,
                                                   atol=1e-5)
                if bits:
                    for key in ("q", "u", "g"):
                        _same_bits(got[key], ref[key], agree)
    p = _t(np.random.default_rng(d).normal(size=(w, d)), dev)
    for cached in (False, True):
        lk = dict(step_size=_t([0.02], dev), num_steps=5,
                  inv_mass=kw["inv_mass"])
        if cached:
            lk.update(grad=g, potential_energy=u)
        want = kernels.leapfrog_trajectory_plain(form, q, p, **lk)
        for tile in tiles:
            out = kernels.leapfrog_trajectory(form, q, p, tile=tile, **lk)
            torch.cuda.synchronize()
            for a, b in zip(out, want):
                if bits:
                    _same_bits(a, b)
                else:
                    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,reparam,form", [
    ("linear_regression", None, "linear"),
    ("eight_schools", None, "eight_schools"),
    ("eight_schools", "auto", "eight_schools_nc"),
    ("coin_toss", None, "coin"),
    ("funnel", None, "funnel_model"),
    ("funnel", "auto", "diag_model")])
def test_run_chees_on_every_example_model_runs_in_kernel_b(
        dev, name, reparam, form):
    """Each example model (as the command line loads it) runs ChEES with
    both phases in kernel B: 100 + 60 launches, none of A or D."""
    from physicsbasedbayesianinference_tpu_torch import models
    if name == "linear_regression":
        args, kwargs = models.linear_regression_data(64, 6), {}
    elif name == "coin_toss":
        args, kwargs = (), {k: v for k, v in _coin_data().items()}
    elif name == "funnel":
        args, kwargs = (), {"dim": 7}
    else:
        args, kwargs = (), models.EIGHT_SCHOOLS_DATA
    mp = models.make_model_potential(models.EXAMPLE_MODELS[name], args,
                                     kwargs, reparam=reparam, device=dev)
    assert mp.potential.device_form[0] == form
    q0 = 0.3 * torch.randn(4096, mp.num_dims, device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
    kernels.reset_launch_counts()
    res = pt.run_chees_hmc(4, mp.potential, q0, num_warmup=100,
                           num_samples=60, max_steps=64, init_step_size=0.1,
                           collect="moments")
    assert (res.kernel_used, res.warmup_kernel_used) == ("fused", "fused")
    assert kernels.launch_counts() == {
        "fused_hmc_diag_quadratic": 0, "fused_hmc_transition": 160,
        "leapfrog_trajectory": 0, "nbody_accelerations_tiled": 0}
    assert bool(torch.isfinite(res.mean).all())


def _least_squares(form):
    """The linear form's (w, b, log noise) at the data's least-squares
    fit."""
    x, y, _ = (t.double().cpu() for t in form[1])
    xa = torch.cat([x, torch.ones(x.shape[0], 1, dtype=x.dtype)], 1)
    coef = torch.linalg.lstsq(xa, y[:, None]).solution[:, 0]
    resid = y - xa @ coef
    log_noise = 0.5 * torch.log((resid * resid).mean() + 1e-6)
    return torch.cat([coef, log_noise[None]]).float().to(form[1][0].device)


def _coin_data():
    import json
    from pathlib import Path
    with open(Path(__file__).resolve().parent.parent / "examples"
              / "coin_toss.data.json") as f:
        return {k: np.asarray(v, np.float32) for k, v in json.load(f).items()
                if k in ("c1", "c2")}


@pytest.mark.parametrize("w,d", [(1, 1), (300, 3), (129, 5), (1000, 16),
                                 (257, 32), (77, 33), (64, 128)])
@pytest.mark.parametrize("name", ["diag", "diag_model"])
def test_diag_forms_match_plain_bitwise(dev, name, w, d):
    """The diagonal forms (form 5, and form 12 with its constant: the
    funnel model under reparam="auto") in kernels B and D, lane-group
    layout: each lane holds its four k and mu in registers and sums the
    value's terms in the plain version's order (a padded dim adds +0), so
    B's q', u', g' where the decisions agree and its proposal, in its four
    variants, and all of D's outputs are the plain version's bits
    (``_check_thread_layout`` with ``bits``)."""
    rng = np.random.default_rng(d)
    k, mu = _t(rng.uniform(0.5, 2.0, d), dev), _t(rng.normal(size=d), dev)
    form = (("diag", (k, mu)) if name == "diag" else
            ("diag_model", (k, mu, _t([-0.37 * d], dev))))
    assert kernels.form_layout(form, d, "B") == "group"
    _check_thread_layout(dev, form, w, d, spread=1.0, bits=True)


def _lane_group_cases(dev):
    """(label, form, D, tile) for every form in kernel B's lane groups, at
    1, 2, 8 and 32 lanes a walker and each walker tile a tiled form
    takes."""
    cases = []
    for d, tile in ((2, 4), (32, 4), (32, 2), (33, 1), (128, 2)):
        cases.append((f"gaussian D={d} tile {tile}",
                      _forms(d, dev)[0], d, tile))
    for n, d, tile in ((256, 32, 4), (7, 6, 2), (40, 33, 1)):
        cases.append((f"logistic N={n} D={d} tile {tile}",
                      _logistic_form(n, d, dev), d, tile))
    from physicsbasedbayesianinference_tpu_torch import models
    x, y = models.linear_regression_data(40, 30)
    cases.append(("linear N=40 D=32 tile 4", models.make_model_potential(
        models.linear_regression, (x, y), {},
        device=dev).potential.device_form, 32, 4))
    for d in (2, 16):
        cases.append((f"coin D={d}", _coin_form(d, dev), d, None))
    cases.append(("mixture K=3 D=10", _forms(10, dev)[2], 10, None))
    cases.append(("banana", _forms(2, dev)[2], 2, None))
    cases.append(("funnel D=33", _forms(33, dev)[1], 33, None))
    cases.append(("nbody N=12 D=36", _forms(36, dev)[-1], 36, None))
    cases.append(("eight_schools_nc J=20", _schools_form(20, dev), 22,
                  None))
    cases.append(("eight_schools J=20",
                  _schools_form(20, dev, "eight_schools"), 22, None))
    for d in (16, 128):
        rng = np.random.default_rng(d)
        cases.append((f"diag_model D={d}", (
            "diag_model", (_t(rng.uniform(0.5, 2.0, d), dev),
                           _t(rng.normal(size=d), dev), _t([1.5], dev))),
            d, None))
    return cases


@pytest.mark.parametrize("variant", ["fixed", "counted+proposal"])
def test_lane_group_decisions_take_each_walkers_own_draw(dev, variant):
    """Kernel B in the lane groups draws each walker's Metropolis uniform
    once, on the block's first threads, and each lane reads its walker's at
    the decision: for every form there, at T = 1 to 32 lanes a walker and
    walker tiles 1, 2 and 4, over W = 3000 walkers (several blocks, the
    last one partial), a walker is accepted exactly when log u_w < -dH_w
    and dH_w is not divergent, with u_w its own draw
    (``philox.accept_uniforms``) and dH_w its own energy error. H0 takes
    the cached u and the trajectory does not, so a second launch with u
    raised by the first launch's dH_w plus z_w ~ N(0, 1) has dH_w close to
    -z_w: the acceptance is then near one half whatever the form, and a
    walker reading another's draw would be caught. Its accept probability
    is exp(min(0, -dH_w))."""
    seed, counter, w = 21, 9, 3000
    z = _t(np.random.default_rng(5).normal(size=w), dev)
    for label, form, d, tile in _lane_group_cases(dev):
        assert kernels.form_layout(form, d, "B") == "group", label
        q, u, g, kw = _b_case(form, w, d, dev, spread=0.5, step=0.05)
        extra = (dict(num_steps=8) if variant == "fixed" else
                 dict(num_steps=_count(8, dev), max_steps=8,
                      emit_proposal=True))

        def run(u_cached):
            return kernels.fused_hmc_transition(
                form, seed, counter, q, u_cached, g, tile=tile, **kw,
                **extra)

        first = run(u)[5]
        out = run(u + torch.where(torch.isfinite(first), first, 0.0) + z)
        torch.cuda.synchronize()
        derr, taken, acc = out[5], out[4], out[3]
        log_u = torch.log(philox.accept_uniforms(seed, counter, w, dev))
        want = (log_u < -derr) & ~(derr > 1000.0)
        assert torch.equal(taken, want), (label, (taken != want).sum())
        torch.testing.assert_close(
            acc, torch.where(derr > 1000.0, 0.0,
                             torch.exp(torch.clamp_max(-derr, 0.0))),
            rtol=1e-6, atol=0.0, msg=label)
        share = taken.float().mean().item()
        assert 0.1 < share < 0.9, (label, share)
