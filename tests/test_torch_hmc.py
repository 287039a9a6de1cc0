"""The slice as a whole: ``run_hmc`` of the torch port (composed engine on
the CPU) against the JAX package's ``run_hmc`` on the same targets, the
engine routing table, and state conversion between the two packages.

Monte Carlo tolerances (2048 walkers x 100 transitions, L=8): posterior
means within 0.05 sd, variances within 6%, mean acceptance rates within
0.06 of each other and mean adapted step sizes within 15% over three runs."""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import hmc as jh
from physicsbasedbayesianinference_tpu.ops import potentials as jp
import physicsbasedbayesianinference_tpu_torch as pt
from physicsbasedbayesianinference_tpu_torch import hmc as th
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp
from physicsbasedbayesianinference_tpu_torch.utils import convert
from _torch_cpu import cpu, cpu_requested  # noqa: F401  (the CPU, asked for)

W, L, WARM, SAMP = 2048, 8, 150, 100
MU4 = np.float32([1.0, -2.0, 0.5, 0.0])
VAR4 = np.float32([0.5, 1.0, 2.0, 4.0])
MEAN2 = np.float32([2.0, -1.0])
COV2 = np.float32([[1.0, 0.8], [0.8, 2.0]])


def _targets():
    return {
        "diag4": (jp.make_gaussian(MU4, precision=np.diag(1 / VAR4)),
                  tp.make_gaussian(MU4, precision=np.diag(1 / VAR4)),
                  MU4, VAR4),
        "corr2": (jp.make_gaussian(MEAN2, cov=COV2),
                  tp.make_gaussian(MEAN2, cov=COV2), MEAN2, np.diag(COV2)),
    }


def _jax_state_numpy(state):
    ens = state.ensemble
    values = (ens.q, ens.p, ens.mass, ens.log_weight,
              state.potential_energy, state.grad)
    return {k: np.array(v) for k, v in zip(convert.STATE_KEYS, values)}


@pytest.mark.parametrize("name", ["diag4", "corr2"])
def test_run_hmc_matches_jax(name):
    jfn, tfn, mean, var = _targets()[name]
    kw = dict(num_warmup=WARM, num_samples=SAMP, num_steps=L,
              collect="moments")
    sd = np.sqrt(var)
    steps_j, steps_t, acc_j, acc_t = [], [], [], []
    # one adapted step size varies by ~6% from run to run: compare the
    # means of three runs per package
    for seed in (1, 2, 3):
        q0 = np.random.default_rng(seed).normal(
            size=(W, mean.shape[0])).astype(np.float32)
        rj = jh.run_hmc(jax.random.key(seed), jfn, jnp.asarray(q0), **kw)
        rt = pt.run_hmc(seed, tfn, torch.as_tensor(q0), **kw)
        assert (rt.kernel_used, rt.kernel_variant) == ("composed",
                                                       "composed")
        for mean_hat, var_hat in ((np.asarray(rj.mean), np.asarray(rj.var)),
                                  (rt.mean.numpy(), rt.var.numpy())):
            np.testing.assert_allclose(mean_hat, mean, atol=0.05 * sd.min())
            np.testing.assert_allclose(var_hat, var, rtol=0.06)
        assert 0.6 < float(rt.accept_rate) < 0.99
        assert rt.num_grad_evals == rj.num_grad_evals
        assert float(rt.divergence_rate) == 0.0
        steps_j.append(float(rj.step_size))
        steps_t.append(float(rt.step_size))
        acc_j.append(float(rj.accept_rate))
        acc_t.append(float(rt.accept_rate))
    assert abs(np.mean(acc_t) - np.mean(acc_j)) < 0.06
    assert np.mean(steps_t) == pytest.approx(np.mean(steps_j), rel=0.15)


def test_state_conversion_and_sampling_from_a_jax_warmup():
    """A JAX-adapted (state, step size, mass) round-trips exactly through
    the port and samples the target there. ``num_samples=0`` gives a NaN
    acceptance rate in both packages (kept deliberately)."""
    jfn, tfn, mean, var = _targets()["corr2"]
    q0 = np.random.default_rng(3).normal(size=(W, 2)).astype(np.float32)
    rj = jh.run_hmc(jax.random.key(2), jfn, jnp.asarray(q0),
                    num_warmup=WARM, num_samples=0, num_steps=L,
                    collect="samples")
    rt = pt.run_hmc(2, tfn, torch.as_tensor(q0), num_warmup=20,
                    num_samples=0, num_steps=L, collect="samples")
    assert math.isnan(float(rj.accept_rate))
    assert math.isnan(float(rt.accept_rate))
    assert rt.samples.shape == (0, W, 2) == np.asarray(rj.samples).shape

    as_numpy = _jax_state_numpy(rj.state)
    state = convert.hmc_state_from_jax(as_numpy)
    back = convert.hmc_state_to_numpy(state)
    for key in convert.STATE_KEYS:
        assert back[key].dtype == as_numpy[key].dtype
        np.testing.assert_array_equal(back[key], as_numpy[key])

    kern = pt.build_hmc_kernel(tfn, num_steps=L)
    step = torch.as_tensor(np.array(rj.step_size))
    qs = []
    for t in range(80):
        state, info = kern.step((5, t), state, step)
        qs.append(state.ensemble.q)
    q = torch.cat(qs).double().numpy()
    np.testing.assert_allclose(q.mean(0), mean, atol=0.05)
    np.testing.assert_allclose(np.cov(q.T), COV2, atol=0.08)


def _stub(device, dtype=torch.float32, d=2):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                 shape=(8, d))


def _user_potential(q):
    """A potential with no routing attributes (no device form)."""
    return torch.sum(q**4, dim=-1)


def test_engine_routing_table():
    std = tp.make_standard_normal(2)
    corr = tp.make_gaussian(MEAN2, cov=COV2)
    wide = tp.make_gaussian(np.zeros(129), cov=np.eye(129) + 0.1)
    banana = _user_potential
    cpu, cuda = _stub("cpu"), _stub("cuda")
    # the table: CPU -> composed; CUDA + diag/device form -> fused;
    # CUDA + anything else -> composed
    for fn in (std, corr, banana, tp.make_banana()):
        assert th.resolve_engine("auto", fn, cpu) == "composed"
    assert th.resolve_engine("auto", std, cuda) == "fused"
    assert th.resolve_engine("auto", corr, cuda) == "fused"
    for fn in (tp.make_banana(), tp.make_gaussian_mixture(np.eye(2)),
               tp.make_nbody_potential(np.ones(2), 2, 1), tp.no_potential):
        assert th.resolve_engine("auto", fn, cuda) == "fused"
    assert th.resolve_engine("auto", banana, cuda) == "composed"
    # a device form the kernel does not take at this D
    assert th.resolve_engine("auto", tp.make_banana(),
                             _stub("cuda", d=3)) == "composed"
    assert th.resolve_engine("auto", wide, _stub("cuda", d=129)) == \
        "composed"
    assert th.resolve_engine("auto", std, _stub("cuda", torch.float64)) \
        == "composed"
    assert th.resolve_engine("auto", std, cuda,
                             integrator="mclachlan") == "composed"
    assert th.resolve_engine("composed", std, cuda) == "composed"
    # an explicit "fused" that cannot be honoured raises, never degrades
    for fn, q, integ in ((std, cpu, "leapfrog"), (banana, cuda, "leapfrog"),
                         (std, cuda, "yoshida4"),
                         (std, _stub("cuda", torch.float64), "leapfrog")):
        with pytest.raises(ValueError, match="cannot run"):
            th.resolve_engine("fused", fn, q, integrator=integ)
    with pytest.raises(ValueError, match="auto\\|fused\\|composed"):
        th.resolve_engine("xla", std, cpu)
    with pytest.raises(ValueError, match="cannot run"):
        pt.run_hmc(0, std, torch.zeros(4, 2), num_warmup=1, num_samples=1,
                   num_steps=2, kernel="fused")


def test_variants_and_input_checks():
    kern = pt.build_fused_hmc_kernel(_user_potential, num_steps=2)
    assert kern.kind == "fused"
    assert kern.variant_for(8, 2, 1) == "composed"
    banana = pt.build_fused_hmc_kernel(tp.make_banana(), num_steps=2)
    assert banana.variant_for(8, 2, 1) == "generic"
    assert banana.variant_for(8, 3, 1) == "composed"
    corr = pt.build_fused_hmc_kernel(tp.make_gaussian(MEAN2, cov=COV2),
                                     num_steps=2)
    assert corr.variant_for(8, 2, 1) == "generic"
    assert corr.variant_for(8, 2, 2) == "composed"  # per-walker mass
    # a composed-variant step is the composed transition itself
    q = torch.randn(16, 2, generator=torch.Generator().manual_seed(0))
    st = kern.init(q)
    base = pt.build_hmc_kernel(_user_potential, num_steps=2)
    a, _ = kern.step((1, 2), st, torch.tensor(0.05))
    b, _ = base.step((1, 2), base.init(q), torch.tensor(0.05))
    assert torch.equal(a.ensemble.q, b.ensemble.q)
    std = tp.make_standard_normal(2)
    with pytest.raises(ValueError, match="collect"):
        pt.run_hmc(0, std, q, num_warmup=1, num_samples=1, num_steps=2,
                   collect="all")
    with pytest.raises(ValueError, match="walker axis|num_walkers"):
        pt.run_hmc(0, std, torch.zeros(2), num_warmup=1, num_samples=1,
                   num_steps=2)
    with pytest.raises(ValueError, match="available"):
        pt.run_hmc(0, std, q, num_warmup=1, num_samples=1, num_steps=2,
                   integrator="rk4")
    res = pt.run_hmc(0, std, q, num_warmup=0, num_samples=5, num_steps=2,
                     thin=2)
    assert res.samples.shape == (3, 16, 2)


class _DefaultDeviceAsked(Exception):
    pass


def _entry_points():
    """Every entry point that takes initial positions, called on them."""
    from physicsbasedbayesianinference_tpu_torch import chees, nuts, smc
    std = tp.make_standard_normal(2)
    few = dict(num_warmup=2, num_samples=2)
    return {
        "run_hmc": lambda q: pt.run_hmc(0, std, q, num_steps=2, **few),
        "run_hmc dense": lambda q: pt.run_hmc(0, std, q, num_steps=2,
                                              metric="dense", **few),
        "run_chees_hmc": lambda q: pt.run_chees_hmc(0, std, q, max_steps=4,
                                                    **few),
        "run_smc": lambda q: pt.run_smc(0, std, q, beta0=0.5, max_stages=2),
        "smc init_carry": lambda q, m=smc.build_smc_machinery(
            std, 8, torch.float32, num_dims=2): m["init_carry"](0, q),
        "run_parallel_tempering": lambda q: pt.run_parallel_tempering(
            0, std, q, num_replicas=2, num_steps=2, **few),
        "run_nuts": lambda q: pt.run_nuts(0, std, q, max_depth=2, **few),
        "build_hmc_kernel init": lambda q: pt.build_hmc_kernel(
            std, num_steps=2).init(q),
        "build_fused_hmc_kernel init": lambda q: pt.build_fused_hmc_kernel(
            std, num_steps=2).init(q),
        "build_dense_hmc_kernel init": lambda q: pt.build_dense_hmc_kernel(
            std, num_steps=2).init(q),
        "build_jittered_hmc_kernel init": lambda q:
            chees.build_jittered_hmc_kernel(std)[0](q),
        "build_nuts_kernel init": lambda q: nuts.build_nuts_kernel(
            std).init(q),
    }


with cpu():  # the parameters' names, built while collecting
    _ENTRY_POINT_NAMES = sorted(_entry_points())


@pytest.mark.parametrize("name", _ENTRY_POINT_NAMES)
def test_entry_points_put_numpy_init_q_on_the_default_device(monkeypatch,
                                                             name):
    """A numpy ``init_q`` goes to ``device.default_device()`` (the card
    when there is one), a tensor keeps its device: the resolution runs
    through ``default_device`` for the one and not for the other."""
    from physicsbasedbayesianinference_tpu_torch import device

    call = _entry_points()[name]
    q = np.random.default_rng(0).normal(size=(8, 2)).astype(np.float32)
    call(torch.as_tensor(q))  # built before the patch: a tensor runs

    def asked():
        raise _DefaultDeviceAsked

    monkeypatch.setattr(device, "default_device", asked)
    call(torch.as_tensor(q))  # a tensor never asks
    with pytest.raises(_DefaultDeviceAsked):
        call(q)
