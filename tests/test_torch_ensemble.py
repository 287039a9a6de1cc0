"""Constants and ensemble helpers of the torch port against the JAX package
(float32, rtol=1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import constants as jc
from physicsbasedbayesianinference_tpu import ensemble as je
from physicsbasedbayesianinference_tpu_torch import constants as tc
from physicsbasedbayesianinference_tpu_torch import ensemble as te
from _torch_cpu import cpu_requested  # noqa: F401  (the CPU, asked for)


def test_constants_match():
    for name in ("NATURAL", "SI"):
        j, t = getattr(jc, name), getattr(tc, name)
        assert (j.k_B, j.G) == (t.k_B, t.G)
        assert j.beta(2.5) == t.beta(2.5)
    assert jc.solar_system_units() == jc.Constants(
        **vars(tc.solar_system_units()))
    assert (jc.AU_IN_METERS, jc.SOLAR_MASS_IN_KG, jc.DAY_IN_SECONDS) == (
        tc.AU_IN_METERS, tc.SOLAR_MASS_IN_KG, tc.DAY_IN_SECONDS)


@pytest.mark.parametrize("const", ["NATURAL", "SI"])
def test_thermal_momentum_std(const):
    mass = np.random.default_rng(0).uniform(0.1, 3.0, 7).astype(np.float32)
    j = je.thermal_momentum_std(jnp.asarray(mass), 2.5, getattr(jc, const))
    t = te.thermal_momentum_std(torch.as_tensor(mass), 2.5,
                                getattr(tc, const))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


def test_kinetic_energy_and_boltzmann_weights():
    rng = np.random.default_rng(1)
    p = rng.normal(size=(64, 5)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    u = rng.normal(size=64).astype(np.float32)
    ke_j = je.kinetic_energy(jnp.asarray(p), jnp.asarray(mass))
    ke_t = te.kinetic_energy(torch.as_tensor(p), torch.as_tensor(mass))
    np.testing.assert_allclose(ke_t.numpy(), np.asarray(ke_j), rtol=1e-6)

    js = je.new_ensemble(64, 5, mass=jnp.asarray(mass)).replace(
        p=jnp.asarray(p))
    ts = te.new_ensemble(64, 5, mass=torch.as_tensor(mass)).replace(
        p=torch.as_tensor(p))
    lw_j = je.boltzmann_log_weights(js, jnp.asarray(u), 1.7)
    lw_t = te.boltzmann_log_weights(ts, torch.as_tensor(u), 1.7)
    # values near -log(64) = -4.2: rtol 1e-6 plus 1e-6 absolute for the
    # last bit of two different logsumexp implementations
    np.testing.assert_allclose(lw_t.numpy(), np.asarray(lw_j), rtol=1e-6,
                               atol=1e-6)


def test_ensemble_state_helpers():
    st = te.new_ensemble(3, 2)
    assert (st.num_walkers, st.num_dims) == (3, 2)
    assert st.q.dtype == torch.float32 and float(st.mass) == 1.0
    q, p, m, lw = te.walker(st, 2)
    assert q.shape == (2,) and m.shape == (2,)
    with pytest.raises(IndexError):
        te.walker(st, 3)
    gen = torch.Generator().manual_seed(0)
    moved = te.sample_momenta(gen, te.sample_positions(gen, st, 2.0, 1.0))
    assert moved.q.shape == (3, 2) and not torch.equal(moved.p, st.p)
    assert torch.equal(te.velocities(moved.p, 2.0), moved.p / 2.0)
