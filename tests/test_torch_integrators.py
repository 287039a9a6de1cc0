"""Every splitting integrator's trajectory against the JAX package from the
same (q, p): rtol=1e-5 after 16 steps (float32, a correlated Gaussian
force, so every coordinate is coupled)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu.ops import integrators as ji
from physicsbasedbayesianinference_tpu.ops import potentials as jp
from physicsbasedbayesianinference_tpu_torch.ops import integrators as ti
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp
from _torch_cpu import cpu_requested  # noqa: F401  (the CPU, asked for)

NAMES = ["leapfrog", "velocity_verlet", "position_verlet", "mclachlan",
         "yoshida4", "stormer_verlet"]


def _setup(d=4, w=32):
    rng = np.random.default_rng(7)
    mean = rng.normal(size=d).astype(np.float32)
    a = rng.normal(size=(d, d))
    cov = (a @ a.T / d + 0.5 * np.eye(d)).astype(np.float32)
    q = rng.normal(size=(w, d)).astype(np.float32)
    p = rng.normal(size=(w, d)).astype(np.float32)
    inv_mass = rng.uniform(0.5, 1.5, d).astype(np.float32)
    return (jp.batched_value_and_grad(jp.make_gaussian(mean, cov=cov)),
            tp.batched_value_and_grad(tp.make_gaussian(mean, cov=cov)),
            q, p, inv_mass)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("per_walker_step", [False, True])
def test_trajectory_matches_jax(name, per_walker_step):
    vg_j, vg_t, q, p, inv_mass = _setup()
    step = (np.linspace(0.05, 0.15, q.shape[0], dtype=np.float32)[:, None]
            if per_walker_step else np.float32(0.1))
    out_j = ji.get_integrator(name)(
        vg_j, jnp.asarray(q), jnp.asarray(p), step_size=jnp.asarray(step),
        num_steps=16, inv_mass=jnp.asarray(inv_mass))
    out_t = ti.get_integrator(name)(
        vg_t, torch.as_tensor(q), torch.as_tensor(p),
        step_size=torch.as_tensor(step), num_steps=16,
        inv_mass=torch.as_tensor(inv_mass))
    for a, b in zip(out_t, out_j):  # q, p, U, grad
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert (ti.get_integrator(name).grad_evals_per_step
            == ji.get_integrator(name).grad_evals_per_step)


def test_cached_gradient_is_used_and_registry():
    vg_j, vg_t, q, p, inv_mass = _setup()
    u, g = vg_t(torch.as_tensor(q))
    a = ti.leapfrog(vg_t, torch.as_tensor(q), torch.as_tensor(p),
                    step_size=0.1, num_steps=3,
                    inv_mass=torch.as_tensor(inv_mass), grad=g,
                    potential_energy=u)
    b = ti.leapfrog(vg_t, torch.as_tensor(q), torch.as_tensor(p),
                    step_size=0.1, num_steps=3,
                    inv_mass=torch.as_tensor(inv_mass))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert set(ti.INTEGRATORS) == set(ji.INTEGRATORS)
    assert ti.INTEGRATORS["pallas_leapfrog"].grad_evals_per_step == 1
    with pytest.raises(ValueError, match="available"):
        ti.get_integrator("rk4")
    with pytest.raises(ValueError, match="sum to"):
        ti.make_splitting_integrator([("K", 0.5), ("D", 1.0)])
    assert ti.num_steps_for_time(1.0, 0.0999) == ji.num_steps_for_time(
        1.0, 0.0999)
