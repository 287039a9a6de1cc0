"""Every ported potential's value and gradient against the JAX package
(analytic and autodiff on both sides), plus the attributes that route a
transition to a fused kernel. Tolerance rtol=1e-5 (float32; atol=1e-5 for
values that cancel to near zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu.ops import potentials as jp
from physicsbasedbayesianinference_tpu_torch.ops import kernels
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp
from physicsbasedbayesianinference_tpu_torch.utils import convert
from _torch_cpu import cpu, cpu_requested  # noqa: F401  (the CPU, asked for)

RNG = np.random.default_rng(42)
MEAN5 = RNG.normal(size=5).astype(np.float32)
_A = RNG.normal(size=(5, 5))
COV5 = (_A @ _A.T / 5 + 0.5 * np.eye(5)).astype(np.float32)
K5 = RNG.uniform(0.5, 2.0, 5).astype(np.float32)
MEANS = RNG.normal(size=(3, 4)).astype(np.float32) * 2


def _pairs():
    return {
        "harmonic": (jp.make_harmonic(K5), tp.make_harmonic(K5), 5),
        "std_normal": (jp.make_standard_normal(5),
                       tp.make_standard_normal(5), 5),
        "gaussian_cov": (jp.make_gaussian(MEAN5, cov=COV5),
                         tp.make_gaussian(MEAN5, cov=COV5), 5),
        "gaussian_prec_diag": (
            jp.make_gaussian(MEAN5, precision=np.diag(K5)),
            tp.make_gaussian(MEAN5, precision=np.diag(K5)), 5),
        "banana": (jp.make_banana(1.0, 10.0), tp.make_banana(1.0, 10.0), 2),
        "funnel": (jp.make_funnel(6, 2.0), tp.make_funnel(6, 2.0), 6),
        "mixture": (jp.make_gaussian_mixture(MEANS, 1.3),
                    tp.make_gaussian_mixture(MEANS, 1.3), 4),
        "no_potential": (jp.no_potential, tp.no_potential, 3),
        "nbody": (jp.make_nbody_potential(np.float32([1.0, 2.0, 0.5, 1.5]),
                                          4, softening=0.1),
                  tp.make_nbody_potential(np.float32([1.0, 2.0, 0.5, 1.5]),
                                          4, softening=0.1), 12),
    }


with cpu():  # the parameters' names, built while collecting
    _NAMES = sorted(_pairs())


@pytest.mark.parametrize("name", _NAMES)
def test_value_and_grad_match_jax(name):
    jfn, tfn, d = _pairs()[name]
    q = np.random.default_rng(d).normal(size=(16, d)).astype(np.float32)
    if name == "funnel":
        q[:, 0] = np.clip(q[:, 0], -1.5, 1.5)
    uj, gj = jax.vmap(jax.value_and_grad(jfn))(jnp.asarray(q))
    for use_analytic in (True, False):
        vg = tp.batched_value_and_grad(tfn, use_analytic=use_analytic)
        ut, gt = vg(torch.as_tensor(q))
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5,
                                   atol=1e-5)
    if jfn.analytic_grad is not None:  # JAX's closed form too
        np.testing.assert_allclose(
            tfn.analytic_grad(torch.as_tensor(q)).numpy(),
            np.asarray(jfn.analytic_grad(jnp.asarray(q))), rtol=1e-5,
            atol=1e-5)


def test_routing_attributes():
    std = tp.make_standard_normal(3)
    assert std.diag_quadratic == (1.0, 0.0) and std.device_form is None
    k, mu = tp.make_harmonic(K5).diag_quadratic
    np.testing.assert_array_equal(k.numpy(), K5)
    assert mu == 0.0
    diag = tp.make_gaussian(MEAN5, precision=np.diag(K5))
    jdiag = jp.make_gaussian(MEAN5, precision=np.diag(K5))
    for a, b in zip(diag.diag_quadratic, jdiag.diag_quadratic):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    corr = tp.make_gaussian(MEAN5, cov=COV5)
    assert corr.diag_quadratic is None
    name, (mean, prec) = corr.device_form
    assert name == "gaussian" and prec.shape == (5, 5)
    np.testing.assert_array_equal(mean.numpy(), MEAN5)
    np.testing.assert_allclose(prec.numpy() @ COV5, np.eye(5), atol=1e-5)
    name, (fp,) = tp.make_funnel(10, 3.0).device_form
    assert name == "funnel"
    np.testing.assert_array_equal(fp.numpy(), np.float32([18.0, 4.5]))
    name, (ab,) = tp.make_banana(1.0, 10.0).device_form
    assert name == "banana"
    np.testing.assert_array_equal(ab.numpy(), np.float32([1.0, 10.0]))
    name, (mu, lw, iv) = tp.make_gaussian_mixture(MEANS, 2.0).device_form
    assert name == "mixture"
    np.testing.assert_array_equal(mu.numpy(), MEANS)
    np.testing.assert_array_equal(lw.numpy(), np.zeros(3, np.float32))
    np.testing.assert_array_equal(iv.numpy(), np.float32([0.25]))
    name, (m, consts) = tp.make_nbody_potential(
        np.float32([1.0, 2.0]), 2, softening=0.5).device_form
    assert name == "nbody"
    np.testing.assert_array_equal(m.numpy(), np.float32([1.0, 2.0]))
    np.testing.assert_array_equal(consts.numpy(), np.float32([1.0, 0.25]))
    # U = 0 is the diagonal quadratic with k = 0
    assert tp.no_potential.diag_quadratic == (0.0, 0.0)
    assert tp.no_potential.device_form is None
    for fn in (tp.make_banana(), tp.make_gaussian_mixture(MEANS)):
        assert fn.diag_quadratic is None
    assert sorted(tp.builtin_potentials()) == sorted(jp.builtin_potentials())


NBODY_MASS = np.float32([1.0, 2.0, 0.5, 1.5])


def _jax_and_params(kind):
    if kind == "gaussian":
        return jp.make_gaussian(MEAN5, cov=COV5), {"mean": MEAN5,
                                                   "cov": COV5}, 5
    if kind == "funnel":
        return jp.make_funnel(7, 2.5), {"num_dims": 7, "sigma": 2.5}, 7
    if kind == "banana":
        return jp.make_banana(1.0, 10.0), {"a": 1.0, "b": 10.0}, 2
    if kind == "mixture":
        lw = np.float32([0.0, -0.5, 0.3])
        return (jp.make_gaussian_mixture(MEANS, 1.3, lw),
                {"means": MEANS, "sigma": 1.3, "log_weights": lw}, 4)
    return (jp.make_nbody_potential(NBODY_MASS, 4, softening=0.1),
            {"mass": NBODY_MASS, "num_bodies": 4, "softening": 0.1}, 12)


@pytest.mark.parametrize("kind", ["gaussian", "funnel", "banana",
                                  "mixture", "nbody"])
def test_device_forms_evaluate_the_potential(kind):
    """What the generic kernel evaluates (its plain version) is the
    potential itself, against JAX autodiff."""
    jfn, params, d = _jax_and_params(kind)
    tfn = convert.potential_params_from_numpy(kind, params)
    q = np.random.default_rng(3).normal(size=(32, d)).astype(np.float32)
    uj, gj = jax.vmap(jax.value_and_grad(jfn))(jnp.asarray(q))
    ut, gt = kernels.device_value_and_grad(tfn.device_form)(
        torch.as_tensor(q))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-5)


def test_nbody_energy_and_accelerations():
    x = np.random.default_rng(5).normal(size=(6, 3)).astype(np.float32)
    m = np.random.default_rng(6).uniform(0.5, 2.0, 6).astype(np.float32)
    for soft in (0.0, 0.05):
        ej = jp.nbody_potential_energy(jnp.asarray(x), jnp.asarray(m),
                                       softening=soft)
        et = tp.nbody_potential_energy(torch.as_tensor(x),
                                       torch.as_tensor(m), softening=soft)
        np.testing.assert_allclose(float(et), float(ej), rtol=1e-5)
        aj = jp.nbody_accelerations(jnp.asarray(x), jnp.asarray(m),
                                    softening=soft)
        at = tp.nbody_accelerations(torch.as_tensor(x), torch.as_tensor(m),
                                    softening=soft)
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5,
                                   atol=1e-5)
