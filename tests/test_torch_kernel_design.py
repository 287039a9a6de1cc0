"""What the CPU can check of the redesigned kernels E and A: the host side
of kernel E's layout (``nbody_split``, the split summation order) and the
shapes that take kernel A's other code paths (a scalar tail, D > 128,
every walker rejected), through the plain versions.

Kernel E: per body and component |a - a_ref| <= C u sqrt(N) S_i with u the
dtype's unit roundoff, S_i the sum of the magnitudes of a_i's terms
(``kernels.nbody_abs_sum``) and C = 4: a change of summation order, the
first part of the bound the CUDA kernel is held to on the card
(``kernels.nbody_bound``). The reference is the
unsplit plain version, the JAX Pallas kernel in interpret mode (float32)
and the JAX XLA form (float64, which the Pallas kernel does not take).

Kernel A: from rest (``p_std = 0``) nothing depends on a random stream, so
energy_error, accept_prob, q', u', g' are compared elementwise at
rtol=atol=1e-5 (float32, sums in another order) with the JAX Pallas kernel
in interpret mode where it runs (D | 128) and with the JAX leapfrog
otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu.ops import integrators as ji
from physicsbasedbayesianinference_tpu.ops import pallas_kernels as jk
from physicsbasedbayesianinference_tpu.ops import potentials as jp
from physicsbasedbayesianinference_tpu_torch.ops import kernels as tk

pytestmark = pytest.mark.skipif(
    jax.default_backend() == "tpu",
    reason="the JAX side runs the Pallas kernels in interpret mode")

TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Kernel E: the split chooser and the split summation order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,want", [(1, 32), (100, 32), (1000, 32),
                                    (4096, 32), (16384, 8), (1 << 17, 1),
                                    (1 << 18, 1), (1 << 20, 1)])
def test_nbody_split_values(n, want):
    split = tk.nbody_split(n)
    assert split == want
    assert 1 <= split <= 32 and split & (split - 1) == 0


def test_nbody_split_fills_the_card_and_never_grows_with_n():
    # 2^17 threads (half of 132 SMs x 2048, rounded down) from N = 4096 on
    for n in (4096, 5000, 16384, 50000):
        assert n * tk.nbody_split(n) >= 1 << 17
    sizes = [1, 2, 3, 100, 1000, 4095, 4096, 4097, 8191, 8192, 8193, 16384,
             16385, 40000, 65536, 100000, 1 << 17, (1 << 17) + 1, 1 << 18]
    splits = [tk.nbody_split(n) for n in sizes]
    assert all(a >= b for a, b in zip(splits, splits[1:]))
    with pytest.raises(ValueError, match="at least one body"):
        tk.nbody_split(0)


def _bodies(n, seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(dtype)
    x[n // 2] = 0.0  # a body at the origin
    return x, rng.uniform(0.5, 2.0, n).astype(dtype)


def _ratio(a, ref, x, m, softening, g_const=1.0):
    """max |a - ref| / (u sqrt(N) S_i)."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(a).all()
    scale = tk.nbody_abs_sum(torch.as_tensor(x), torch.as_tensor(m),
                             g_const=g_const, softening=softening).numpy()
    u = np.finfo(x.dtype).eps / 2
    return (np.abs(a - ref) / (u * np.sqrt(x.shape[0])
                               * scale[:, None])).max()


@pytest.mark.parametrize("n", [100, 129, 1000])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("split", [1, 8, 32])
def test_split_order_plain_within_bound_of_plain_and_jax(n, dtype, split):
    x, m = _bodies(n, n, dtype)
    xt, mt = torch.as_tensor(x), torch.as_tensor(m)
    kw = dict(g_const=1.0, softening=0.05)
    ordered = tk.nbody_accelerations_tiled_plain(xt, mt, split=split, **kw)
    assert ordered.dtype == xt.dtype
    plain = tk.nbody_accelerations_tiled_plain(xt, mt, **kw)
    assert _ratio(ordered.numpy(), plain.numpy(), x, m, 0.05) <= 4.0
    if dtype == np.float32:
        ref = jk.nbody_accelerations_pallas(jnp.asarray(x), jnp.asarray(m),
                                            softening=0.05, block=128)
    else:
        old = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
        try:
            ref = np.asarray(jp.nbody_accelerations(
                jnp.asarray(x), jnp.asarray(m), softening=0.05))
        finally:
            jax.config.update("jax_enable_x64", old)
        assert ref.dtype == np.float64
    assert _ratio(ordered.numpy(), ref, x, m, 0.05) <= 4.0


def test_split_order_is_a_reordering_of_the_same_terms():
    """In float64 with terms that are exact in binary (powers of two), any
    order gives the same sum: the split order loses and repeats no
    source, ragged tail included."""
    n = 300
    terms = torch.zeros(2, n, 3, dtype=torch.float64)
    terms[0, :, 0] = torch.arange(1, n + 1, dtype=torch.float64)
    terms[1, :, 2] = 2.0 ** -torch.arange(n, dtype=torch.float64).remainder(40)
    for split in (1, 2, 4, 8, 16, 32):
        got = tk._sum_in_kernel_order(terms, split)
        assert torch.equal(got, terms.sum(dim=1))


def test_split_must_be_a_power_of_two_up_to_32():
    x, m = (torch.as_tensor(a) for a in _bodies(10, 0, np.float32))
    for bad in (0, 3, 64):
        with pytest.raises(ValueError, match="power of two"):
            tk.nbody_accelerations_tiled(x, m, g_const=1.0, softening=0.1,
                                         split=bad)
    a = tk.nbody_accelerations_tiled(x, m, g_const=1.0, softening=0.1,
                                     split=4)
    b = tk.nbody_accelerations_tiled_plain(x, m, g_const=1.0, softening=0.1,
                                           split=4)
    assert torch.equal(a, b)  # the CPU wrapper hands the split on


# ---------------------------------------------------------------------------
# Kernel A: shapes off the 16-byte path, D > 128, every walker rejected
# ---------------------------------------------------------------------------

A_ORDER = ("q", "g", "u", "accept_prob", "accepted", "energy_error")


def _diag_inputs(w, d, seed):
    rng = np.random.default_rng(seed)
    return dict(q=rng.normal(size=(w, d)).astype(np.float32),
                k=rng.uniform(0.5, 2.0, d).astype(np.float32),
                mu=rng.normal(size=d).astype(np.float32),
                im=rng.uniform(0.5, 2.0, d).astype(np.float32))


def _plain_from_rest(a, step, beta, steps, threshold=1000.0, scale=1.0):
    d = a["q"].shape[1]
    out = tk.fused_hmc_diag_quadratic_plain(
        5, 0, torch.as_tensor(a["q"]),
        scalars=torch.tensor([step, beta, scale]), p_std=torch.zeros(d),
        inv_mass=torch.as_tensor(a["im"]), k_diag=torch.as_tensor(a["k"]),
        mean=torch.as_tensor(a["mu"]), num_steps=steps,
        divergence_threshold=threshold)
    return dict(zip(A_ORDER, (x.numpy() for x in out)))


@pytest.mark.parametrize("d", [3, 5, 33, 200])
def test_diag_plain_from_rest_matches_jax_leapfrog(d):
    """D that the JAX kernel A does not take (it needs D | 128): the JAX
    leapfrog from p = 0 gives the trajectory, H1 - H0 the decision."""
    w, steps, step, beta = 48, 6, 0.2, 1.3
    a = _diag_inputs(w, d, d)
    t = _plain_from_rest(a, step, beta, steps)
    vg = jp.batched_value_and_grad(
        jp.make_gaussian(a["mu"], precision=np.diag(a["k"])))
    q1, p1, u1, g1 = (np.asarray(x) for x in ji.get_integrator("leapfrog")(
        vg, jnp.asarray(a["q"]), jnp.zeros((w, d), jnp.float32),
        step_size=jnp.float32(step), num_steps=steps,
        inv_mass=jnp.asarray(a["im"])))
    u0 = np.asarray(vg(jnp.asarray(a["q"]))[0])
    derr = beta * (0.5 * np.sum(p1 * p1 * a["im"], axis=1) + u1 - u0)
    np.testing.assert_allclose(t["energy_error"], derr, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t["accept_prob"],
                               np.exp(np.minimum(0.0, -derr)), **TOL)
    acc = t["accepted"]
    assert acc.mean() > 0.5
    np.testing.assert_allclose(t["q"][acc], q1[acc], **TOL)
    np.testing.assert_allclose(t["g"][acc], g1[acc], **TOL)
    np.testing.assert_allclose(t["u"][acc], u1[acc], **TOL)
    assert np.array_equal(t["q"][~acc], a["q"][~acc])


@pytest.mark.parametrize("d", [4, 32])
def test_diag_plain_rejecting_every_walker_matches_pallas(d):
    """A threshold under every energy error: q' is q bit for bit, g' and u'
    are those of q, accept_prob is 0, on both sides."""
    w, steps, step, beta = 128, 4, 0.2, 1.3
    a = _diag_inputs(w, d, 100 + d)
    t = _plain_from_rest(a, step, beta, steps, threshold=-1e30)
    jout = jk.make_fused_hmc_diag_quadratic(
        num_steps=steps, divergence_threshold=-1e30)(
        jnp.int32(5), jnp.asarray(a["q"]), step_size=jnp.float32(step),
        p_std=0.0, inv_mass=jnp.asarray(a["im"]), beta=beta,
        k_diag=jnp.asarray(a["k"]), mean=jnp.asarray(a["mu"]))
    j = dict(zip(A_ORDER, (np.asarray(x) for x in jout)))
    assert not t["accepted"].any() and not j["accepted"].any()
    assert np.array_equal(t["q"], a["q"]) and np.array_equal(j["q"], a["q"])
    assert (t["accept_prob"] == 0).all() and (j["accept_prob"] == 0).all()
    np.testing.assert_allclose(t["energy_error"], j["energy_error"], **TOL)
    np.testing.assert_allclose(t["g"], j["g"], **TOL)
    np.testing.assert_allclose(t["u"], j["u"], **TOL)


@pytest.mark.parametrize("d", [3, 33, 200])
def test_diag_plain_rejecting_every_walker_returns_the_start(d):
    a = _diag_inputs(40, d, 200 + d)
    t = _plain_from_rest(a, 0.2, 1.0, 5, threshold=-1e30)
    qc = a["q"] - a["mu"]
    assert not t["accepted"].any()
    assert np.array_equal(t["q"], a["q"])
    np.testing.assert_allclose(t["g"], a["k"] * qc, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t["u"], 0.5 * np.sum(a["k"] * qc * qc, 1),
                               rtol=1e-5)
    assert (t["accept_prob"] == 0).all()
