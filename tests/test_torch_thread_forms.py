"""The funnel and N-body forms of kernels B and D, which run one walker a
thread (``csrc/thread_layout.cu``) up to their limits: their plain versions
(``kernels._funnel_vg``, ``_funnel_model_vg``, ``_nbody_vg``, which the
kernels' arithmetic follows term for term in both walker layouts) against
the JAX package's potentials on the same numpy inputs; a float32 emulation
of the thread layout's pair-once N-body order, bitwise the plain version;
the layout chooser at each new limit; and the layouts forced on the CPU.

Tolerances, float32:
* the funnel forms, value and gradient rtol=1e-4, atol=1e-5 (found up to
  2e-7 relative in the value and 1.5e-5 absolute in gradients of size
  10-100: e^-v x_j with v < 0);
* the N-body form, value rtol=1e-5 (found 2.3e-7: the JAX side takes
  ``lax.rsqrt`` and sums over the pairs in another order), gradient within
  1e-4 |g| + 1e-5 max_k |g_k| of the walker (found 4.8e-7 of the largest
  component: a body's partner terms cancel, so a small component carries
  the rounding of the large terms, up to 6e-4 of itself).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import models as jm
from physicsbasedbayesianinference_tpu.ops import potentials as jp
from physicsbasedbayesianinference_tpu_torch import models as tm
from physicsbasedbayesianinference_tpu_torch.ops import kernels as tk
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp

TOL = dict(rtol=1e-4, atol=1e-5)


def _assert_nbody_close(u, g, ju, jg):
    np.testing.assert_allclose(u, ju, rtol=1e-5, atol=0.0)
    scale = np.abs(jg).max(axis=1, keepdims=True)
    assert (np.abs(g - jg) <= 1e-4 * np.abs(jg) + 1e-5 * scale).all()


@pytest.mark.parametrize("d", [2, 10, 16])
def test_funnel_plain_matches_jax_make_funnel(d):
    q = np.random.default_rng(d).normal(size=(64, d)).astype(np.float32)
    ju, jg = jp.batched_value_and_grad(jp.make_funnel(d))(jnp.asarray(q))
    form = tp.make_funnel(d, device="cpu").device_form
    assert form[0] == "funnel"
    fu, fg = tk.device_value_and_grad(form)(torch.as_tensor(q))
    np.testing.assert_allclose(fu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(fg.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("dim", [15, 9])
def test_funnel_model_plain_matches_both_dsl_potentials(dim):
    """``models.examples.funnel`` (``dim`` x's: D = 16, the driven shape,
    and 10) through its ``funnel_model`` form, against the DSL potentials
    of the JAX package and of the port, in and out of the neck."""
    jmp = jm.make_model_potential(jm.examples.funnel, (), {"dim": dim})
    tmp = tm.make_model_potential(tm.funnel, (), {"dim": dim}, device="cpu")
    form = tmp.potential.device_form
    assert form[0] == "funnel_model" and tmp.num_dims == dim + 1
    rng = np.random.default_rng(dim)
    q = rng.normal(size=(64, dim + 1)).astype(np.float32)
    q[:, 0] = np.linspace(-4.0, 4.0, 64)  # v through the neck
    fu, fg = tk.device_value_and_grad(form)(torch.as_tensor(q))
    tu, tg = tp.batched_value_and_grad(tmp.potential)(torch.as_tensor(q))
    ju, jg = jp.batched_value_and_grad(jmp.potential)(jnp.asarray(q))
    for u, g in ((tu.numpy(), tg.numpy()), (np.asarray(ju), np.asarray(jg))):
        np.testing.assert_allclose(fu.numpy(), u, **TOL)
        np.testing.assert_allclose(fg.numpy(), g, **TOL)


def _nbody_case(n, s, eps):
    rng = np.random.default_rng(100 * n + 10 * s + int(10 * eps))
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    q = (2.0 * rng.normal(size=(64, n * s))).astype(np.float32)
    form = tp.make_nbody_potential(mass, n, s, softening=eps,
                                   device="cpu").device_form
    return mass, q, form


@pytest.mark.parametrize("eps", [0.0, 0.3])
@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_nbody_plain_matches_jax_make_nbody_potential(n, s, eps):
    mass, q, form = _nbody_case(n, s, eps)
    jpot = jp.make_nbody_potential(jnp.asarray(mass), n, s, softening=eps)
    ju, jg = jp.batched_value_and_grad(jpot)(jnp.asarray(q))
    fu, fg = tk.device_value_and_grad(form)(torch.as_tensor(q))
    _assert_nbody_close(fu.numpy(), fg.numpy(), np.asarray(ju),
                        np.asarray(jg))


def _pairs_once(form, q):
    """The thread layout's N-body order (csrc/forms.cuh NbodyThreadForm)
    in float32 torch: the pairs i < j once each, i outer; a pair's inverse
    distance serves both bodies, body j taking the pair's displacement
    negated."""
    mass, consts = form[1]
    big_g, eps2 = consts[0], consts[1]
    w, d = q.shape
    n = mass.shape[0]
    x = q.reshape(w, n, d // n)
    acc = [torch.zeros(w, d // n) for _ in range(n)]
    row = [torch.zeros(w) for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            r = x[:, j] - x[:, i]
            d2 = torch.zeros(w)
            for c in range(d // n):
                d2 = d2 + r[:, c] * r[:, c]
            inv = 1.0 / tk._sqrt_rn(d2 + eps2)
            inv3 = inv * inv * inv
            acc[i] = acc[i] + (mass[j] * inv3)[:, None] * r
            acc[j] = acc[j] + (mass[i] * inv3)[:, None] * -r
            row[i] = row[i] + mass[j] * inv
            row[j] = row[j] + mass[i] * inv
    total = torch.zeros(w)
    for i in range(n):
        total = total + mass[i] * row[i]
    g = torch.stack([-mass[i] * (big_g * acc[i]) for i in range(n)], 1)
    return -0.5 * big_g * total, g.reshape(w, d)


@pytest.mark.parametrize("n,s,eps", [(2, 2, 0.0), (3, 3, 0.3), (8, 3, 0.3),
                                     (8, 3, 0.0), (12, 2, 0.5),
                                     (7, 3, 0.0), (1, 3, 0.3)])
def test_pair_once_order_gives_the_plain_versions_bits(n, s, eps):
    """Each pair once, both bodies from one inverse distance: every term
    and every partial sum is the plain version's (which takes all n^2
    ordered pairs), since (x_i - x_j)^2 rounds as (x_j - x_i)^2 and each
    body still takes its partners in increasing order."""
    _, q, form = _nbody_case(n, s, eps)
    qt = torch.as_tensor(q)
    eu, eg = _pairs_once(form, qt)
    pu, pg = tk.device_value_and_grad(form)(qt)
    assert torch.equal(eu, pu) and torch.equal(eg, pg)


def test_sqrt_rn_is_the_correctly_rounded_root():
    """The plain N-body version's root rounds as the card's ``sqrtf``:
    correctly, unlike the CPU's vectorised float32 ``torch.sqrt``."""
    x = torch.rand(1 << 16, generator=torch.Generator().manual_seed(0)) * 50
    want = torch.sqrt(x.double()).float()
    assert torch.equal(tk._sqrt_rn(x), want)
    assert torch.equal(tk._sqrt_rn(x.double()), torch.sqrt(x.double()))


LIMITS = {"funnel": 16, "funnel_model": 16, "nbody": 24}


@pytest.mark.parametrize("kernel", ["B", "D"])
@pytest.mark.parametrize("name", sorted(LIMITS))
def test_walker_layout_of_the_new_forms_at_their_limits(name, kernel):
    limit = LIMITS[name]
    assert tk.THREAD_LAYOUT_DIMS[name, kernel] == limit
    space = dict(space_dims=3) if name == "nbody" else {}
    for d, want in ((1, "thread"), (10, "thread"), (limit, "thread"),
                    (limit + 1, "group"), (tk.MAX_GENERIC_DIMS, "group")):
        assert tk.walker_layout(name, d, kernel, **space) == want, d
    if name == "nbody":
        mass = torch.ones(8)
        assert tk.form_layout(("nbody", (mass,)), 24, kernel) == "thread"
        assert tk.form_layout(("nbody", (mass,)), 16, kernel) == "thread"
        # 8 bodies in 4-D and on a line: the lane groups
        assert tk.form_layout(("nbody", (mass,)), 32, kernel) == "group"
        assert tk.form_layout(("nbody", (mass,)), 8, kernel) == "group"
        # 13 bodies in 2-D: one past the limit
        assert tk.form_layout(("nbody", (torch.ones(13),)), 26,
                              kernel) == "group"


def _cpu_form(name, d):
    if name == "funnel":
        return tp.make_funnel(d, device="cpu").device_form
    if name == "funnel_model":
        return tm.make_model_potential(tm.funnel, (), {"dim": d - 1},
                                       device="cpu").potential.device_form
    return tp.make_nbody_potential(torch.linspace(0.5, 1.5, d // 3), d // 3,
                                   softening=0.3, device="cpu").device_form


@pytest.mark.parametrize("name,d", [("funnel", 10), ("funnel_model", 16),
                                    ("nbody", 24)])
def test_forced_layouts_on_cpu_run_the_plain_version_of_the_new_forms(name,
                                                                      d):
    """On CPU tensors every layout the hook may force runs the plain
    version (the same bits, no kernel counted); forcing the thread layout
    past the form's limit raises before anything runs."""
    form = _cpu_form(name, d)
    q = torch.as_tensor(np.random.default_rng(d).normal(
        size=(40, d)).astype(np.float32))
    u, g = tk.device_value_and_grad(form)(q)
    im = torch.linspace(0.5, 2.0, d)
    kw = dict(scalars=torch.tensor([0.05, 1.0, 1.0]),
              p_std=torch.sqrt(1.0 / im), inv_mass=im, num_steps=4)
    before = (dict(tk.fused_hmc_transition.launches_by_layout),
              dict(tk.leapfrog_trajectory.launches_by_layout))
    want = tk.fused_hmc_transition_plain(form, 3, 1, q, u, g, **kw)
    for layout in (None, "thread", "group"):
        got = tk.fused_hmc_transition(form, 3, 1, q, u, g, _layout=layout,
                                      **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    lk = dict(step_size=torch.tensor([0.05]), num_steps=3, inv_mass=im)
    want = tk.leapfrog_trajectory_plain(form, q, q, **lk)
    for layout in (None, "thread", "group"):
        for a, b in zip(tk.leapfrog_trajectory(form, q, q, _layout=layout,
                                               **lk), want):
            assert torch.equal(a, b)
    wide_d = LIMITS[name] + (3 if name == "nbody" else 1)
    wide_form = _cpu_form(name, wide_d)
    wide = torch.zeros(4, wide_d)
    with pytest.raises(ValueError, match="no thread layout"):
        tk.leapfrog_trajectory(wide_form, wide, wide, _layout="thread",
                               **{**lk, "inv_mass": torch.ones(wide_d)})
    with pytest.raises(ValueError, match="no thread layout"):
        tk.fused_hmc_transition(
            wide_form, 3, 1, wide, torch.zeros(4), wide, _layout="thread",
            **{**kw, "inv_mass": torch.ones(wide_d),
               "p_std": torch.ones(wide_d)})
    assert (tk.fused_hmc_transition.launches_by_layout,
            tk.leapfrog_trajectory.launches_by_layout) == before
