"""The model device forms (``"logistic"``, ``"eight_schools_nc"`` and the
example models' ``"linear"``, ``"eight_schools"``, ``"coin"``,
``"funnel_model"``, and the ``reparam="auto"`` routes to
``"eight_schools_nc"`` and ``"diag_model"``): their plain versions, which
sum in the CUDA kernels' order, against the DSL potentials of the port
(``vmap(grad_and_value)``) and of the JAX package
(``batched_value_and_grad``) on the same numpy inputs, and the registry
that attaches them.

Tolerance: value and gradient rtol=1e-4, atol=1e-5, float32 (found: up to
2e-5 relative in the value, whose 256 likelihood terms the form sums lane
by lane; the gradients agree to about 1e-6). The linear regression's
gradient is a sum over the rows of terms far larger than itself where q
is off the posterior (terms of 10^3, sums of 10^-1 here), so its
tolerance adds 8 u S_k, with u = 2^-24 and S_k the sum of the magnitudes
of component k's terms (the two sides round r_n / sigma^2 differently:
found up to 4.1 u S_k).

A ChEES run on the CPU for each new route (``test_fused_chees_on_cpu_*``):
the fused engine (the kernels' plain versions) against the composed engine
on the same model, each from its own draws, moments within Monte-Carlo
error (limits stated there)."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import models as jm
from physicsbasedbayesianinference_tpu.ops import potentials as jp
from physicsbasedbayesianinference_tpu_torch import models as tm
from physicsbasedbayesianinference_tpu_torch.models import core as tcore
from physicsbasedbayesianinference_tpu_torch.models import distributions as td
from physicsbasedbayesianinference_tpu_torch.ops import kernels as tk
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp

TOL = dict(rtol=1e-4, atol=1e-5)
ROOT = Path(__file__).resolve().parent.parent


def _logistic(n, p):
    x, y = tm.logistic_regression_data(n, p)
    jmp = jm.make_model_potential(jm.examples.logistic_regression,
                                  (jnp.asarray(x), jnp.asarray(y)), {})
    tmp = tm.make_model_potential(tm.logistic_regression, (x, y), {},
                                  device="cpu")
    return jmp, tmp, 0.3


def _eight_schools():
    data = tm.EIGHT_SCHOOLS_DATA
    jmp = jm.make_model_potential(
        jm.examples.eight_schools_noncentered, (),
        {"J": 8, "sigma": jnp.asarray(data["sigma"]),
         "y": jnp.asarray(data["y"])})
    tmp = tm.make_model_potential(tm.eight_schools_noncentered, (), data,
                                  device="cpu")
    return jmp, tmp, 1.0


def _linear(n, p):
    x, y = tm.linear_regression_data(n, p)
    jmp = jm.make_model_potential(jm.examples.linear_regression,
                                  (jnp.asarray(x), jnp.asarray(y)), {})
    tmp = tm.make_model_potential(tm.linear_regression, (x, y), {},
                                  device="cpu")
    return jmp, tmp, 0.3


def _eight_schools_centred(reparam=None):
    data = tm.EIGHT_SCHOOLS_DATA
    jmp = jm.make_model_potential(
        jm.examples.eight_schools, (),
        {"J": 8, "sigma": jnp.asarray(data["sigma"]),
         "y": jnp.asarray(data["y"])}, reparam=reparam)
    tmp = tm.make_model_potential(tm.eight_schools, (), data, device="cpu",
                                  reparam=reparam)
    return jmp, tmp, 1.0


def coin_data():
    """``examples/coin_toss.data.json``'s two coins, float32 numpy."""
    with open(ROOT / "examples" / "coin_toss.data.json") as f:
        raw = json.load(f)
    return {k: np.asarray(raw[k], np.float32) for k in ("c1", "c2")}


def _coin():
    data = coin_data()
    jmp = jm.make_model_potential(
        jm.examples.coin_toss, (),
        {k: jnp.asarray(v) for k, v in data.items()})
    tmp = tm.make_model_potential(tm.coin_toss, (), data, device="cpu")
    return jmp, tmp, 1.0


def _funnel(reparam=None):
    jmp = jm.make_model_potential(jm.examples.funnel, (), {},
                                  reparam=reparam)
    tmp = tm.make_model_potential(tm.funnel, (), {}, device="cpu",
                                  reparam=reparam)
    return jmp, tmp, 1.0


CASES = {
    "logistic N=256 D=32": lambda: _logistic(256, 31),
    "logistic N=7 D=6": lambda: _logistic(7, 5),
    "logistic N=40 D=34": lambda: _logistic(40, 33),
    "eight_schools_nc D=10": _eight_schools,
    "linear N=256 D=32": lambda: _linear(256, 30),
    "linear N=7 D=6": lambda: _linear(7, 4),
    "linear N=40 D=35": lambda: _linear(40, 33),
    "eight_schools D=10": _eight_schools_centred,
    "eight_schools_nc (eight_schools reparam=auto) D=10":
        lambda: _eight_schools_centred("auto"),
    "coin D=2": _coin,
    "funnel_model D=16": _funnel,
    "diag_model (funnel reparam=auto) D=16": lambda: _funnel("auto"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_form_matches_both_dsl_potentials(case):
    jmp, tmp, spread = CASES[case]()
    form = tmp.potential.device_form
    assert form is not None and form[0] == case.split()[0]
    assert tk.generic_unsupported(form, tmp.num_dims) is None
    assert tk.leapfrog_unsupported(form, tmp.num_dims) is None
    q = (spread * np.random.default_rng(2).normal(
        size=(33, tmp.num_dims))).astype(np.float32)
    fu, fg = tk.device_value_and_grad(form)(torch.as_tensor(q))
    tu, tg = tp.batched_value_and_grad(tmp.potential)(torch.as_tensor(q))
    ju, jg = jp.batched_value_and_grad(jmp.potential)(jnp.asarray(q))
    for u, g in ((tu.numpy(), tg.numpy()), (np.asarray(ju), np.asarray(jg))):
        np.testing.assert_allclose(fu.numpy(), u, **TOL)
        if form[0] == "linear":
            bound = (TOL["atol"] + TOL["rtol"] * np.abs(g)
                     + 8 * 2.0**-24 * _linear_term_sums(form, q))
            assert (np.abs(fg.numpy() - g) <= bound).all()
        else:
            np.testing.assert_allclose(fg.numpy(), g, **TOL)


def _linear_term_sums(form, q):
    """S_k of the linear form's gradient at q, in float64: sum_n |r_n x_nk|
    / sigma^2 + |q_k| / prior^2 for the weights and the bias, and the sum
    of the magnitudes of the noise scale's four terms."""
    x, y, consts = (t.numpy().astype(np.float64) for t in form[1])
    q = q.astype(np.float64)
    n, p = x.shape
    s = q[:, -1]
    r = q[:, :p] @ x.T + q[:, p:p + 1] - y
    xa = np.concatenate([x, np.ones((n, 1)), np.zeros((n, 1))], 1)
    sums = (np.abs(r) * np.exp(-2 * s)[:, None]) @ np.abs(xa) \
        + np.abs(q) * consts[0]
    sums[:, -1] = np.exp(2 * s) + 1 + n + np.exp(-2 * s) * (r * r).sum(1)
    return sums


def test_forms_are_attached_by_model_function_only():
    x, y = tm.logistic_regression_data(16, 3)
    kw = dict(device="cpu")
    assert tm.make_model_potential(
        tm.logistic_regression, (x, y), {}, **kw
    ).potential.device_form[0] == "logistic"
    # data given by keyword reaches the form too
    mp = tm.make_model_potential(tm.logistic_regression, (),
                                 {"x": x, "labels": y}, **kw)
    name, (fx, fy) = mp.potential.device_form
    assert fx.shape == (16, 3) and fy.shape == (16,)
    assert fx.dtype == torch.float32 and fx.is_contiguous()
    # a reparameterised wrapper, even one that rewrites nothing
    assert tm.make_model_potential(
        tm.logistic_regression, (x, y), {}, reparam="auto", **kw
    ).potential.device_form is None
    assert tm.make_model_potential(
        tm.eight_schools_noncentered, (), tm.EIGHT_SCHOOLS_DATA,
        reparam={"theta_raw": False}, **kw).potential.device_form is None

    def subsampled(x, labels):  # the same model over a subsampled plate
        with tcore.plate("features", x.shape[-1]):
            w = tcore.sample("w", td.Normal(0.0, 1.0))
        b = tcore.sample("b", td.Normal(0.0, 1.0))
        with tcore.plate("N", x.shape[0], subsample_size=4,
                         generator=torch.Generator().manual_seed(0)) as idx:
            tcore.sample("obs", td.BernoulliLogits(x[idx] @ w + b),
                         obs=labels[idx])

    assert tm.make_model_potential(
        subsampled, (x, y), {}, **kw).potential.device_form is None
    # registered models only: the same centred eight schools written
    # anew has no form
    def eight_schools(J, sigma, y):
        mu = tcore.sample("mu", td.Normal(0.0, 5.0))
        tau = tcore.sample("tau", td.HalfCauchy(5.0))
        with tcore.plate("J", J):
            theta = tcore.sample("theta", td.Normal(mu, tau))
            tcore.sample("obs", td.Normal(theta, sigma), obs=y)

    assert tm.make_model_potential(
        eight_schools, (), tm.EIGHT_SCHOOLS_DATA, **kw
    ).potential.device_form is None
    assert tm.device_form_for(lambda: None, (), {}, "cpu") is None
    # every potential carries the three attributes the engines read
    mp = tm.make_model_potential(eight_schools, (), tm.EIGHT_SCHOOLS_DATA,
                                 **kw)
    assert (mp.potential.device_form, mp.potential.diag_quadratic,
            mp.potential.analytic_grad) == (None, None, None)


def test_reparam_forms_for_auto_only():
    """The registry sees through ``reparam="auto"`` of the two models whose
    rewrite is a known function of q (the test above holds the values);
    every other config, and "auto" of any other model, keeps None."""
    kw = dict(device="cpu")
    data = tm.EIGHT_SCHOOLS_DATA

    def form(model, reparam, args=(), kwargs=None):
        return tm.make_model_potential(
            model, args, data if kwargs is None else kwargs,
            reparam=reparam, **kw).potential.device_form

    assert form(tm.eight_schools, "auto")[0] == "eight_schools_nc"
    assert form(tm.funnel, "auto", kwargs={})[0] == "diag_model"
    for config in (["theta"], {"theta": True}, "theta", {"theta": False}):
        assert form(tm.eight_schools, config) is None, config
    for config in (["x"], {"x": True}, "x"):
        assert form(tm.funnel, config, kwargs={}) is None, config
    # a tensor scale would decentre v too: another latent space
    assert form(tm.funnel, "auto",
                kwargs={"scale": torch.tensor(3.0)}) is None
    x, y = tm.linear_regression_data(16, 3)
    assert form(tm.linear_regression, "auto", (x, y), {}) is None
    wrapped = tcore.reparametrized(tm.funnel, "auto")
    assert (wrapped.reparam_of, wrapped.reparam_config) == (tm.funnel,
                                                            "auto")


def test_form_limits_are_decided_before_any_launch():
    y8 = torch.as_tensor(tm.EIGHT_SCHOOLS_DATA["y"])
    form = ("eight_schools_nc", (y8, y8.abs() + 1.0, torch.zeros(1)))
    assert "takes D=10" in tk.generic_unsupported(form, 16)
    # N * P + N parameter floats over the staging limit
    big = ("logistic", (torch.zeros(2048, 31), torch.zeros(2048)))
    assert "exceed" in tk.generic_unsupported(big, 32)
    # few columns, many rows: under that limit, but the padded rows and the
    # block's buffers pass the card's shared memory
    wide = ("logistic", (torch.zeros(8000, 1), torch.zeros(8000)))
    assert "shared memory" in tk.generic_unsupported(wide, 2)
    # x and y (256 rows of 36 + 1 floats), the 32 lane groups' buffer rows
    # (36 floats a walker) and residual tiles (a chunk of 4 x 8 rows a
    # walker, plus 4), at walker tile 1
    assert tk.logistic_shared_bytes(256, 32) == 4 * (
        256 * 37 + 32 * 36 + 32 * (32 + 4))
    ok = ("logistic", (torch.zeros(256, 31), torch.zeros(256)))
    assert tk.generic_unsupported(ok, 32) is None
    assert "parameters" in tk.generic_unsupported(("logistic", (y8,)), 3)
    # the example models' forms
    centred = ("eight_schools", (y8, y8.abs() + 1.0, torch.zeros(1)))
    assert "takes D=10" in tk.leapfrog_unsupported(centred, 12)
    assert tk.generic_unsupported(centred, 10) is None
    big_linear = ("linear", (torch.zeros(2048, 30), torch.zeros(2048),
                             torch.zeros(2)))
    assert "exceed" in tk.generic_unsupported(big_linear, 32)
    wide_linear = ("linear", (torch.zeros(8000, 1), torch.zeros(8000),
                              torch.zeros(2)))
    assert "shared memory" in tk.generic_unsupported(wide_linear, 3)
    assert "D >= 2" in tk.generic_unsupported(
        ("linear", (torch.zeros(4, 0), torch.zeros(4), torch.zeros(2))), 1)
    coin = ("coin", (torch.ones(129), torch.ones(129)))
    assert "D <= 128" in tk.generic_unsupported(coin, 129)
    assert tk.walker_tile(102400, 32) == tk.logistic_tile(102400, 256, 32)
    # a too-large model is routed to the composed engine when it is built
    from physicsbasedbayesianinference_tpu_torch import hmc

    def potential(q):
        return 0.5 * torch.sum(q * q, dim=-1)

    potential.device_form = big
    assert hmc.resolve_engine("auto", potential,
                              torch.zeros(4, 32)) == "composed"


def test_fused_engine_on_cpu_runs_the_model_forms():
    """The CPU fused engine (the kernels' plain versions) on eight schools:
    (u, g) of the returned state are the DSL potential's at the returned
    q, and a tensor leapfrog count gives the int count's bits."""
    from physicsbasedbayesianinference_tpu_torch import hmc
    tmp = tm.make_model_potential(tm.eight_schools_noncentered, (),
                                  tm.EIGHT_SCHOOLS_DATA, device="cpu")
    fused = hmc.FusedTransition(tmp.potential)
    assert fused.variant_for(64, 10) == "generic"
    vg = tp.batched_value_and_grad(tmp.potential)
    state = hmc.init_state(vg, tmp.init(0, 64) * 0.25)
    a, info, prop = fused((3, 0), state, 0.1, num_steps=5,
                          emit_proposal=True)
    b, _, none = fused((3, 0), state, 0.1, max_steps=9,
                       num_steps=torch.tensor([5], dtype=torch.int32))
    assert none is None and torch.equal(a.ensemble.q, b.ensemble.q)
    assert 0 < int(info.accepted.sum()) <= 64
    u, g = vg(a.ensemble.q)
    np.testing.assert_allclose(a.potential_energy.numpy(), u.numpy(), **TOL)
    np.testing.assert_allclose(a.grad.numpy(), g.numpy(), **TOL)
    acc = info.accepted
    assert torch.equal(prop[0][acc], a.ensemble.q[acc])
    assert not torch.equal(prop[0][~acc], a.ensemble.q[~acc]) or \
        not bool((~acc).any())


def _schools_data(j):
    """J schools' data from numpy seed J (the Rubin data at J = 8)."""
    if j == 8:
        return tm.EIGHT_SCHOOLS_DATA
    rng = np.random.default_rng(j)
    return {"J": j, "y": (10.0 * rng.normal(size=j)).astype(np.float32),
            "sigma": rng.uniform(5.0, 20.0, j).astype(np.float32)}


SCHOOLS_MODELS = {"eight_schools_nc": "eight_schools_noncentered",
                  "eight_schools": "eight_schools"}


@pytest.mark.parametrize("j", [1, 3, 8, 14, 30])
@pytest.mark.parametrize("name", sorted(SCHOOLS_MODELS))
def test_schools_plain_forms_match_both_dsl_potentials_at_any_j(name, j):
    """Both eight-schools plain versions (the reciprocals 1 / sigma and, in
    the centred form, exp(-log tau), the kernels' arithmetic in both walker
    layouts) against the DSL potentials of the JAX package and of the
    port, at J on both sides of the thread layout's limit (J = 14, D =
    16); tolerance as the module's, rtol=1e-4, atol=1e-5."""
    data = _schools_data(j)
    model = SCHOOLS_MODELS[name]
    jmp = jm.make_model_potential(
        getattr(jm.examples, model), (),
        {"J": j, "sigma": jnp.asarray(data["sigma"]),
         "y": jnp.asarray(data["y"])})
    tmp = tm.make_model_potential(getattr(tm, model), (), data,
                                  device="cpu")
    form = tmp.potential.device_form
    assert form[0] == name and tmp.num_dims == j + 2
    assert tk.walker_layout(name, j + 2, "B") == ("thread" if j <= 14
                                                  else "group")
    assert tk.walker_layout(name, j + 2, "D") == (
        "thread" if j <= (14 if name == "eight_schools_nc" else 10)
        else "group")
    q = np.random.default_rng(100 + j).normal(
        size=(33, j + 2)).astype(np.float32)
    fu, fg = tk.device_value_and_grad(form)(torch.as_tensor(q))
    tu, tg = tp.batched_value_and_grad(tmp.potential)(torch.as_tensor(q))
    ju, jg = jp.batched_value_and_grad(jmp.potential)(jnp.asarray(q))
    for u, g in ((tu.numpy(), tg.numpy()), (np.asarray(ju), np.asarray(jg))):
        np.testing.assert_allclose(fu.numpy(), u, **TOL)
        np.testing.assert_allclose(fg.numpy(), g, **TOL)


# the thread layout's dim limit of each form in kernels B and D
THREAD_LIMITS = {("eight_schools_nc", "B"): 16, ("eight_schools_nc", "D"): 16,
                 ("eight_schools", "B"): 16, ("eight_schools", "D"): 12,
                 ("funnel", "B"): 16, ("funnel", "D"): 16,
                 ("funnel_model", "B"): 16, ("funnel_model", "D"): 16,
                 ("nbody", "B"): 24, ("nbody", "D"): 24,
                 ("mixture", "B"): 16, ("mixture", "D"): 16}


@pytest.mark.parametrize("name", sorted(tk.FORM_IDS))
def test_walker_layout_is_chosen_from_the_form_and_d_alone(name):
    """The thread layout for the eight-schools and funnel forms up to D =
    16 (the centred eight schools' kernel D up to 12), the mixture of up
    to 2 components up to D = 16 and the N-body form in 2 or 3 space dims
    up to D = 24, the lane-group layout above it and for every other form:
    a choice from the form, D and the kernel alone (the N-body form's space
    dims are D over its bodies, the mixture's components the rows of its
    means). A forced layout is checked before any launch (CPU tensors: the
    plain version runs, and no kernel is counted)."""
    thread = name in tk.THREAD_FORMS
    assert thread == any(form == name for form, _ in THREAD_LIMITS)
    for kernel in ("B", "D"):
        limit = THREAD_LIMITS.get((name, kernel), 0)
        assert tk.THREAD_LAYOUT_DIMS.get((name, kernel), 0) == limit
        for d in range(1, tk.MAX_GENERIC_DIMS + 1):
            want = "thread" if d <= limit else "group"
            if name == "nbody":
                for space in (1, 2, 3, 4):
                    assert tk.walker_layout(name, d, kernel, space) == (
                        want if space in (2, 3) else "group"), (kernel, d)
            elif name == "mixture":
                for k in (1, 2, 3, 5, 8, 9, 16):
                    assert tk.walker_layout(name, d, kernel,
                                            components=k) == (
                        want if k <= 2 else "group"), (kernel, d, k)
            else:
                assert tk.walker_layout(name, d, kernel) == want, (kernel, d)
        # ten dims: 5 bodies in 2-D, a mixture of 2 components
        form = ((name, (torch.ones(5),)) if name == "nbody"
                else (name, (torch.zeros(2, 10),)) if name == "mixture"
                else (name, ()))
        assert tk._layout_for(form, 10, kernel, None) == (
            "thread" if thread else "group")
        assert tk.form_layout(form, 10, kernel) == (
            "thread" if thread else "group")
        assert tk._layout_for(form, 10, kernel, "group") == "group"
        with pytest.raises(ValueError, match="no thread layout"):
            tk._layout_for(form, limit + 1, kernel, "thread")
        with pytest.raises(ValueError, match="layout must be one of"):
            tk._layout_for(form, 10, kernel, "lanes")
        if not thread:
            with pytest.raises(ValueError, match="no thread layout"):
                tk._layout_for(form, 10, kernel, "thread")
    if name == "nbody":
        with pytest.raises(ValueError, match="space dims"):
            tk.walker_layout(name, 24, "B")
        # ten bodies on a line: one space dim, the lane groups
        assert tk.form_layout((name, (torch.ones(10),)), 10, "B") == "group"
    if name == "mixture":
        with pytest.raises(ValueError, match="components"):
            tk.walker_layout(name, 2, "B")
        # three components: the lane groups
        assert tk.form_layout((name, (torch.zeros(3, 2),)), 2,
                              "B") == "group"


@pytest.mark.parametrize("name", sorted(SCHOOLS_MODELS))
def test_forced_layouts_on_cpu_run_the_plain_version(name):
    data = _schools_data(8)
    form = tm.make_model_potential(getattr(tm, SCHOOLS_MODELS[name]), (),
                                   data, device="cpu").potential.device_form
    q = torch.as_tensor(np.random.default_rng(5).normal(
        size=(40, 10)).astype(np.float32))
    u, g = tk.device_value_and_grad(form)(q)
    im = torch.linspace(0.5, 2.0, 10)
    kw = dict(scalars=torch.tensor([0.05, 1.0, 1.0]),
              p_std=torch.sqrt(1.0 / im), inv_mass=im, num_steps=4)
    before = dict(tk.fused_hmc_transition.launches_by_layout)
    want = tk.fused_hmc_transition_plain(form, 3, 1, q, u, g, **kw)
    for layout in (None, "thread", "group"):
        got = tk.fused_hmc_transition(form, 3, 1, q, u, g, _layout=layout,
                                      **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    lk = dict(step_size=torch.tensor([0.05]), num_steps=3, inv_mass=im)
    want = tk.leapfrog_trajectory_plain(form, q, q, **lk)
    for layout in ("thread", "group"):
        for a, b in zip(tk.leapfrog_trajectory(form, q, q, _layout=layout,
                                               **lk), want):
            assert torch.equal(a, b)
    for d in (17, 16):  # past both limits; past the centred form's in D
        wide = torch.zeros(4, d)
        with pytest.raises(ValueError, match="no thread layout"):
            tk.leapfrog_trajectory(
                ("eight_schools", (torch.zeros(d - 2),) * 3), wide, wide,
                _layout="thread", **{**lk, "inv_mass": torch.ones(d)})
    assert tk.fused_hmc_transition.launches_by_layout == before
