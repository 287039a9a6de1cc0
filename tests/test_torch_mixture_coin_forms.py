"""The Gaussian-mixture and coin forms of kernels B and D: the mixture runs
one walker a thread (``csrc/thread_layout.cu``) up to its limits, the coin
in the lane groups. Their plain versions (``kernels._mixture_vg``,
``_coin_vg``, whose operations the kernels take) against the JAX
package's potentials on the same numpy inputs; the mixture's padding of
its components to a compile-time count; the coin at logits far in the
tails; the plain values' layout in memory; the layout chooser at the
limits; and the wrappers on CPU tensors, with a layout forced and over
rungs.

Tolerances, float32:
* the mixture, value and gradient rtol=1e-4, atol=1e-5 (JAX's logsumexp
  and its autodiff take other operations: found up to 8e-8 relative in the
  value, 7e-6 in a gradient component that nearly cancels between modes);
* the coin against JAX's ``coin_toss`` DSL potential, rtol=1e-4,
  atol=1e-5, where that potential is finite (|x| up to 8 here: JAX's
  Bernoulli of sigmoid(x) is inf from |x| of about 17 in float32);
* the coin in the tails (|x| up to 100) against the same function in
  float64 (softplus by ``np.logaddexp``): rtol=1e-6 (found 7e-8) and
  finite.
"""

import json
from pathlib import Path

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
ROOT = Path(__file__).resolve().parent.parent


def _mixture(k, d, seed=0):
    rng = np.random.default_rng(100 * k + d + seed)
    means = (2.0 * rng.normal(size=(k, d))).astype(np.float32)
    log_w = rng.normal(size=k).astype(np.float32)
    return means, log_w, 1.2


@pytest.mark.parametrize("d", [2, 5, 16])
@pytest.mark.parametrize("k", [2, 3])
def test_mixture_plain_matches_jax_make_gaussian_mixture(k, d):
    means, log_w, sigma = _mixture(k, d)
    q = (2.5 * np.random.default_rng(d).normal(size=(64, d))).astype(
        np.float32)
    ju, jg = jp.batched_value_and_grad(jp.make_gaussian_mixture(
        jnp.asarray(means), sigma, jnp.asarray(log_w)))(jnp.asarray(q))
    form = tp.make_gaussian_mixture(means, sigma, log_w,
                                    device="cpu").device_form
    assert form[0] == "mixture"
    fu, fg = tk.device_value_and_grad(form)(torch.as_tensor(q))
    np.testing.assert_allclose(fu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(fg.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("k,kp", [(1, 2), (3, 4), (5, 8), (7, 8)])
def test_mixture_padded_components_keep_the_bits(k, kp):
    """The thread layout pads K components to KP (2) with log w = -inf
    and a mean of zeros: each padding term is -inf, adds exactly 0 to s and
    +-0 to num_j, so the plain version's operations on the padded mixture
    give the unpadded mixture's bits (csrc/forms.cuh MixtureThreadForm;
    the larger KP hold it for a wider build)."""
    d = 6
    means, log_w, _ = _mixture(k, d, seed=1)
    q = torch.as_tensor((3.0 * np.random.default_rng(k).normal(
        size=(200, d))).astype(np.float32))
    q[0] = 0.0
    q[1, :3] = -0.0
    iv = torch.tensor([1.0 / 1.44], dtype=torch.float32)
    pad_means = np.concatenate([means, np.zeros((kp - k, d), np.float32)])
    pad_w = np.concatenate([log_w, np.full(kp - k, -np.inf, np.float32)])
    u, g = tk.device_value_and_grad(
        ("mixture", (torch.as_tensor(means), torch.as_tensor(log_w), iv)))(q)
    pu, pg = tk.device_value_and_grad(
        ("mixture", (torch.as_tensor(pad_means), torch.as_tensor(pad_w),
                     iv)))(q)
    assert torch.equal(u.view(torch.int32), pu.view(torch.int32))
    assert torch.equal(g.view(torch.int32), pg.view(torch.int32))


def _coin_data():
    with open(ROOT / "examples" / "coin_toss.data.json") as f:
        raw = json.load(f)
    return {k: np.asarray(raw[k], np.float32) for k in ("c1", "c2")}


def test_coin_plain_matches_jax_coin_toss():
    """The coin form of the example data against the JAX package's and the
    port's ``coin_toss`` DSL potentials, from the centre to |x| = 8."""
    data = _coin_data()
    jmp = jm.make_model_potential(
        jm.examples.coin_toss, (),
        {k: jnp.asarray(v) for k, v in data.items()})
    tmp = tm.make_model_potential(tm.coin_toss, (), data, device="cpu")
    form = tmp.potential.device_form
    assert form[0] == "coin"
    rng = np.random.default_rng(3)
    q = (2.0 * rng.normal(size=(64, 2))).astype(np.float32)
    q[:8] = np.float32([[8, -8], [-8, 8], [0, -0.0], [-0.0, 0], [1e-6, -1e-6],
                        [3, 3], [-3, -3], [0.5, 6]])
    fu, fg = tk.device_value_and_grad(form)(torch.as_tensor(q))
    tu, tg = tp.batched_value_and_grad(tmp.potential)(torch.as_tensor(q))
    ju, jg = jp.batched_value_and_grad(jmp.potential)(jnp.asarray(q))
    for u, g in ((tu.numpy(), tg.numpy()), (np.asarray(ju), np.asarray(jg))):
        np.testing.assert_allclose(fu.numpy(), u, **TOL)
        np.testing.assert_allclose(fg.numpy(), g, **TOL)


def _coin_f64(q, a, b):
    """U and dU/dx of independent coins in float64 (softplus by
    ``logaddexp``, the logistic function from its tails)."""
    q, a, b = (np.asarray(x, np.float64) for x in (q, a, b))
    u = (a * np.logaddexp(0.0, -q) + b * np.logaddexp(0.0, q)).sum(axis=1)
    sig = np.where(q >= 0, 1.0 / (1.0 + np.exp(-np.abs(q))),
                   np.exp(-np.abs(q)) / (1.0 + np.exp(-np.abs(q))))
    return u, b * sig - a * (1.0 - sig)


@pytest.mark.parametrize("ab", ["data", "ones"])
def test_coin_plain_is_finite_in_the_tails(ab):
    """|x| up to 100, with a and b of the example data and at 1: finite, and
    within rtol=1e-6 of the float64 function."""
    if ab == "data":
        data = _coin_data()
        a = np.float32([data[k].sum() + 1.0 for k in ("c1", "c2")])
        b = np.float32([(1.0 - data[k]).sum() + 1.0 for k in ("c1", "c2")])
    else:
        a = b = np.ones(2, np.float32)
    x = np.float32([100.0, -100.0, 60.0, -60.0, 17.0, -17.0, 0.5, 0.0])
    q = np.stack(np.meshgrid(x, x), -1).reshape(-1, 2)
    form = ("coin", (torch.as_tensor(a), torch.as_tensor(b)))
    fu, fg = tk.device_value_and_grad(form)(torch.as_tensor(q))
    assert bool(torch.isfinite(fu).all()) and bool(torch.isfinite(fg).all())
    wu, wg = _coin_f64(q, a, b)
    np.testing.assert_allclose(fu.numpy(), wu, rtol=1e-6, atol=0.0)
    np.testing.assert_allclose(fg.numpy(), wg, rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("d", [2, 7, 16])
def test_plain_values_are_contiguous(d):
    """The coin's value summed over T > 1 lanes was a strided column of the
    butterfly's [W, T] (D > 4), which kernel B refused as a cached u ("u
    must be contiguous"); every form's plain (u, g) is contiguous."""
    rng = np.random.default_rng(d)
    q = torch.as_tensor(rng.normal(size=(10, d)).astype(np.float32))
    forms = [_form("coin", d), _form("mixture", d),
             ("diag_model", (torch.ones(d), torch.zeros(d),
                             torch.tensor([0.5])))]
    for form in forms:
        u, g = tk.device_value_and_grad(form)(q)
        assert u.is_contiguous() and g.is_contiguous(), form[0]


def _form(name, d, k=2):
    if name == "mixture":
        means, log_w, sigma = _mixture(k, d)
        return tp.make_gaussian_mixture(means, sigma, log_w,
                                        device="cpu").device_form
    rng = np.random.default_rng(d)
    return ("coin", (torch.as_tensor(rng.uniform(1, 9, d).astype(np.float32)),
                     torch.as_tensor(rng.uniform(1, 9, d).astype(np.float32))))


@pytest.mark.parametrize("kernel", ["B", "D"])
@pytest.mark.parametrize("name", ["mixture", "coin"])
def test_walker_layout_of_mixture_and_coin_at_their_limits(name, kernel):
    """The mixture one walker a thread up to D = 16 and 2 components, the
    lane groups past either limit; the coin in the lane groups at every D:
    decided from the form and its shape alone."""
    mixture = name == "mixture"
    assert (name in tk.THREAD_FORMS) == mixture
    assert tk.THREAD_LAYOUT_DIMS.get((name, kernel), 0) == (16 if mixture
                                                            else 0)
    assert tk.MIXTURE_THREAD_COMPONENTS == 2
    extra = dict(components=2) if mixture else {}
    for d, want in ((1, "thread"), (2, "thread"), (16, "thread"),
                    (17, "group"), (tk.MAX_GENERIC_DIMS, "group")):
        want = want if mixture else "group"
        assert tk.walker_layout(name, d, kernel, **extra) == want, d
        assert tk.form_layout(_form(name, d), d, kernel) == want, d
    if mixture:
        for k, want in ((1, "thread"), (2, "thread"), (3, "group"),
                        (9, "group")):
            assert tk.form_layout(_form(name, 2, k), 2, kernel) == want, k


@pytest.mark.parametrize("name,d,k", [("mixture", 2, 2), ("mixture", 7, 5),
                                      ("mixture", 17, 2), ("mixture", 3, 9),
                                      ("coin", 2, 0), ("coin", 17, 0)])
def test_forced_layouts_on_cpu_run_the_plain_version(name, d, k):
    """On CPU tensors each layout the hook may force runs the plain version
    (the same bits, no kernel counted); forcing the thread layout past a
    limit raises before anything runs."""
    form = _form(name, d, k)
    thread = tk.form_layout(form, d, "B") == "thread"
    assert thread == (name == "mixture" and d <= 16 and k <= 2)
    q = torch.as_tensor(np.random.default_rng(d).normal(
        size=(40, d)).astype(np.float32))
    u, g = tk.device_value_and_grad(form)(q)
    im = torch.linspace(0.5, 2.0, d)
    kw = dict(scalars=torch.tensor([0.05, 1.0, 1.0]),
              p_std=torch.sqrt(1.0 / im), inv_mass=im, num_steps=4)
    lk = dict(step_size=torch.tensor([0.05]), num_steps=3, inv_mass=im)
    before = (dict(tk.fused_hmc_transition.launches_by_layout),
              dict(tk.leapfrog_trajectory.launches_by_layout))
    want_b = tk.fused_hmc_transition_plain(form, 3, 1, q, u, g, **kw)
    want_d = tk.leapfrog_trajectory_plain(form, q, q, **lk)
    for layout in (None, "thread", "group") if thread else (None, "group"):
        got = tk.fused_hmc_transition(form, 3, 1, q, u, g, _layout=layout,
                                      **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want_b))
        got = tk.leapfrog_trajectory(form, q, q, _layout=layout, **lk)
        assert all(torch.equal(a, b) for a, b in zip(got, want_d))
    if not thread:
        with pytest.raises(ValueError, match="no thread layout"):
            tk.fused_hmc_transition(form, 3, 1, q, u, g, _layout="thread",
                                    **kw)
        with pytest.raises(ValueError, match="no thread layout"):
            tk.leapfrog_trajectory(form, q, q, _layout="thread", **lk)
    assert (tk.fused_hmc_transition.launches_by_layout,
            tk.leapfrog_trajectory.launches_by_layout) == before


@pytest.mark.parametrize("name,layout", [
    ("mixture", None), ("mixture", "thread"), ("mixture", "group"),
    ("coin", None), ("coin", "group")])
def test_wrapper_rungs_on_cpu_are_the_rung_calls(name, layout):
    """Kernel B's wrapper on CPU tensors with a layout forced: one rung is
    its plain version's bits, and q [3, W, D] the three rung-alone calls
    stacked, bit for bit."""
    d, r, w = 2, 3, 50
    form = _form(name, d)
    rng = np.random.default_rng(7)
    q = torch.as_tensor((2.0 * rng.normal(size=(r, w, d))).astype(np.float32))
    vg = tk.device_value_and_grad(form)
    u, g = (torch.stack(x) for x in zip(*(vg(x) for x in q)))
    betas = torch.tensor([1.0, 0.4, 0.1])
    kw = dict(scalars=torch.stack((torch.tensor([0.2, 0.3, 0.5]), betas,
                                   torch.ones(r)), 1),
              p_std=torch.sqrt(1.0 / betas)[:, None].expand(r, d).contiguous(),
              inv_mass=torch.ones(d), num_steps=6, _layout=layout)
    seeds = [5, 2**62 + 1, 9]
    got = tk.fused_hmc_transition(form, seeds, 4, q, u, g, **kw)
    each = []
    for i, key in enumerate(seeds):
        one = tk.fused_hmc_transition(
            form, key, 4, q[i], u[i], g[i],
            **{**kw, "scalars": kw["scalars"][i], "p_std": kw["p_std"][i]})
        plain = tk.fused_hmc_transition_plain(
            form, key, 4, q[i], u[i], g[i], scalars=kw["scalars"][i],
            p_std=kw["p_std"][i], inv_mass=kw["inv_mass"], num_steps=6)
        assert all(torch.equal(a, b) for a, b in zip(one, plain))
        each.append(one)
    for a, b in zip(got, tk._stack_rungs(each), strict=True):
        assert torch.equal(a, b)
