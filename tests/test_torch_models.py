"""The port's model DSL against the JAX package's on the same numpy inputs:
distributions, transforms, handlers and plates, and the model potentials.

Tolerances (float32 on both sides): log_prob and transforms rtol=1e-5,
atol=1e-6 (atol=1e-5 where a log of a difference cancels); model
potentials rtol=1e-5 in value and rtol=1e-4, atol=1e-5 in gradient (the
two autodiffs sum in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import models as jm
from physicsbasedbayesianinference_tpu.models import core as jcore
from physicsbasedbayesianinference_tpu.models import distributions as jd
from physicsbasedbayesianinference_tpu.models import transforms as jt
from physicsbasedbayesianinference_tpu.ops import potentials as jp
from physicsbasedbayesianinference_tpu_torch import models as tm
from physicsbasedbayesianinference_tpu_torch.models import core as tcore
from physicsbasedbayesianinference_tpu_torch.models import distributions as td
from physicsbasedbayesianinference_tpu_torch.models import transforms as tt
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp
from physicsbasedbayesianinference_tpu_torch.utils import convert
from _torch_cpu import cpu_requested  # noqa: F401  (the CPU, asked for)

TOL = dict(rtol=1e-5, atol=1e-6)

# name -> (constructor arguments, values that include the support's edges
# and the points tests/test_models.py checks)
CONTINUOUS = {
    "Normal": ((1.0, 2.0), [-3.0, 0.0, 2.5, 1.0, 40.0]),
    "HalfNormal": ((2.0,), [0.1, 1.0, 5.0, 1e-6]),
    "Cauchy": ((0.5, 2.0), [-2.0, 0.5, 9.0, 1e4]),
    "HalfCauchy": ((5.0,), [0.2, 2.0, 30.0, 1e-6, 1e4]),
    "Uniform": ((-1.0, 3.0), [-0.5, 0.0, 2.9, -1.0, 3.0, -1.5, 3.5]),
    "Exponential": ((1.7,), [0.1, 1.0, 4.0, 0.0]),
    "Gamma": ((2.5, 1.3), [0.3, 2.0, 7.0, 1e-4]),
    "InverseGamma": ((3.0, 2.0), [0.2, 0.7, 3.0, 50.0]),
    "Weibull": ((1.7, 2.2), [0.3, 1.5, 5.0, 1e-3]),
    "Beta": ((2.0, 3.0), [0.1, 0.5, 0.9, 1e-4, 1.0 - 1e-4]),
    "LogNormal": ((0.3, 0.8), [0.2, 1.0, 4.0, 1e-3]),
    "StudentT": ((4.0, 0.5, 1.5), [-2.0, 0.5, 3.0, 100.0]),
    "Laplace": ((0.2, 1.1), [-2.0, 0.2, 3.0]),
}
DISCRETE = {
    "Bernoulli": ((0.3,), [0.0, 1.0]),
    "BernoulliLogits": ((1.5,), [0.0, 1.0]),
    "Binomial": ((10, 0.4), [0.0, 4.0, 10.0]),
    "Poisson": ((3.5,), [0.0, 3.0, 8.0]),
    "NegativeBinomial": ((4.0, 0.35), [0.0, 3.0, 11.0]),
}


@pytest.mark.parametrize("name", sorted(CONTINUOUS) + sorted(DISCRETE))
def test_log_prob_matches_jax(name):
    args, xs = {**CONTINUOUS, **DISCRETE}[name]
    x = np.asarray(xs, np.float32)
    want = np.asarray(getattr(jd, name)(*args).log_prob(jnp.asarray(x)))
    got = getattr(td, name)(*args).log_prob(torch.as_tensor(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # tensor parameters broadcast against the values as jnp arrays do
    rng = np.random.default_rng(0)
    if name not in ("Uniform", "Binomial"):
        arrs = [np.float32(a) * rng.uniform(0.8, 1.2, (3, 1)).astype(
            np.float32) for a in args]
        want = np.asarray(getattr(jd, name)(
            *map(jnp.asarray, arrs)).log_prob(jnp.asarray(x)))
        d = getattr(td, name)(*map(torch.as_tensor, arrs))
        assert d.batch_shape == (3, 1)
        np.testing.assert_allclose(d.log_prob(torch.as_tensor(x)).numpy(),
                                   want, **TOL)


def test_bernoulli_edges_categorical_and_mvn_match_jax():
    for p in (0.0, 1.0):  # xlogy keeps p in {0, 1} finite where it should
        for v in (0.0, 1.0):
            np.testing.assert_allclose(
                td.Bernoulli(p).log_prob(torch.tensor(v)).numpy(),
                np.asarray(jd.Bernoulli(p).log_prob(jnp.float32(v))), **TOL)
    logits = np.float32([[0.3, -1.0, 2.0, 0.0], [1.0, 1.0, -3.0, 0.5]])
    ks = np.array([3, 1])
    np.testing.assert_allclose(
        td.Categorical(torch.as_tensor(logits)).log_prob(
            torch.as_tensor(ks)).numpy(),
        np.asarray(jd.Categorical(jnp.asarray(logits)).log_prob(
            jnp.asarray(ks))), **TOL)
    mean = np.float32([1.0, -2.0])
    cov = np.float32([[2.0, 0.6], [0.6, 1.0]])
    xs = np.float32([[0.0, 0.0], [1.0, -2.0], [3.0, 1.0]])
    np.testing.assert_allclose(
        td.MultivariateNormal(mean, cov=cov).log_prob(
            torch.as_tensor(xs)).numpy(),
        [float(jd.MultivariateNormal(mean, cov=cov).log_prob(
            jnp.asarray(x))) for x in xs], **TOL)
    assert td.MultivariateNormal(mean, cov=cov).event_shape == (2,)
    assert sorted(td.__all__) == sorted(jd.__all__)


def test_sampling_shapes_supports_and_moments():
    gen = torch.Generator().manual_seed(0)
    for name, (args, _) in {**CONTINUOUS, **DISCRETE}.items():
        d = getattr(td, name)(*args)
        x = d.sample(gen, (5, 2))
        assert x.shape == (5, 2), name
        assert d.is_discrete == getattr(jd, name)(*args).is_discrete
        assert bool(torch.isfinite(d.log_prob(x.float())).all()), name
    x = td.Gamma(3.0, 2.0).sample(gen, (100_000,))
    np.testing.assert_allclose(float(x.mean()), 1.5, rtol=0.02)
    x = td.Beta(2.0, 5.0).sample(gen, (100_000,))
    np.testing.assert_allclose(float(x.mean()), 2.0 / 7.0, rtol=0.02)
    x = td.StudentT(5.0, 1.0, 2.0).sample(gen, (100_000,))
    np.testing.assert_allclose(float(x.mean()), 1.0, atol=0.05)
    probs = torch.softmax(torch.tensor([0.3, -1.0, 2.0, 0.0]), 0).numpy()
    draws = td.Categorical(torch.tensor([0.3, -1.0, 2.0, 0.0])).sample(
        gen, (4000,)).numpy()
    np.testing.assert_allclose(np.bincount(draws, minlength=4) / 4000.0,
                               probs, atol=0.03)
    k = td.Binomial(10, 0.4).sample(gen, (20_000,))
    np.testing.assert_allclose(float(k.float().mean()), 4.0, rtol=0.03)
    mvn = td.MultivariateNormal(np.float32([1.0, -2.0]),
                                cov=np.float32([[2.0, 0.6], [0.6, 1.0]]))
    np.testing.assert_allclose(mvn.sample(gen, (50_000,)).mean(0).numpy(),
                               [1.0, -2.0], atol=0.03)


TRANSFORMS = {
    "identity": ((), "IDENTITY"), "exp": ((), "POSITIVE"),
    "unit": ((), "UNIT_INTERVAL"), "interval": ((-2.0, 5.0), None),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    args, const = TRANSFORMS[name]
    j = getattr(jt, const) if const else jt.IntervalTransform(*args)
    t = getattr(tt, const) if const else tt.IntervalTransform(*args)
    x = np.linspace(-30.0, 30.0, 25).astype(np.float32)
    xt = torch.as_tensor(x)
    np.testing.assert_allclose(t.forward(xt).numpy(),
                               np.asarray(j.forward(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        t.log_det_jacobian(xt).numpy(),
        np.asarray(j.log_det_jacobian(jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    mid = np.linspace(-3.0, 3.0, 7).astype(np.float32)
    y = np.asarray(j.forward(jnp.asarray(mid)))
    np.testing.assert_allclose(t.inverse(torch.as_tensor(y)).numpy(),
                               np.asarray(j.inverse(jnp.asarray(y))),
                               rtol=1e-5, atol=1e-5)
    assert t.name == j.name


def test_ordered_transform_and_softplus_match_jax():
    x = np.float32([[0.5, -1.0, 0.3, 2.0], [-2.0, 0.0, 1.0, -0.5]])
    j, t = jt.ORDERED, tt.ORDERED
    y = t.forward(torch.as_tensor(x))
    np.testing.assert_allclose(y.numpy(),
                               np.asarray(j.forward(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(t.inverse(y).numpy(), x, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        t.log_det_jacobian(torch.as_tensor(x)).numpy(),
        np.asarray(j.log_det_jacobian(jnp.asarray(x))), **TOL)
    # out of place: it runs under vmap(grad)
    g = torch.func.vmap(torch.func.grad(
        lambda v: t.log_det_jacobian(v).sum()))(torch.as_tensor(x))
    np.testing.assert_allclose(g.numpy(), [[0.0, 1.0, 1.0, 1.0]] * 2)
    z = np.float32([-100.0, -20.0, -1.0, 0.0, 1.0, 20.0, 100.0])
    zt = torch.as_tensor(z).requires_grad_()
    s = tt.softplus(zt)
    np.testing.assert_allclose(s.detach().numpy(),
                               np.asarray(jt.softplus(jnp.asarray(z))), **TOL)
    s.sum().backward()  # the JAX side's custom derivative is the sigmoid
    np.testing.assert_allclose(
        zt.grad.numpy(),
        np.asarray(jax.vmap(jax.grad(jt.softplus))(jnp.asarray(z))), **TOL)


# ---------------------------------------------------------------------------
# models: log_density, the potential and its batched gradient
# ---------------------------------------------------------------------------


def _data(name):
    """numpy (args, kwargs) of an example model, from a seed."""
    rng = np.random.default_rng(11)
    if name == "coin_toss":
        return (np.float32([1, 0] * 10), np.float32([1] * 15 + [0] * 5)), {}
    if name in ("eight_schools", "eight_schools_noncentered"):
        data = tm.EIGHT_SCHOOLS_DATA
        return (), {"J": 8, "sigma": data["sigma"], "y": data["y"]}
    if name == "logistic_regression":
        return tm.logistic_regression_data(40, 5), {}
    if name == "linear_regression":
        x = rng.normal(size=(30, 3)).astype(np.float32)
        y = (x @ np.float32([1.0, -2.0, 0.5]) + 0.3
             + 0.1 * rng.normal(size=30)).astype(np.float32)
        return (x, y), {}
    return (), {"dim": 5}


def _both(name, reparam):
    args, kwargs = _data(name)
    jargs = tuple(jnp.asarray(a) for a in args)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()}
    jmp = jm.make_model_potential(jm.examples.EXAMPLE_MODELS[name], jargs, jkw,
                                  reparam=reparam)
    tmp = tm.make_model_potential(
        tm.EXAMPLE_MODELS[name], convert.model_data_from_numpy(args, "cpu"),
        kwargs, reparam=reparam, device="cpu")
    return jmp, tmp


@pytest.mark.parametrize("reparam", [None, "auto"])
@pytest.mark.parametrize("name", sorted(tm.EXAMPLE_MODELS))
def test_model_potential_matches_jax(name, reparam):
    jmp, tmp = _both(name, reparam)
    assert tmp.num_dims == jmp.num_dims
    assert [(s.name, s.shape, s.offset) for s in tmp.specs] == \
        [(s.name, s.shape, s.offset) for s in jmp.specs]
    q = (0.5 * np.random.default_rng(3).normal(
        size=(6, tmp.num_dims))).astype(np.float32)
    ju, jg = jp.batched_value_and_grad(jmp.potential)(jnp.asarray(q))
    tu, tg = tp.batched_value_and_grad(tmp.potential)(torch.as_tensor(q))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)
    # one walker, through log_density at the constrained values
    params = tmp.unflatten(torch.as_tensor(q[0]))
    jparams = jmp.unflatten(jnp.asarray(q[0]))
    for key in params:
        np.testing.assert_allclose(params[key].numpy(),
                                   np.asarray(jparams[key]), **TOL)
    tl, tsites = tm.log_density(tmp.model, tmp.model_args, tmp.model_kwargs,
                                params)
    jl, jsites = jm.log_density(jmp.model, jmp.model_args, jmp.model_kwargs,
                                jparams)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert list(tsites) == list(jsites)
    # round trips, one walker and a batch
    np.testing.assert_allclose(tmp.flatten(params).numpy(), q[0], rtol=1e-4,
                               atol=1e-5)
    tv = tmp.trace_values(torch.as_tensor(q))
    jv = jmp.trace_values(jnp.asarray(q))
    assert sorted(tv) == sorted(jv)
    for key in tv:
        np.testing.assert_allclose(tv[key].numpy(), np.asarray(jv[key]),
                                   rtol=1e-5, atol=1e-5)
    assert tmp.potential.analytic_grad is None
    assert tmp.potential.name == jmp.potential.name


def _plate_models(dist, sample, plate, xp, **sub):
    def explicit_dim(y):
        mu = sample("mu", dist.Normal(0.0, 2.0))
        with plate("rows", 3, dim=-2):
            a = sample("a", dist.Normal(mu, 1.0))
            sample("obs", dist.Normal(a, 0.5), obs=y)

    def nested(y):
        s = sample("s", dist.HalfNormal(1.0))
        with plate("a", 3):
            x = sample("x", dist.Normal(0.0, 1.0))
            with plate("b", 4):
                z = sample("z", dist.Normal(x, s))
                sample("obs", dist.Normal(z, 1.0), obs=y)

    def subsampled(data, idx):
        mu = sample("mu", dist.Normal(0.0, 1.0))
        with plate("N", 10, subsample_size=4, **sub):
            sample("obs", dist.Normal(mu, 1.0), obs=data[idx])

    return {"explicit_dim": explicit_dim, "nested": nested,
            "subsampled": subsampled}


PLATE_DATA = {
    "explicit_dim": (np.float32([[0.3], [-1.0], [2.0]]),),
    "nested": (np.arange(12, dtype=np.float32).reshape(4, 3) / 6.0,),
    "subsampled": (np.arange(10, dtype=np.float32), np.array([7, 2, 9, 0])),
}


@pytest.mark.parametrize("name", sorted(PLATE_DATA))
def test_plates_match_jax(name):
    """Explicit dim, nested plates (samples under plate(a=3) > plate(b=4)
    have shape (4, 3)) and the subsampling rescale, the indices given."""
    jmodel = _plate_models(jd, jcore.sample, jcore.plate, jnp,
                           key=jax.random.key(0))[name]
    tmodel = _plate_models(
        td, tcore.sample, tcore.plate, torch,
        generator=torch.Generator().manual_seed(0))[name]
    data = PLATE_DATA[name]
    jmp = jm.make_model_potential(jmodel, tuple(map(jnp.asarray, data)), {})
    tmp = tm.make_model_potential(
        tmodel, convert.model_data_from_numpy(data, "cpu"), {}, device="cpu")
    assert [(s.name, s.shape) for s in tmp.specs] == \
        [(s.name, s.shape) for s in jmp.specs]
    q = (0.4 * np.random.default_rng(5).normal(
        size=(5, tmp.num_dims))).astype(np.float32)
    ju, jg = jp.batched_value_and_grad(jmp.potential)(jnp.asarray(q))
    tu, tg = tp.batched_value_and_grad(tmp.potential)(torch.as_tensor(q))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)
    if name == "subsampled":
        _, sites = tm.log_density(tmodel, tmp.model_args, {},
                                  {"mu": torch.tensor(0.7)})
        assert sites["obs"].scale == pytest.approx(2.5)


def test_plate_and_handler_behaviour():
    with tcore.trace() as tr, tcore.seed(3, device="cpu"):
        with tcore.plate("N", 100, subsample_size=8) as idx:
            tcore.sample("x", td.Normal(0.0, 1.0))
    assert tr.sites["x"].value.shape == (8,)
    assert tr.sites["x"].scale == pytest.approx(12.5)
    assert len(set(idx.tolist())) == 8 and 0 <= int(idx.min()) \
        and int(idx.max()) < 100
    with tcore.seed(3, device="cpu"):  # the same seed, the same indices
        with tcore.plate("N", 100, subsample_size=8) as again:
            pass
        with tcore.plate("M", 100, subsample_size=8) as other:
            pass
    assert torch.equal(idx, again) and not torch.equal(idx, other)
    with pytest.raises(ValueError, match="needs randomness"):
        with tcore.plate("N", 10, subsample_size=2):
            pass
    with pytest.raises(ValueError, match="already taken"):
        with tcore.plate("a", 3, dim=-1), tcore.plate("b", 5, dim=-1):
            pass
    with pytest.raises(ValueError, match="must be negative"):
        with tcore.plate("a", 3, dim=0):
            pass
    with pytest.raises(ValueError, match="exceeds"):
        with tcore.plate("a", 3, subsample_size=4):
            pass
    with pytest.raises(RuntimeError, match="bottom of handler stack"):
        tcore.sample("x", td.Normal(0.0, 1.0))
    with pytest.raises(ValueError, match="duplicate sample site"):
        with tcore.trace(), tcore.seed(0, device="cpu"):
            tcore.sample("x", td.Normal(0.0, 1.0))
            tcore.sample("x", td.Normal(0.0, 1.0))
    # a generator seeds site after site; an int seeds site k from (int, k)
    gen = torch.Generator().manual_seed(1)
    sites = tcore.trace_model(tm.eight_schools, (), _data("eight_schools")[1],
                              rng=gen)
    assert sites["theta"].value.shape == (8,) and sites["obs"].is_observed
    a = tcore.trace_model(tm.funnel, (), {"dim": 3}, rng=5)
    b = tcore.trace_model(tm.funnel, (), {"dim": 3}, rng=5)
    assert torch.equal(a["x"].value, b["x"].value)


def test_reparam_selection_and_errors():
    """"auto" takes the sites whose loc or scale is a tensor; a bare string
    names one site; a discrete latent and a model without latents raise as
    in the JAX package."""
    kwargs = _data("eight_schools")[1]
    with tcore.trace() as tr, tcore.seed(0, device="cpu"):
        tcore.reparametrized(tm.eight_schools, "auto")(**kwargs)
    assert tr.sites["theta"].is_deterministic
    assert not tr.sites["mu"].is_deterministic
    assert "theta_decentered" in tr.sites and "mu_decentered" not in tr.sites
    mp = tm.make_model_potential(tm.eight_schools, (), kwargs,
                                 reparam="theta", device="cpu")
    assert [s.name for s in mp.specs] == ["mu", "tau", "theta_decentered"]
    mp = tm.make_model_potential(tm.eight_schools, (), kwargs,
                                 reparam={"theta": False}, device="cpu")
    assert [s.name for s in mp.specs] == ["mu", "tau", "theta"]

    def discrete():
        tcore.sample("k", td.Poisson(3.0))

    with pytest.raises(ValueError, match="discrete distribution Poisson"):
        tm.make_model_potential(discrete, device="cpu")

    def observed_only():
        tcore.sample("y", td.Normal(0.0, 1.0), obs=torch.tensor(0.3))

    with pytest.raises(ValueError, match="no latent sites"):
        tm.make_model_potential(observed_only, device="cpu")


def test_init_strategies_and_data_placement():
    args, kwargs = _data("eight_schools_noncentered")
    mp = tm.make_model_potential(tm.eight_schools_noncentered, args, kwargs,
                                 device="cpu")
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
               and v.device.type == "cpu"
               for k, v in mp.model_kwargs.items() if k != "J")
    assert mp.model_kwargs["J"] == 8
    q = mp.init(0, 64)
    assert q.shape == (64, 10) and float(q.abs().max()) <= 2.0
    assert torch.equal(q, mp.init(0, 64)) and not torch.equal(q,
                                                              mp.init(1, 64))
    qp = mp.init(torch.Generator().manual_seed(2), 16, strategy="prior",
                 jitter=0.1)
    assert qp.shape == (16, 10) and bool(torch.isfinite(qp).all())
    with pytest.raises(ValueError, match="unknown init strategy"):
        mp.init(0, 4, strategy="zeros")
    cons = mp.constrain_samples(q)
    assert bool((cons["tau"] > 0).all()) and cons["theta_raw"].shape == (64,
                                                                         8)
