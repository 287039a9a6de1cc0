"""Probability distributions of the model DSL (port of the JAX package's
``models/distributions.py``).

Log-probabilities are written directly in log space (never ``log(pdf)``),
safe in float32. Each distribution provides ``log_prob(value)``,
elementwise over the broadcast batch shape; ``sample(generator, shape)``,
drawn with a ``torch.Generator`` on the generator's device; ``support``, a
transform of ``transforms.py`` (None for a discrete distribution, which can
be observed but not latent: HMC needs a continuous unconstrained
parameterisation); ``batch_shape`` and ``event_dim``.

Parameters given as Python numbers stay Python numbers until they meet a
tensor, so that device and dtype follow the value (float32 where there is
nothing to follow, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import transforms as tfm

Tensor = torch.Tensor

_LOG_2PI = math.log(2.0 * math.pi)


def _bshape(*params) -> tuple:
    return tuple(torch.broadcast_shapes(
        *(tuple(np.shape(p)) for p in params)))


def _value(v, *params) -> Tensor:
    """``v`` as a floating tensor; a number or array lands beside the first
    tensor among ``params`` (else on the CPU)."""
    if not isinstance(v, Tensor):
        device = next((p.device for p in params if isinstance(p, Tensor)),
                      None)
        v = torch.as_tensor(v, device=device)
    return v if v.is_floating_point() else v.to(torch.float32)


def _field(p, like: Tensor) -> Tensor:
    """A parameter as a tensor on ``like``'s device: a tensor keeps its
    dtype (integers become float32), anything else takes ``like``'s."""
    if isinstance(p, Tensor):
        p = p if p.is_floating_point() else p.to(torch.float32)
        return p.to(like.device)
    return torch.as_tensor(p, dtype=like.dtype, device=like.device)


def _draw_shape(shape, dist) -> tuple:
    return tuple(torch.broadcast_shapes(tuple(shape), dist.batch_shape))


def _unit(gen: torch.Generator) -> Tensor:
    """A float32 zero on the generator's device, for parameters to follow."""
    return torch.zeros((), device=gen.device)


def _uniform(gen, shape, open_low: bool = False) -> Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u.clamp_min(torch.finfo(u.dtype).tiny) if open_low else u


def _normal(gen, shape) -> Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def _std_cauchy(gen, shape) -> Tensor:
    return torch.tan(math.pi * (_uniform(gen, shape) - 0.5))


def _std_gamma(gen, concentration, shape) -> Tensor:
    conc = torch.broadcast_to(_field(concentration, _unit(gen)), shape)
    return torch._standard_gamma(conc.contiguous(), generator=gen)


class Distribution:
    """Base class; subclasses are frozen dataclasses of their parameters,
    or plain classes where the support depends on the parameters."""

    event_dim = 0
    support: Optional[tfm.Transform] = tfm.IDENTITY

    @property
    def batch_shape(self) -> tuple:
        return ()

    def log_prob(self, value) -> Tensor:
        raise NotImplementedError

    def sample(self, generator: torch.Generator, shape: tuple = ()) -> Tensor:
        raise NotImplementedError

    @property
    def is_discrete(self) -> bool:
        return self.support is None


@dataclasses.dataclass(frozen=True, eq=False)
class Normal(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    @property
    def batch_shape(self):
        return _bshape(self.loc, self.scale)

    def log_prob(self, value):
        value = _value(value, self.loc, self.scale)
        loc, scale = _field(self.loc, value), _field(self.scale, value)
        z = (value - loc) / scale
        return -0.5 * z * z - torch.log(scale) - 0.5 * _LOG_2PI

    def sample(self, generator, shape=()):
        eps = _normal(generator, _draw_shape(shape, self))
        return _field(self.loc, eps) + _field(self.scale, eps) * eps


@dataclasses.dataclass(frozen=True, eq=False)
class HalfNormal(Distribution):
    scale: object = 1.0
    support = tfm.POSITIVE

    @property
    def batch_shape(self):
        return _bshape(self.scale)

    def log_prob(self, value):
        value = _value(value, self.scale)
        scale = _field(self.scale, value)
        z = value / scale
        return (math.log(2.0) - 0.5 * z * z - torch.log(scale)
                - 0.5 * _LOG_2PI)

    def sample(self, generator, shape=()):
        eps = _normal(generator, _draw_shape(shape, self))
        return torch.abs(_field(self.scale, eps) * eps)


@dataclasses.dataclass(frozen=True, eq=False)
class Cauchy(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    @property
    def batch_shape(self):
        return _bshape(self.loc, self.scale)

    def log_prob(self, value):
        value = _value(value, self.loc, self.scale)
        loc, scale = _field(self.loc, value), _field(self.scale, value)
        z = (value - loc) / scale
        return -math.log(math.pi) - torch.log(scale) - torch.log1p(z * z)

    def sample(self, generator, shape=()):
        eps = _std_cauchy(generator, _draw_shape(shape, self))
        return _field(self.loc, eps) + _field(self.scale, eps) * eps


@dataclasses.dataclass(frozen=True, eq=False)
class HalfCauchy(Distribution):
    scale: object = 1.0
    support = tfm.POSITIVE

    @property
    def batch_shape(self):
        return _bshape(self.scale)

    def log_prob(self, value):
        value = _value(value, self.scale)
        scale = _field(self.scale, value)
        z = value / scale
        return (math.log(2.0) - math.log(math.pi) - torch.log(scale)
                - torch.log1p(z * z))

    def sample(self, generator, shape=()):
        eps = _std_cauchy(generator, _draw_shape(shape, self))
        return torch.abs(_field(self.scale, eps) * eps)


def _bound(v):
    """A bound of :class:`Uniform`: a tensor as it is, an array as a
    float32 tensor, a number as a float."""
    if isinstance(v, Tensor):
        return v
    return (torch.as_tensor(np.asarray(v, np.float32)) if np.ndim(v)
            else float(v))


class Uniform(Distribution):
    """Uniform on (lo, hi). A plain class because ``support`` depends on
    the bounds (they define the unconstrained bijection); the bounds are
    numbers or tensors, which broadcast elementwise through the interval
    bijection and its Jacobian."""

    event_dim = 0

    def __init__(self, lo=0.0, hi=1.0):
        self.lo, self.hi = _bound(lo), _bound(hi)
        self.support = tfm.IntervalTransform(self.lo, self.hi)

    @property
    def batch_shape(self):
        return _bshape(self.lo, self.hi)

    def log_prob(self, value):
        value = _value(value, self.lo, self.hi)
        lo, hi = _field(self.lo, value), _field(self.hi, value)
        in_support = (value >= lo) & (value <= hi)
        lp = torch.broadcast_to(-torch.log(hi - lo), in_support.shape)
        return torch.where(in_support, lp, -torch.inf)

    def sample(self, generator, shape=()):
        u = _uniform(generator, _draw_shape(shape, self))
        lo, hi = _field(self.lo, u), _field(self.hi, u)
        return lo + (hi - lo) * u


@dataclasses.dataclass(frozen=True, eq=False)
class Exponential(Distribution):
    rate: object = 1.0
    support = tfm.POSITIVE

    @property
    def batch_shape(self):
        return _bshape(self.rate)

    def log_prob(self, value):
        value = _value(value, self.rate)
        rate = _field(self.rate, value)
        return torch.log(rate) - rate * value

    def sample(self, generator, shape=()):
        u = _uniform(generator, _draw_shape(shape, self))
        return -torch.log1p(-u) / _field(self.rate, u)


@dataclasses.dataclass(frozen=True, eq=False)
class Gamma(Distribution):
    concentration: object = 1.0
    rate: object = 1.0
    support = tfm.POSITIVE

    @property
    def batch_shape(self):
        return _bshape(self.concentration, self.rate)

    def log_prob(self, value):
        value = _value(value, self.concentration, self.rate)
        a, b = _field(self.concentration, value), _field(self.rate, value)
        return (a * torch.log(b) + (a - 1.0) * torch.log(value) - b * value
                - torch.lgamma(a))

    def sample(self, generator, shape=()):
        g = _std_gamma(generator, self.concentration,
                       _draw_shape(shape, self))
        return g / _field(self.rate, g)


@dataclasses.dataclass(frozen=True, eq=False)
class InverseGamma(Distribution):
    """value ~ InvGamma(a, b) iff 1 / value ~ Gamma(a, rate=b)."""

    concentration: object = 1.0
    scale: object = 1.0
    support = tfm.POSITIVE

    @property
    def batch_shape(self):
        return _bshape(self.concentration, self.scale)

    def log_prob(self, value):
        value = _value(value, self.concentration, self.scale)
        a, b = _field(self.concentration, value), _field(self.scale, value)
        return (a * torch.log(b) - (a + 1.0) * torch.log(value)
                - b / value - torch.lgamma(a))

    def sample(self, generator, shape=()):
        g = _std_gamma(generator, self.concentration,
                       _draw_shape(shape, self))
        return _field(self.scale, g) / g


@dataclasses.dataclass(frozen=True, eq=False)
class Weibull(Distribution):
    """Weibull(concentration k, scale lambda)."""

    concentration: object = 1.0
    scale: object = 1.0
    support = tfm.POSITIVE

    @property
    def batch_shape(self):
        return _bshape(self.concentration, self.scale)

    def log_prob(self, value):
        value = _value(value, self.concentration, self.scale)
        k, lam = _field(self.concentration, value), _field(self.scale, value)
        z = value / lam
        return (torch.log(k) - torch.log(lam) + (k - 1.0) * torch.log(z)
                - z**k)

    def sample(self, generator, shape=()):
        u = _uniform(generator, _draw_shape(shape, self), open_low=True)
        return _field(self.scale, u) * (-torch.log(u)) ** (
            1.0 / _field(self.concentration, u))


@dataclasses.dataclass(frozen=True, eq=False)
class Beta(Distribution):
    a: object = 1.0
    b: object = 1.0
    support = tfm.UNIT_INTERVAL

    @property
    def batch_shape(self):
        return _bshape(self.a, self.b)

    def log_prob(self, value):
        value = _value(value, self.a, self.b)
        a, b = _field(self.a, value), _field(self.b, value)
        betaln = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
        return ((a - 1.0) * torch.log(value)
                + (b - 1.0) * torch.log1p(-value) - betaln)

    def sample(self, generator, shape=()):
        shape = _draw_shape(shape, self)
        ga = _std_gamma(generator, self.a, shape)
        gb = _std_gamma(generator, self.b, shape)
        return ga / (ga + gb)


@dataclasses.dataclass(frozen=True, eq=False)
class LogNormal(Distribution):
    loc: object = 0.0
    scale: object = 1.0
    support = tfm.POSITIVE

    @property
    def batch_shape(self):
        return _bshape(self.loc, self.scale)

    def log_prob(self, value):
        value = _value(value, self.loc, self.scale)
        loc, scale = _field(self.loc, value), _field(self.scale, value)
        logv = torch.log(value)
        z = (logv - loc) / scale
        return -0.5 * z * z - torch.log(scale) - 0.5 * _LOG_2PI - logv

    def sample(self, generator, shape=()):
        eps = _normal(generator, _draw_shape(shape, self))
        return torch.exp(_field(self.loc, eps)
                         + _field(self.scale, eps) * eps)


@dataclasses.dataclass(frozen=True, eq=False)
class StudentT(Distribution):
    df: object = 1.0
    loc: object = 0.0
    scale: object = 1.0

    @property
    def batch_shape(self):
        return _bshape(self.df, self.loc, self.scale)

    def log_prob(self, value):
        value = _value(value, self.df, self.loc, self.scale)
        df, loc, scale = (_field(p, value)
                          for p in (self.df, self.loc, self.scale))
        z = (value - loc) / scale
        return (torch.lgamma(0.5 * (df + 1.0)) - torch.lgamma(0.5 * df)
                - 0.5 * torch.log(df * math.pi) - torch.log(scale)
                - 0.5 * (df + 1.0) * torch.log1p(z * z / df))

    def sample(self, generator, shape=()):
        shape = _draw_shape(shape, self)
        eps = _normal(generator, shape)
        df = _field(self.df, eps)
        chi2 = 2.0 * _std_gamma(generator, 0.5 * df, shape)
        return (_field(self.loc, eps)
                + _field(self.scale, eps) * eps / torch.sqrt(chi2 / df))


@dataclasses.dataclass(frozen=True, eq=False)
class Laplace(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    @property
    def batch_shape(self):
        return _bshape(self.loc, self.scale)

    def log_prob(self, value):
        value = _value(value, self.loc, self.scale)
        loc, scale = _field(self.loc, value), _field(self.scale, value)
        return -torch.abs(value - loc) / scale - torch.log(2.0 * scale)

    def sample(self, generator, shape=()):
        u = _uniform(generator, _draw_shape(shape, self)) - 0.5
        eps = -torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))
        return _field(self.loc, eps) + _field(self.scale, eps) * eps


# -- discrete (observation-only for HMC) ------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Bernoulli(Distribution):
    """log p(x) through xlogy, safe at p in {0, 1}."""

    probs: object = 0.5
    support = None

    @property
    def batch_shape(self):
        return _bshape(self.probs)

    def log_prob(self, value):
        value = _value(value, self.probs)
        p = _field(self.probs, value)
        return torch.xlogy(value, p) + torch.special.xlog1py(1.0 - value, -p)

    def sample(self, generator, shape=()):
        u = _uniform(generator, _draw_shape(shape, self))
        return (u < _field(self.probs, u)).to(torch.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class BernoulliLogits(Distribution):
    """Bernoulli parameterised by logits (the numerically right choice for
    logistic regression): log p = value * logits - softplus(logits)."""

    logits: object = 0.0
    support = None

    @property
    def batch_shape(self):
        return _bshape(self.logits)

    def log_prob(self, value):
        value = _value(value, self.logits)
        logits = _field(self.logits, value)
        return value * logits - tfm.softplus(logits)

    def sample(self, generator, shape=()):
        u = _uniform(generator, _draw_shape(shape, self))
        return (u < torch.sigmoid(_field(self.logits, u))).to(torch.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class Binomial(Distribution):
    total_count: object = 1
    probs: object = 0.5
    support = None

    @property
    def batch_shape(self):
        return _bshape(self.total_count, self.probs)

    def log_prob(self, value):
        value = _value(value, self.total_count, self.probs)
        n, p = _field(self.total_count, value), _field(self.probs, value)
        logcomb = (torch.lgamma(n + 1.0) - torch.lgamma(value + 1.0)
                   - torch.lgamma(n - value + 1.0))
        return (logcomb + torch.xlogy(value, p)
                + torch.special.xlog1py(n - value, -p))

    def sample(self, generator, shape=()):
        shape = _draw_shape(shape, self)
        unit = _unit(generator)
        n = _field(self.total_count, unit)
        trials = torch.arange(int(n.max()), device=unit.device)
        u = _uniform(generator, (len(trials),) + shape)
        live = trials.reshape((-1,) + (1,) * len(shape)) < n
        return torch.sum((u < _field(self.probs, unit)) & live,
                         dim=0).to(torch.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class Poisson(Distribution):
    rate: object = 1.0
    support = None

    @property
    def batch_shape(self):
        return _bshape(self.rate)

    def log_prob(self, value):
        value = _value(value, self.rate)
        rate = _field(self.rate, value)
        return torch.xlogy(value, rate) - rate - torch.lgamma(value + 1.0)

    def sample(self, generator, shape=()):
        rate = torch.broadcast_to(_field(self.rate, _unit(generator)),
                                  _draw_shape(shape, self))
        return torch.poisson(rate.contiguous(),
                             generator=generator).to(torch.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class NegativeBinomial(Distribution):
    """Overdispersed counts, (total_count r, probs p):
    log p(k) = log C(k + r - 1, k) + r log(1 - p) + k log p."""

    total_count: object = 1.0
    probs: object = 0.5
    support = None

    @property
    def batch_shape(self):
        return _bshape(self.total_count, self.probs)

    def log_prob(self, value):
        value = _value(value, self.total_count, self.probs)
        r, p = _field(self.total_count, value), _field(self.probs, value)
        return (torch.lgamma(value + r) - torch.lgamma(r)
                - torch.lgamma(value + 1.0)
                + r * torch.log1p(-p) + torch.xlogy(value, p))

    def sample(self, generator, shape=()):
        shape = _draw_shape(shape, self)
        g = _std_gamma(generator, self.total_count, shape)
        p = _field(self.probs, g)
        return torch.poisson(g * p / (1.0 - p),
                             generator=generator).to(torch.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class Categorical(Distribution):
    """Categorical over the last axis of ``logits`` (observation-only for
    HMC, like every discrete distribution here)."""

    logits: object = None  # [..., K]
    support = None

    @property
    def batch_shape(self):
        return tuple(np.shape(self.logits))[:-1]

    def log_prob(self, value):
        logits = _value(self.logits)
        norm = torch.log_softmax(logits, dim=-1)
        index = torch.as_tensor(value, device=logits.device).to(torch.int64)
        shape = torch.broadcast_shapes(index.shape, norm.shape[:-1])
        norm = torch.broadcast_to(norm, shape + norm.shape[-1:])
        index = torch.broadcast_to(index, shape)
        return torch.gather(norm, -1, index[..., None])[..., 0]

    def sample(self, generator, shape=()):
        shape = _draw_shape(shape, self)
        logits = _field(self.logits, _unit(generator))
        probs = torch.broadcast_to(torch.softmax(logits, dim=-1),
                                   shape + logits.shape[-1:])
        flat = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                 replacement=True, generator=generator)
        return flat.reshape(shape)


# -- multivariate ------------------------------------------------------------


class MultivariateNormal(Distribution):
    """MVN with dense covariance (event_dim 1)."""

    event_dim = 1
    support = tfm.IDENTITY

    def __init__(self, loc, cov=None, scale_tril=None):
        self.loc = _value(loc)
        if scale_tril is None:
            if cov is None:
                raise ValueError("need cov or scale_tril")
            scale_tril = torch.linalg.cholesky(
                _field(cov, self.loc).to(self.loc.dtype))
        self.scale_tril = _field(scale_tril, self.loc).to(self.loc.dtype)

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(
            self.loc.shape[:-1], self.scale_tril.shape[:-2]))

    @property
    def event_shape(self):
        return tuple(self.loc.shape[-1:])

    def log_prob(self, value):
        value = _value(value, self.loc)
        loc = self.loc.to(value.device)
        tril = self.scale_tril.to(value.device)
        d = value - loc
        shape = torch.broadcast_shapes(d.shape[:-1], tril.shape[:-2])
        z = torch.linalg.solve_triangular(
            torch.broadcast_to(tril, shape + tril.shape[-2:]),
            torch.broadcast_to(d, shape + d.shape[-1:])[..., None],
            upper=False)[..., 0]
        half_logdet = torch.sum(
            torch.log(torch.diagonal(tril, dim1=-2, dim2=-1)), dim=-1)
        k = loc.shape[-1]
        return (-0.5 * torch.sum(z * z, dim=-1) - half_logdet
                - 0.5 * k * _LOG_2PI)

    def sample(self, generator, shape=()):
        shape = _draw_shape(shape, self)
        eps = _normal(generator, shape + self.event_shape)
        return self.loc.to(eps.device) + torch.einsum(
            "...ij,...j->...i", self.scale_tril.to(eps.device), eps)


__all__ = [
    "Distribution", "Normal", "HalfNormal", "Cauchy", "HalfCauchy",
    "Uniform", "Exponential", "Gamma", "Beta", "LogNormal", "StudentT",
    "Laplace", "InverseGamma", "Weibull",
    "Bernoulli", "BernoulliLogits", "Binomial", "Poisson",
    "NegativeBinomial", "Categorical",
    "MultivariateNormal",
]
