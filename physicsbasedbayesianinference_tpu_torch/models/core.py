"""The model DSL: sample and plate statements under effect handlers (port
of the JAX package's ``models/core.py``).

A model is a plain Python function with ``sample(name, dist, obs=...)``
statements, optionally inside ``plate`` blocks, consumed through
``log_density(model, args, kwargs, params)``: NumPyro's contract, on a
minimal handler stack (seed / substitute / trace / reparam). The model
function runs once per evaluation and emits torch operations; under
``torch.func.vmap(grad_and_value(...))`` it runs once for the whole batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import zlib
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from ..device import default_device
from .distributions import Distribution

Tensor = torch.Tensor

_HANDLER_STACK: list = []
_PLATE_STACK: list = []
_MASK63 = (1 << 63) - 1


@dataclasses.dataclass
class Site:
    """One recorded sample statement."""

    name: str
    dist: Distribution
    value: Any
    is_observed: bool
    log_prob: Optional[Tensor] = None
    # plate-subsampling likelihood rescale: the product over the active
    # plates of size / subsample_size
    scale: float = 1.0
    # a value computed from other sites (a reparameterised site): it adds
    # no log_prob and is not a latent dimension
    is_deterministic: bool = False


def _mix(seed: int, *words: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``words`` (splitmix64 steps),
    the same in every process."""
    x = seed & 0xFFFFFFFFFFFFFFFF
    for word in words:
        x = (x ^ word) + 0x9E3779B97F4A7C15 & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 31
    return x & _MASK63


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & _MASK63)
    return gen


class _Handler:
    def process(self, name: str, dist: Distribution, obs) -> tuple:
        """Return (value, handled: bool)."""
        raise NotImplementedError

    def postprocess(self, site: Site) -> None:
        pass

    def __enter__(self):
        _HANDLER_STACK.append(self)
        return self

    def __exit__(self, *exc):
        assert _HANDLER_STACK.pop() is self


class seed(_Handler):
    """Draw unobserved sites from their priors: with a ``torch.Generator``,
    one site after the other from it; with an int, site k from a generator
    seeded from (the int, k) on ``device`` (the default device unless
    given)."""

    def __init__(self, rng: Union[int, torch.Generator], device=None):
        self.rng = rng
        self.device = (rng.device if isinstance(rng, torch.Generator)
                       else torch.device(device) if device is not None
                       else default_device())
        self._count = 0

    def base_seed(self) -> int:
        return (self.rng.initial_seed()
                if isinstance(self.rng, torch.Generator) else int(self.rng))

    def process(self, name, dist, obs):
        if obs is not None:
            return obs, True
        self._count += 1
        gen = (self.rng if isinstance(self.rng, torch.Generator)
               else _generator(_mix(int(self.rng), self._count), self.device))
        return dist.sample(gen, _plate_shape(dist)), True


class substitute(_Handler):
    """Fix named latent sites to given values (constrained space)."""

    def __init__(self, params: dict):
        self.params = params

    def process(self, name, dist, obs):
        if obs is not None:
            return obs, True
        if name in self.params:
            return self.params[name], True
        return None, False


class trace(_Handler):
    """Record every site (value + log_prob) into ``self.sites``."""

    def __init__(self):
        self.sites: dict[str, Site] = {}

    def process(self, name, dist, obs):
        return None, False

    def postprocess(self, site):
        if site.name in self.sites:
            raise ValueError(f"duplicate sample site {site.name!r}")
        self.sites[site.name] = site


# Loc-scale families: dist(loc, scale) == loc + scale * dist(0, 1) with all
# other fields held fixed, which is what the reparameterisation relies on.
def _loc_scale_types():
    from . import distributions as d
    return (d.Normal, d.Cauchy, d.StudentT, d.Laplace)


DECENTERED_SUFFIX = "_decentered"


class reparam(_Handler):
    """Non-centering handler: rewrite selected latent loc-scale sites
    ``x ~ D(loc, scale)`` as an auxiliary standard site ``x_decentered ~
    D(0, 1)`` with the deterministic value ``x = loc + scale *
    x_decentered``. Same joint density, another geometry: a centred
    hierarchical model puts HMC in a funnel where the step size must track
    the scale; the non-centred coordinates decouple the hierarchy.

    ``config``: ``"auto"`` reparameterises every latent loc-scale site
    whose loc or scale is a ``torch.Tensor`` (computed from other latents;
    constants stay Python numbers); an iterable of site names exactly
    those; a dict ``{name: bool}`` gives per-site control.
    """

    def __init__(self, config="auto"):
        if isinstance(config, str) and config != "auto":
            config = [config]  # one site name, not its characters
        if config != "auto" and not isinstance(config, dict):
            config = {name: True for name in config}
        self.config = config
        self._rewritten: set = set()

    def _selected(self, name: str, dist) -> bool:
        if name.endswith(DECENTERED_SUFFIX):
            return False
        if not isinstance(dist, _loc_scale_types()):
            return False
        if isinstance(self.config, dict):
            return bool(self.config.get(name, False))
        return isinstance(dist.loc, Tensor) or isinstance(dist.scale, Tensor)

    def process(self, name, dist, obs):
        if obs is not None or not self._selected(name, dist):
            return None, False
        base = dataclasses.replace(dist, loc=0.0, scale=1.0)
        z = sample(name + DECENTERED_SUFFIX, base)
        self._rewritten.add(name)
        return dist.loc + dist.scale * z, True

    def postprocess(self, site):
        if site.name in self._rewritten:
            site.is_deterministic = True
            site.log_prob = torch.zeros_like(torch.as_tensor(site.log_prob))


def reparametrized(model: Callable, config="auto") -> Callable:
    """Wrap a model so that it always runs under :class:`reparam`; the
    wrapped model's latent space uses the decentered coordinates. The
    wrapper names what it wraps (``reparam_of``, ``reparam_config``), so
    that ``device_forms.py`` can find a form registered for the pair."""
    def wrapped(*args, **kwargs):
        with reparam(config):
            return model(*args, **kwargs)
    wrapped.__name__ = getattr(model, "__name__", "model") + "_reparam"
    wrapped.reparam_of = model
    wrapped.reparam_config = config
    return wrapped


@dataclasses.dataclass
class _Plate:
    name: str
    size: int
    dim: int                       # negative, NumPyro convention
    subsample_size: int            # == size when not subsampling
    idx: Any                       # [subsample_size] int indices into 0..size


@contextlib.contextmanager
def plate(name: str, size: int, subsample_size: Optional[int] = None,
          dim: Optional[int] = None,
          generator: Optional[torch.Generator] = None):
    """Conditionally independent batch dimension, with NumPyro's semantics.

    * ``dim`` is the (negative) batch axis this plate controls. When
      omitted it is the rightmost dim not taken by an enclosing plate, so
      samples inside ``plate(a) > plate(b)`` have shape ``(size_b,
      size_a)``.
    * ``subsample_size`` enables minibatch subsampling: the block yields a
      ``[subsample_size]`` index tensor (to slice observed data with),
      sample statements inside draw ``subsample_size`` copies along
      ``dim``, and their log probabilities are rescaled by ``size /
      subsample_size``. The indices are a function of a seed, the same at
      every run of the model: ``generator``'s initial seed if one is given
      (the generator is not advanced), else one derived from the enclosing
      :class:`seed` handler's seed and the CRC of the plate's name.

    Yields the index tensor (``arange(size)`` when not subsampling).
    """
    size = int(size)
    if dim is None:
        used = {p.dim for p in _PLATE_STACK}
        dim = -1
        while dim in used:
            dim -= 1
    else:
        dim = int(dim)
        if dim >= 0:
            raise ValueError(f"plate dim must be negative, got {dim}")
        if any(p.dim == dim for p in _PLATE_STACK):
            raise ValueError(
                f"plate {name!r}: dim {dim} already taken by an enclosing "
                f"plate")
    if subsample_size is not None and int(subsample_size) > size:
        raise ValueError(
            f"plate {name!r}: subsample_size={int(subsample_size)} exceeds "
            f"size={size}")
    if subsample_size is None or int(subsample_size) == size:
        sub, idx = size, torch.arange(size)
    else:
        sub = int(subsample_size)
        base = None if generator is None else generator.initial_seed()
        if base is None:
            for handler in reversed(_HANDLER_STACK):
                if isinstance(handler, seed):
                    # a deterministic digest (Python's hash() is salted per
                    # process), under a tag of its own, apart from the
                    # small per-site counters of seed.process
                    digest = zlib.crc32(name.encode("utf-8")) & 0x7FFFFFFF
                    base = _mix(handler.base_seed(), 0x504C4154, digest)
                    break
        if base is None:
            raise ValueError(
                f"plate {name!r}: subsample_size={sub} needs randomness: "
                f"pass generator=... or run the model under seed(...)")
        # drawn with numpy from the seed alone: the same indices at every
        # run of the model, as a JAX key gives, and no torch random
        # operation, which vmap would refuse
        idx = torch.as_tensor(
            np.random.default_rng(base).permutation(size)[:sub])
    _PLATE_STACK.append(_Plate(name, size, dim, sub, idx))
    try:
        yield idx
    finally:
        _PLATE_STACK.pop()


def _plate_shape(dist: Distribution) -> tuple:
    """Batch shape implied by the active plates: each plate's (sub)size at
    its own dim, broadcast with the distribution's own batch shape."""
    if not _PLATE_STACK:
        return tuple(dist.batch_shape)
    ndim = max(-p.dim for p in _PLATE_STACK)
    shape = [1] * ndim
    for p in _PLATE_STACK:
        shape[p.dim] = p.subsample_size
    return tuple(torch.broadcast_shapes(tuple(shape), dist.batch_shape))


def _plate_scale() -> float:
    scale = 1.0
    for p in _PLATE_STACK:
        if p.subsample_size != p.size:
            scale *= p.size / p.subsample_size
    return scale


def sample(name: str, dist: Distribution, obs=None):
    """A sample statement. Under no handler, requires ``obs``."""
    value = obs
    for handler in reversed(_HANDLER_STACK):
        v, handled = handler.process(name, dist, obs)
        if handled:
            value = v
            break
    if value is None:
        raise RuntimeError(
            f"latent site {name!r} reached bottom of handler stack; run the "
            f"model under seed(...) or substitute(params)")
    site = Site(name=name, dist=dist, value=value, is_observed=obs is not None,
                scale=_plate_scale())
    site.log_prob = dist.log_prob(value)
    for handler in reversed(_HANDLER_STACK):
        handler.postprocess(site)
    return value


def log_density(model: Callable, model_args: tuple, model_kwargs: dict,
                params: dict) -> tuple[Tensor, dict]:
    """Joint log density of the model at constrained ``params``; returns
    ``(logp, sites)`` as ``numpyro.infer.util.log_density`` does."""
    with trace() as tr, substitute(params):
        model(*model_args, **model_kwargs)
    total = None
    for site in tr.sites.values():
        if site.is_deterministic:
            continue
        lp = torch.sum(site.log_prob)
        lp = site.scale * lp if site.scale != 1.0 else lp
        total = lp if total is None else total + lp
    if total is None:
        total = torch.zeros(())
    return total, tr.sites


def trace_model(model: Callable, model_args: tuple = (),
                model_kwargs: Optional[dict] = None, *,
                rng: Union[None, int, torch.Generator] = None,
                params: Optional[dict] = None) -> dict[str, Site]:
    """Run the model and return its site dict; latent sites come from
    ``params`` when given, else from prior draws with ``rng`` (an int seed
    or a ``torch.Generator``; 0 unless given)."""
    model_kwargs = model_kwargs or {}
    ctx: Any
    if params is not None:
        ctx = substitute(params)
    else:
        ctx = seed(rng if rng is not None else 0)
    with trace() as tr, ctx:
        model(*model_args, **model_kwargs)
    return tr.sites
