"""Model -> flat unconstrained potential: where the sampler meets the model
(port of the JAX package's ``models/potential.py``).

    mp = make_model_potential(model, model_args, model_kwargs)
    mp.potential(q)        # [D] -> scalar, log|Jacobian| terms included
    mp.unflatten(q)        # -> {site: constrained value}
    mp.flatten(params)     # -> [D] unconstrained
    mp.init(rng, walkers)  # init positions [W, D]

HMC runs in unconstrained R^D; sites with a constrained support go through
the bijections of ``transforms.py``, with their Jacobian corrections added
to the log density, as NumPyro does.

``mp.potential`` stays a per-walker function, so
``ops.potentials.batched_value_and_grad`` differentiates it through
``torch.func.vmap(grad_and_value(...))``: the composed route, which runs
any DSL model on any device. A model that ``device_forms.py`` knows also
carries ``potential.device_form``, and the fused CUDA kernels run it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from . import core
from .device_forms import device_form_for

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class _SiteSpec:
    name: str
    shape: tuple
    size: int
    offset: int
    transform: object  # transforms.Transform


def _generator(rng: Union[int, torch.Generator], device) -> torch.Generator:
    return (rng if isinstance(rng, torch.Generator)
            else core._generator(int(rng), device))


@dataclasses.dataclass(frozen=True)
class ModelPotential:
    """Flat unconstrained potential of a traced model (see module doc)."""

    model: Callable
    model_args: tuple
    model_kwargs: dict
    specs: tuple  # of _SiteSpec, in site order
    num_dims: int
    device: torch.device
    potential: Callable[[Tensor], Tensor] = dataclasses.field(
        default=None, repr=False)

    # -- packing ------------------------------------------------------------

    def unflatten(self, q: Tensor) -> dict:
        """q: [..., D] unconstrained -> {name: constrained value}."""
        out = {}
        for spec in self.specs:
            x = q[..., spec.offset:spec.offset + spec.size]
            x = x.reshape(q.shape[:-1] + spec.shape)
            out[spec.name] = spec.transform.forward(x)
        return out

    def unflatten_unconstrained(self, q: Tensor) -> dict:
        out = {}
        for spec in self.specs:
            x = q[..., spec.offset:spec.offset + spec.size]
            out[spec.name] = x.reshape(q.shape[:-1] + spec.shape)
        return out

    def flatten(self, params: dict) -> Tensor:
        """{name: constrained value} -> [D] unconstrained."""
        parts = []
        for spec in self.specs:
            y = torch.as_tensor(params[spec.name])
            x = spec.transform.inverse(y)
            parts.append(
                x.reshape(x.shape[:x.ndim - len(spec.shape)] + (-1,))
                if spec.shape else torch.atleast_1d(x))
        return torch.cat(parts, dim=-1)

    # -- density ------------------------------------------------------------

    def log_density_unconstrained(self, q: Tensor) -> Tensor:
        """log pi(q) = log p(T(q), data) + sum log|dT/dq| for one q: [D]."""
        logdet = torch.zeros((), dtype=q.dtype, device=q.device)
        params = {}
        for spec in self.specs:
            x = q[spec.offset:spec.offset + spec.size].reshape(spec.shape)
            params[spec.name] = spec.transform.forward(x)
            logdet = logdet + torch.sum(spec.transform.log_det_jacobian(x))
        logp, _ = core.log_density(
            self.model, self.model_args, self.model_kwargs, params)
        return logp + logdet

    # -- initialisation ------------------------------------------------------

    def init(self, rng: Union[int, torch.Generator], num_walkers: int, *,
             strategy: str = "uniform", jitter: float = 0.0) -> Tensor:
        """Initial positions [num_walkers, D] (unconstrained), drawn with
        ``rng`` (an int seed, or a ``torch.Generator``) on the potential's
        device (a generator's own device if one is given).

        ``strategy="uniform"`` (default) draws q ~ U(-2, 2)^D, the
        Stan/NumPyro convention, robust to heavy-tailed priors (a
        HalfCauchy prior draw can strand a walker at tau ~ 1e4).
        ``strategy="prior"`` seeds each walker from a prior draw, one run
        of the model a walker.
        """
        gen = _generator(rng, self.device)
        if strategy == "uniform":
            q = 4.0 * torch.rand((num_walkers, self.num_dims), generator=gen,
                                 device=gen.device) - 2.0
        elif strategy == "prior":
            rows = []
            for _ in range(num_walkers):
                sites = core.trace_model(
                    self.model, self.model_args, self.model_kwargs, rng=gen)
                rows.append(self.flatten(
                    {name: s.value for name, s in sites.items()
                     if not s.is_observed}))
            q = torch.stack(rows)
        else:
            raise ValueError(f"unknown init strategy {strategy!r}")
        if jitter:
            q = q + jitter * torch.randn(q.shape, generator=gen,
                                         device=gen.device, dtype=q.dtype)
        return q

    def constrain_samples(self, samples: Tensor) -> dict:
        """[..., D] unconstrained samples -> named constrained tensors."""
        return self.unflatten(samples)

    def trace_values(self, q: Tensor) -> dict:
        """Every non-observed site's value at ``q: [D]`` (or batched ``[...,
        D]``, by vmap over the leading axes), deterministic sites included:
        a reparameterised model (``reparam=``) still reports the original
        named quantities (centred eight-schools' ``theta`` when the latent
        space carries ``theta_decentered``)."""
        def one(qv):
            sites = core.trace_model(
                self.model, self.model_args, self.model_kwargs,
                params=self.unflatten(qv))
            return {name: torch.as_tensor(s.value, device=qv.device)
                    for name, s in sites.items() if not s.is_observed}

        for _ in range(q.ndim - 1):
            one = torch.func.vmap(one)
        return one(q)


def data_to_device(value, device):
    """Data of a model: a tensor or numpy array becomes a tensor on
    ``device`` (floats as float32); anything else (a Python int such as a
    plate size) stays as it is."""
    if isinstance(value, (Tensor, np.ndarray)):
        t = torch.as_tensor(value)
        if t.is_floating_point():
            t = t.to(torch.float32)
        return t.to(device)
    return value


def make_model_potential(
    model: Callable,
    model_args: tuple = (),
    model_kwargs: Optional[dict] = None,
    *,
    reparam=None,
    device=None,
) -> ModelPotential:
    """Trace the model once (prior seed) to find its latent sites, shapes
    and supports; return a :class:`ModelPotential` whose ``potential`` is a
    per-walker ``q:[D] -> scalar`` negative log density, ready for
    ``build_hmc_kernel`` and ``run_chees_hmc``.

    ``reparam``: ``"auto"``, a collection of site names or a ``{name:
    bool}`` dict: non-centre the selected loc-scale sites
    (:class:`..core.reparam`); the latent space then carries the
    ``*_decentered`` coordinates and the original names become
    deterministic sites (:meth:`ModelPotential.trace_values` gives them
    back). ``device``: where the model's data tensors are put, once
    (``device.default_device()`` unless given).

    ``potential.device_form`` is the model's device form where
    ``device_forms.py`` has one (not for a reparameterised wrapper), else
    None."""
    device = resolve_device(device)
    model_args = tuple(data_to_device(a, device) for a in model_args)
    model_kwargs = {k: data_to_device(v, device)
                    for k, v in (model_kwargs or {}).items()}
    form = (device_form_for(model, model_args, model_kwargs, device)
            if reparam is None else None)
    if reparam is not None:
        model = core.reparametrized(model, reparam)
    sites = core.trace_model(model, model_args, model_kwargs,
                             rng=_generator(0, device))
    specs = []
    offset = 0
    for name, site in sites.items():
        if site.is_observed or site.is_deterministic:
            continue
        if site.dist.support is None:
            raise ValueError(
                f"latent site {name!r} has discrete distribution "
                f"{type(site.dist).__name__}; HMC requires continuous "
                f"latents (marginalise or condition it)")
        shape = tuple(np.shape(site.value))
        size = math.prod(shape) if shape else 1
        specs.append(_SiteSpec(
            name=name, shape=shape, size=size, offset=offset,
            transform=site.dist.support))
        offset += size
    if offset == 0:
        raise ValueError("model has no latent sites")

    mp = ModelPotential(
        model=model, model_args=model_args, model_kwargs=model_kwargs,
        specs=tuple(specs), num_dims=offset, device=device)

    def potential(q: Tensor) -> Tensor:
        return -mp.log_density_unconstrained(q)

    potential.name = getattr(model, "__name__", "model")  # type: ignore
    potential.analytic_grad = None  # type: ignore
    potential.diag_quadratic = None  # type: ignore
    potential.device_form = form  # type: ignore
    object.__setattr__(mp, "potential", potential)
    return mp
