"""Which models the fused CUDA kernels can run: a registry from a model
function of ``examples.py`` (and, for a reparameterised model, the
``reparam`` config it runs under) and its data to a device form of
``ops/kernels.py`` (``FORM_IDS``).

The JAX package traces any model's potential into its TPU kernels. A CUDA
kernel evaluates only what was written for it (``csrc/forms.cuh``), so a
model reaches kernels B and D through an entry here. Every example model
has one, with its normalising constants computed here in float64; so do
the two whose ``reparam="auto"`` rewrite is another known function of q:
the centred eight schools (the non-centred model's potential) and the
funnel (a diagonal quadratic). Every other model, and any other reparam
config, runs the composed engine (autograd through the DSL).
"""

from __future__ import annotations

import inspect
import math
from typing import Callable, Optional

import numpy as np
import torch

from . import examples

Tensor = torch.Tensor

_REGISTRY: dict = {}
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def register(model: Callable, reparam: Optional[str] = None):
    """Register ``build(bound arguments, device) -> (name, params) | None``
    as the device form of ``model``, or of ``model`` under
    ``reparam=<config>`` (a string config such as ``"auto"``)."""
    def deco(build):
        _REGISTRY[(model, reparam)] = build
        return build
    return deco


def device_form_for(model: Callable, model_args: tuple, model_kwargs: dict,
                    device) -> Optional[tuple]:
    """``(name, parameter tensors on device)`` for a registered model
    function called with these arguments, else None. The lookup is by the
    function itself: a wrapper around a registered model (one that
    subsamples a plate, say) is another function and gets None. A
    reparameterised model (``core.reparametrized``) is looked up as the
    model it wraps and its config, so it gets a form only where one is
    registered for that pair."""
    base = getattr(model, "reparam_of", None)
    config = getattr(model, "reparam_config", None)
    if base is None:
        base, config = model, None
    elif not isinstance(config, str):
        return None  # a site list or dict: composed
    build = _REGISTRY.get((base, config))
    if build is None:
        return None
    bound = inspect.signature(base).bind(*model_args, **model_kwargs)
    bound.apply_defaults()
    return build(bound.arguments, torch.device(device))


def _f32(x, device) -> Tensor:
    return torch.as_tensor(x).to(device=device,
                                 dtype=torch.float32).contiguous()


def _number(x) -> Optional[float]:
    """A Python number, or a one-element tensor or array, as a float;
    None for anything else."""
    if isinstance(x, (int, float)):
        return float(x)
    if isinstance(x, (Tensor, np.ndarray)) and np.size(x) == 1:
        return float(np.asarray(torch.as_tensor(x).cpu()).reshape(()))
    return None


@register(examples.logistic_regression)
def _logistic(arguments, device):
    x, labels = _f32(arguments["x"], device), _f32(arguments["labels"],
                                                   device)
    if x.ndim != 2 or labels.shape != x.shape[:1]:
        return None
    return "logistic", (x, labels)


@register(examples.linear_regression)
def _linear(arguments, device):
    x, y = _f32(arguments["x"], device), _f32(arguments["y"], device)
    prior = _number(arguments["prior_scale"])
    if x.ndim != 2 or y.shape != x.shape[:1] or prior is None or prior <= 0:
        return None
    n, p = x.shape
    # -log of the normalisers of w ~ N(0, prior)^P, b ~ N(0, prior),
    # noise ~ HalfNormal(1) and y_n ~ N(., noise), in float64
    const = ((p + 1) * (math.log(prior) + _HALF_LOG_2PI)
             - math.log(2.0) + _HALF_LOG_2PI + n * _HALF_LOG_2PI)
    return "linear", (x, y, torch.tensor([1.0 / prior**2, const],
                                         dtype=torch.float32, device=device))


def _eight_schools_params(arguments, device):
    """(y, sigma, the constant) of either eight-schools model, whose
    normalising constants are the same: -log of the normalisers of mu ~
    N(0, 5), tau ~ HalfCauchy(5), the J standard or tau-scaled normals
    (their log tau is in the potential) and y_j ~ N(., sigma_j), in
    float64."""
    y, sigma = _f32(arguments["y"], device), _f32(arguments["sigma"], device)
    j = int(arguments["J"])
    if y.shape != (j,) or sigma.shape != (j,):
        return None
    const = (math.log(5.0) + _HALF_LOG_2PI
             - math.log(2.0) + math.log(math.pi) + math.log(5.0)
             + j * _HALF_LOG_2PI
             + float(torch.log(sigma.double()).sum()) + j * _HALF_LOG_2PI)
    return y, sigma, torch.tensor([const], dtype=torch.float32,
                                  device=device)


@register(examples.eight_schools_noncentered)
@register(examples.eight_schools, reparam="auto")
def _eight_schools_nc(arguments, device):
    # "auto" decentres theta ~ N(mu, tau) alone: the latent space (mu,
    # tau, theta_decentered) is the non-centred model's, and so is the
    # potential, constants included
    params = _eight_schools_params(arguments, device)
    return None if params is None else ("eight_schools_nc", params)


@register(examples.eight_schools)
def _eight_schools(arguments, device):
    params = _eight_schools_params(arguments, device)
    return None if params is None else ("eight_schools", params)


@register(examples.coin_toss)
def _coin_toss(arguments, device):
    # the Bernoulli observations enter as heads sum(c) and tails
    # sum(1 - c) of each coin; the Uniform(0, 1) priors and the
    # Jacobian's log(hi - lo) add 0
    counts = []
    for name in ("c1", "c2"):
        c = arguments[name]
        if c is None:
            return None
        c = np.asarray(torch.as_tensor(c).cpu(), np.float64)
        counts.append((float(c.sum()) + 1.0, float((1.0 - c).sum()) + 1.0))
    a, b = zip(*counts)
    return "coin", (_f32(a, device), _f32(b, device))


def _funnel_shape(arguments):
    """(dim, scale, the constant) of the funnel model, whose v ~ N(0,
    scale) adds log scale and each of its dim + 1 normal sites half log
    2 pi; None where scale is not a number (a tensor scale would be
    decentred under "auto" too)."""
    scale = arguments["scale"]
    if not isinstance(scale, (int, float)) or scale <= 0:
        return None
    dim = int(arguments["dim"])
    return dim, float(scale), math.log(scale) + (dim + 1) * _HALF_LOG_2PI


@register(examples.funnel)
def _funnel(arguments, device):
    shape = _funnel_shape(arguments)
    if shape is None:
        return None
    dim, scale, const = shape
    return "funnel_model", (
        torch.tensor([2.0 * scale**2, 0.5 * dim], dtype=torch.float32,
                     device=device),
        torch.tensor([const], dtype=torch.float32, device=device))


@register(examples.funnel, reparam="auto")
def _funnel_auto(arguments, device):
    # "auto" decentres x ~ N(0, e^(v / 2)) alone: U = v^2 / (2 scale^2)
    # + |x_decentered|^2 / 2 + const, a diagonal quadratic
    shape = _funnel_shape(arguments)
    if shape is None:
        return None
    dim, scale, const = shape
    k = torch.ones(dim + 1, dtype=torch.float32, device=device)
    k[0] = 1.0 / scale**2
    return "diag_model", (
        k, torch.zeros(dim + 1, dtype=torch.float32, device=device),
        torch.tensor([const], dtype=torch.float32, device=device))
