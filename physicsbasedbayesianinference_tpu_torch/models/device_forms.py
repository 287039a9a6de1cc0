"""Which models the fused CUDA kernels can run: a registry from a model
function of ``examples.py`` and its data to a device form of
``ops/kernels.py`` (``FORM_IDS``).

The JAX package traces any model's potential into its TPU kernels. A CUDA
kernel evaluates only what was written for it (``csrc/forms.cuh``), so a
model reaches kernels B and D through an entry here; every other model,
and any model under a reparameterising wrapper, runs the composed engine
(autograd through the DSL).
"""

from __future__ import annotations

import inspect
import math
from typing import Callable, Optional

import torch

from . import examples

Tensor = torch.Tensor

_REGISTRY: dict = {}


def register(model: Callable):
    """Register ``build(bound arguments, device) -> (name, params) | None``
    as the device form of ``model``."""
    def deco(build):
        _REGISTRY[model] = build
        return build
    return deco


def device_form_for(model: Callable, model_args: tuple, model_kwargs: dict,
                    device) -> Optional[tuple]:
    """``(name, parameter tensors on device)`` for a registered model
    function called with these arguments, else None. The lookup is by the
    function itself: a wrapper around a registered model (a
    reparameterised one, one that subsamples a plate) is another function
    and gets None."""
    build = _REGISTRY.get(model)
    if build is None:
        return None
    bound = inspect.signature(model).bind(*model_args, **model_kwargs)
    bound.apply_defaults()
    return build(bound.arguments, torch.device(device))


def _f32(x, device) -> Tensor:
    return torch.as_tensor(x).to(device=device,
                                 dtype=torch.float32).contiguous()


@register(examples.logistic_regression)
def _logistic(arguments, device):
    x, labels = _f32(arguments["x"], device), _f32(arguments["labels"],
                                                   device)
    if x.ndim != 2 or labels.shape != x.shape[:1]:
        return None
    return "logistic", (x, labels)


@register(examples.eight_schools_noncentered)
def _eight_schools_nc(arguments, device):
    y, sigma = _f32(arguments["y"], device), _f32(arguments["sigma"], device)
    j = int(arguments["J"])
    if y.shape != (j,) or sigma.shape != (j,):
        return None
    # -log of the normalisers of mu ~ N(0, 5), tau ~ HalfCauchy(5),
    # theta ~ N(0, 1)^J and y_j ~ N(., sigma_j), in float64
    half_log_2pi = 0.5 * math.log(2.0 * math.pi)
    const = (math.log(5.0) + half_log_2pi
             - math.log(2.0) + math.log(math.pi) + math.log(5.0)
             + j * half_log_2pi
             + float(torch.log(sigma.double()).sum()) + j * half_log_2pi)
    return "eight_schools_nc", (
        y, sigma, torch.tensor([const], dtype=torch.float32, device=device))
