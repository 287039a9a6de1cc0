"""Model DSL: distributions, transforms, sample/plate handlers, and the
model -> flat-unconstrained-potential adapter (port of the JAX package's
``models``; its NumPyro adapter has no counterpart, NumPyro being
JAX-only)."""

from . import core, device_forms, distributions, examples, potential, \
    transforms
from .core import (
    log_density,
    plate,
    reparam,
    reparametrized,
    sample,
    seed,
    substitute,
    trace,
    trace_model,
)
from .device_forms import device_form_for
from .examples import (
    EIGHT_SCHOOLS_DATA,
    EXAMPLE_MODELS,
    coin_toss,
    eight_schools,
    eight_schools_noncentered,
    funnel,
    linear_regression,
    linear_regression_data,
    logistic_regression,
    logistic_regression_data,
)
from .potential import ModelPotential, make_model_potential

__all__ = [
    "core", "device_forms", "distributions", "examples", "potential",
    "transforms",
    "sample", "plate", "seed", "substitute", "trace", "reparam",
    "reparametrized", "log_density", "trace_model", "device_form_for",
    "ModelPotential", "make_model_potential",
    "EXAMPLE_MODELS", "EIGHT_SCHOOLS_DATA", "coin_toss", "eight_schools",
    "eight_schools_noncentered", "logistic_regression", "linear_regression",
    "funnel", "logistic_regression_data", "linear_regression_data",
]
