"""Bijective constraint transforms, unconstrained R^n <-> support (port of
the JAX package's ``models/transforms.py``).

HMC runs in unconstrained space; each latent site's support is mapped
through one of these bijections and the log|Jacobian| is added to the log
density. Every transform maps elementwise (event_dim 0) unless noted:
``forward(x)`` unconstrained -> constrained; ``inverse(y)`` back;
``log_det_jacobian(x)`` is log|d forward / dx| at unconstrained x, of x's
shape (the caller sums it over event dims). All of them are written out of
place, since they run under ``torch.func.vmap(grad_and_value(...))``.
"""

from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor


def softplus(x: Tensor) -> Tensor:
    """``log(1 + exp(x))``, stable at both ends, with the sigmoid as its
    derivative everywhere (the JAX package writes the primal as ``max(x, 0)
    + log1p(exp(-|x|))`` and gives it a custom derivative for its own
    compiler; the values and gradients are the same)."""
    return torch.nn.functional.softplus(x)


@dataclasses.dataclass(frozen=True)
class Transform:
    """Identity: support = all reals. ``name`` is a class attribute, not a
    dataclass field (subclass constructors stay positional over their own
    parameters)."""

    name = "identity"

    def forward(self, x: Tensor) -> Tensor:
        return x

    def inverse(self, y: Tensor) -> Tensor:
        return y

    def log_det_jacobian(self, x: Tensor) -> Tensor:
        return torch.zeros_like(x)


IDENTITY = Transform()


@dataclasses.dataclass(frozen=True)
class ExpTransform(Transform):
    """y = exp(x): support = positive reals. log|J| = x."""

    name = "exp"

    def forward(self, x: Tensor) -> Tensor:
        return torch.exp(x)

    def inverse(self, y: Tensor) -> Tensor:
        return torch.log(y)

    def log_det_jacobian(self, x: Tensor) -> Tensor:
        return x


POSITIVE = ExpTransform()


@dataclasses.dataclass(frozen=True, eq=False)
class IntervalTransform(Transform):
    """y = lo + (hi - lo) * sigmoid(x): support = (lo, hi); the bounds are
    floats or tensors.

    log|J| = log(hi - lo) - softplus(x) - softplus(-x), in log space
    (float32-safe; never log(sigmoid)).
    """

    lo: float = 0.0
    hi: float = 1.0
    name = "interval"

    def forward(self, x: Tensor) -> Tensor:
        return self.lo + (self.hi - self.lo) * torch.sigmoid(x)

    def inverse(self, y: Tensor) -> Tensor:
        u = (y - self.lo) / (self.hi - self.lo)
        return torch.log(u) - torch.log1p(-u)

    def log_det_jacobian(self, x: Tensor) -> Tensor:
        width = torch.as_tensor(self.hi - self.lo, dtype=x.dtype,
                                device=x.device)
        return torch.log(width) - softplus(x) - softplus(-x)


UNIT_INTERVAL = IntervalTransform(0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class OrderedTransform(Transform):
    """y_0 = x_0; y_i = y_{i-1} + exp(x_i): support = increasing vectors.

    Event dim 1 (acts on the last axis). log|J| = sum_{i>0} x_i.
    """

    name = "ordered"

    def forward(self, x: Tensor) -> Tensor:
        first = x[..., :1]
        rest = torch.exp(x[..., 1:])
        return torch.cat([first, first + torch.cumsum(rest, dim=-1)], dim=-1)

    def inverse(self, y: Tensor) -> Tensor:
        return torch.cat([y[..., :1], torch.log(torch.diff(y, dim=-1))],
                         dim=-1)

    def log_det_jacobian(self, x: Tensor) -> Tensor:
        # elementwise, zero at index 0, so that the caller's sum over the
        # event axis gives the total
        return torch.cat([torch.zeros_like(x[..., :1]), x[..., 1:]], dim=-1)


ORDERED = OrderedTransform()
