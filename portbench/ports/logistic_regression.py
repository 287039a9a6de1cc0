"""The program's potential of Bayesian logistic regression: the model
function of its examples through its model DSL, which routes it to kernel
B's logistic device form, as its CLI builds ``example:logistic_regression``."""

from __future__ import annotations


def potential(data: dict, cfg: dict, device):
    from physicsbasedbayesianinference_tpu_torch.models import (
        make_model_potential)
    from physicsbasedbayesianinference_tpu_torch.models.examples import (
        logistic_regression)
    mp = make_model_potential(logistic_regression, (),
                              {"x": data["x"], "labels": data["labels"]},
                              device=device)
    return mp.potential
