"""ChEES on the example models' new fused routes, on the CPU: the fused
engine (kernel B's plain versions of the models' device forms, which the
card runs as the CUDA kernel) against the composed engine (autograd
through the DSL) on the same model and start, each from its own draws.

W = 512 walkers, 150 warmup and 100 sampling transitions. Limits: counting
each walker's time average as one independent draw, the difference of the
two runs' means has a standard error of sqrt(2 / W) = 0.0625 sd and that
of their variances sqrt(4 / W) = 0.088 of the variance; the gates are four
of those, 0.25 sd and 0.35. The centred funnel's x has heavy tails (its
variance is E[e^v] = e^4.5) that neither run explores in 250 transitions,
so only its v is compared there. Where the posterior has a closed form
(the coins' logit-Beta posteriors, the decentred funnel), the fused run is
also held to it with the same limits (sqrt(1 / W) each: 0.18 sd and
0.25)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import physicsbasedbayesianinference_tpu_torch as pt
from physicsbasedbayesianinference_tpu_torch import chees as tc
from physicsbasedbayesianinference_tpu_torch import models as tm

ROOT = Path(__file__).resolve().parent.parent
W, WARMUP, SAMPLES = 512, 150, 100


def _coin_data():
    with open(ROOT / "examples" / "coin_toss.data.json") as f:
        raw = json.load(f)
    return {k: np.asarray(raw[k], np.float32) for k in ("c1", "c2")}


# (model, args, kwargs, reparam, init step, the form it gets, the dims
# compared with the composed run)
ROUTES = {
    "linear_regression": (tm.linear_regression,
                          tm.linear_regression_data(16, 4), {}, None, 0.05,
                          "linear", None),
    "eight_schools": (tm.eight_schools, (), tm.EIGHT_SCHOOLS_DATA, None,
                      0.2, "eight_schools", None),
    "eight_schools reparam=auto": (tm.eight_schools, (),
                                   tm.EIGHT_SCHOOLS_DATA, "auto", 0.2,
                                   "eight_schools_nc", None),
    "coin_toss": (tm.coin_toss, (), _coin_data(), None, 0.5, "coin", None),
    "funnel": (tm.funnel, (), {"dim": 5}, None, 0.2, "funnel_model", [0]),
    "funnel reparam=auto": (tm.funnel, (), {"dim": 5}, "auto", 0.5,
                            "diag_model", None),
}


def _closed_form(route, mp):
    """(mean, var) of q where the posterior has a closed form, else None:
    the logit of a Beta(a, b) variable has mean digamma(a) - digamma(b)
    and variance trigamma(a) + trigamma(b); the decentred funnel is v ~
    N(0, 3^2) beside standard normals."""
    if route == "coin_toss":
        data = _coin_data()
        a = torch.tensor([data[k].sum() + 1.0 for k in ("c1", "c2")],
                         dtype=torch.float64)
        b = torch.tensor([(1.0 - data[k]).sum() + 1.0 for k in ("c1", "c2")],
                         dtype=torch.float64)
        return (torch.special.digamma(a) - torch.special.digamma(b),
                torch.special.polygamma(1, a) + torch.special.polygamma(1, b))
    if route == "funnel reparam=auto":
        var = torch.ones(mp.num_dims, dtype=torch.float64)
        var[0] = 9.0
        return torch.zeros(mp.num_dims, dtype=torch.float64), var
    return None


@pytest.mark.parametrize("route", list(ROUTES))
def test_fused_chees_on_cpu_matches_composed(route, monkeypatch):
    model, args, kwargs, reparam, step, form, dims = ROUTES[route]
    mp = tm.make_model_potential(model, args, kwargs, reparam=reparam,
                                 device="cpu")
    assert mp.potential.device_form[0] == form
    q0 = 0.3 * torch.as_tensor(np.random.default_rng(0).normal(
        size=(W, mp.num_dims)).astype(np.float32))
    kw = dict(num_warmup=WARMUP, num_samples=SAMPLES, init_step_size=step,
              max_steps=32, collect="moments")
    composed = pt.run_chees_hmc(3, mp.potential, q0, **kw)
    monkeypatch.setattr(tc, "resolve_engine", lambda *a, **k: "fused")
    fused = pt.run_chees_hmc(3, mp.potential, q0, **kw)
    assert (fused.kernel_used, fused.warmup_kernel_used) == ("fused",
                                                             "fused")
    assert (composed.kernel_used, composed.warmup_kernel_used) == (
        "composed", "composed")
    for res in (fused, composed):
        assert bool(torch.isfinite(res.mean).all())
        assert bool(torch.isfinite(res.var).all())
        assert 0.5 <= float(res.accept_rate) <= 0.99
    keep = slice(None) if dims is None else dims
    sd = torch.sqrt(composed.var[keep])
    mean_err = ((fused.mean[keep] - composed.mean[keep]) / sd).abs().max()
    var_err = (fused.var[keep] / composed.var[keep] - 1.0).abs().max()
    assert float(mean_err) < 0.25, (route, float(mean_err))
    assert float(var_err) < 0.35, (route, float(var_err))
    exact = _closed_form(route, mp)
    if exact is not None:
        mean, var = exact
        mean_err = ((fused.mean.double() - mean) / var.sqrt()).abs().max()
        var_err = (fused.var.double() / var - 1.0).abs().max()
        assert float(mean_err) < 0.18 and float(var_err) < 0.25, (
            route, float(mean_err), float(var_err))
