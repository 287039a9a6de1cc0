"""Plain reference of Bayesian logistic regression (w ~ N(0, 1)^P,
b ~ N(0, 1), labels ~ Bernoulli(logits = x w + b)), q = (w, b), and the
benchmark's inputs for it: the data by the recipe of the JAX package's
``benchmarks/model_bench.py`` target ``logreg_32_n256`` (normal features,
normal true weights, labels drawn from their sigmoid) at the recipe's own
seeds, and the walkers' starting points, uniform on (-2, 2)^D, as the
program's model DSL starts them. Imports nothing of the program."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.hmc import Precision, to_tf32


def make_data(cfg: dict, seed: int, device) -> dict:
    """``x`` [N, P] and ``labels`` [N], float32 on ``device``: features
    and true weights normal, labels ``uniform < sigmoid(x w_true)``, each
    from its stream of the configuration's ``data_seeds``. The run's
    ``seed`` takes no part: a posterior of its own for each seed would
    change a job's work (its adapted trajectory length) from run to run."""
    n, p = cfg["num_rows"], cfg["num_features"]
    rng = [np.random.default_rng(s) for s in cfg["data_seeds"]]
    x = rng[0].normal(size=(n, p)).astype(np.float32)
    w_true = rng[1].normal(size=p).astype(np.float32)
    u = rng[2].uniform(size=n)
    labels = (u < 1.0 / (1.0 + np.exp(-(x @ w_true)))).astype(np.float32)
    return {"x": torch.from_numpy(x).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def init_q(cfg: dict, num_walkers: int, gen: torch.Generator) -> torch.Tensor:
    """[W, D] float32 starting points, uniform on (-2, 2)."""
    d = cfg["num_features"] + 1
    return 4.0 * torch.rand(num_walkers, d, generator=gen,
                            device=gen.device) - 2.0


def value_and_grad(data: dict, prec: Precision):
    """``vg(q) -> (U [W], dU/dq [W, D])`` in ``prec``: U = |q|^2 / 2 +
    sum_n softplus(z_n) - y_n z_n with z = x w + b (the normalising
    constants left out: only differences of U enter)."""
    dt = prec.dtype
    xa = torch.cat([data["x"], torch.ones_like(data["x"][:, :1])],
                   dim=1).to(dt)
    y = data["labels"].to(dt)

    def mm(a, b):
        if prec.tf32:
            return to_tf32(a.contiguous()) @ to_tf32(b.contiguous())
        return a @ b

    def vg(q):
        z = mm(q, xa.T.to(q.dtype))
        lik = (torch.clamp_min(z, 0.0) + torch.log1p(torch.exp(-torch.abs(z)))
               - y.to(q.dtype) * z)
        r = torch.sigmoid(z) - y.to(q.dtype)
        u = 0.5 * torch.sum(q * q, dim=1) + torch.sum(lik, dim=1)
        return u, q + mm(r, xa.to(q.dtype))
    return vg
