"""A job of ChEES-HMC: one call of the program's ``run_chees_hmc``, and
what the reference needs to follow it (each sampling transition's
leapfrog count)."""

from __future__ import annotations

import torch

from portbench.reference.hmc import chees_count, halton


def call(seed: int, potential, q0, *, cfg: dict, traffic: dict, mesh,
         kernel: str) -> dict:
    """The whole ensemble's starting points ``q0`` go in on every rank;
    the sampler takes the rank's block."""
    from physicsbasedbayesianinference_tpu_torch import run_chees_hmc
    res = run_chees_hmc(seed, potential, q0, num_warmup=traffic["warmup"],
                        num_samples=traffic["samples"],
                        collect=traffic["collect"], kernel=kernel, mesh=mesh,
                        **cfg["sampler_kwargs"])
    return {"samples": res.samples, "step_size": res.step_size,
            "tau": res.trajectory_time, "mass": res.state.ensemble.mass,
            "mean_num_steps": res.mean_num_steps,
            "sampling_seconds": res.sampling_seconds,
            "engines": {"warmup": res.warmup_kernel_used,
                        "sampling": res.kernel_used}}


def reference_count(cfg: dict, tau: float):
    """``count(h, eps)``: the leapfrog count of a transition of jitter h at
    step size eps and the adapted ``tau``, in the reference's arithmetic."""
    top = cfg["sampler_kwargs"]["max_steps"]

    def count(h: float, eps: float) -> int:
        return chees_count(h, tau, eps, top)
    return count


def sampling_counts(cfg: dict, traffic: dict, step_size: float,
                    tau: float) -> list:
    """[S] lists of the leapfrog counts of each sampling transition, as the
    sampler computes them in float32: clip(round(2 h tau / eps), 1,
    max_steps); both neighbours where the quotient sits within 1e-4 of a
    rounding edge."""
    w, s = traffic["warmup"], traffic["samples"]
    h = torch.as_tensor(halton(w + s)[w:], dtype=torch.float32)
    x = (2.0 * h * torch.tensor(tau, dtype=torch.float32)
         ) / torch.tensor(step_size, dtype=torch.float32)
    top = cfg["sampler_kwargs"]["max_steps"]
    out = []
    for v in x.tolist():
        n = {min(max(round(v), 1), top)}
        if abs(v - int(v) - 0.5) < 1e-4:
            n |= {min(max(int(v) + k, 1), top) for k in (0, 1)}
        out.append(sorted(n))
    return out
