"""A job of ensemble HMC: one call of the program's ``run_hmc``, and what
the reference needs to follow it."""

from __future__ import annotations


def call(seed: int, potential, q0, *, cfg: dict, traffic: dict, mesh,
         kernel: str) -> dict:
    """``run_hmc`` takes the rank's block of the starting points."""
    from physicsbasedbayesianinference_tpu_torch import run_hmc
    if mesh is not None:
        q0 = q0[mesh.block(q0.shape[0])].contiguous()
    res = run_hmc(seed, potential, q0, num_warmup=traffic["warmup"],
                  num_samples=traffic["samples"], collect=traffic["collect"],
                  kernel=kernel, mesh=mesh, **cfg["sampler_kwargs"])
    return {"samples": res.samples, "step_size": res.step_size,
            "tau": None, "mass": res.mass,
            "mean_num_steps": cfg["sampler_kwargs"]["num_steps"],
            "sampling_seconds": res.sampling_seconds,
            "engines": {"warmup": res.kernel_used,
                        "sampling": res.kernel_used}}


def reference_count(cfg: dict, tau):
    """``count(h, eps)``: the fixed leapfrog count L."""
    num_steps = cfg["sampler_kwargs"]["num_steps"]

    def count(h: float, eps: float) -> int:
        return num_steps
    return count


def sampling_counts(cfg: dict, traffic: dict, step_size: float,
                    tau) -> list:
    return [[cfg["sampler_kwargs"]["num_steps"]]] * traffic["samples"]
