"""A run of a cell driven on the CPU at a small size, through the kernels'
plain versions (they draw the fused kernels' Philox stream), with the
harness's look for a card skipped."""

from __future__ import annotations

import types

import torch

from portbench import harness


def small_cell(name: str, walkers: int = 64, warmup: int = 24,
               samples: int = 8) -> dict:
    cell = harness.load_cell(name)
    cell["traffic_mix"] = dict(cell["traffic_mix"], walkers=walkers,
                               warmup=warmup, samples=samples)
    cell["file"] = dict(cell["file"], setup_warmup=20,
                        check=dict(walkers=walkers, transitions=3))
    if "num_rows" in cell["cfg"]:
        # the kernels' plain versions take the rows one by one on the CPU
        cell["cfg"] = dict(cell["cfg"], num_rows=32)
    if "max_steps" in cell["cfg"]["sampler_kwargs"]:
        # a fault that drives the step size to nothing runs the most steps
        cell["cfg"]["sampler_kwargs"] = dict(cell["cfg"]["sampler_kwargs"],
                                             max_steps=32)
    return cell


def fused_on_cpu(monkeypatch) -> None:
    """Let the samplers run their fused engine on CPU tensors (the plain
    versions of kernels A and B), as they run it on the card."""
    from physicsbasedbayesianinference_tpu_torch import chees, hmc

    def fused(kernel, potential_fn, q, **kw):
        return "fused"
    monkeypatch.setattr(hmc, "resolve_engine", fused)
    monkeypatch.setattr(chees, "resolve_engine", fused)


def cpu_run(cell: dict, seed: int = 2**31 + 11, seconds: float = 0.0,
            trace: int = 0, rank: int = 0, world: int = 1, jobs=True):
    """Set-up and window of a run on the CPU (only its inputs without
    ``jobs``); returns the run."""
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    run = harness.Run(cell, args, rank, world, device=torch.device("cpu"))
    run.setup(warm=jobs)
    if jobs:
        run.window()
    run.peak = 0
    return run
