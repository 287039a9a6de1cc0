#!/usr/bin/env python3
"""Where a transition of the main paths spends its time, on the card.

    python3 tools/measure_main_path.py [--repeats 4] [--target TARGET]

from the repository root, on a GPU. ``run_hmc`` at the bench configuration
(32-dim standard normal, 102400 walkers, 16 leapfrog steps, fused kernel
A) or, with ``--target correlated``, at the same shape on the correlated
32-dim Gaussian of ``chip_smoke.py`` phase 7 (cov = a a^T + 0.5 I, the
generic fused kernel B); with ``--target logreg`` or ``--target
eight_schools``, ``run_chees_hmc`` on the model of ``chip_smoke.py`` phase
8a or 8b (102400 walkers, ``max_steps=256``, both phases in kernel B):

1. the run-to-run spread of the sampling phase: ``--repeats`` rounds with
   200 warmup and 256 sampling transitions, once with collect="moments"
   and once with collect="none", one JSON line per run (ms per sampling
   transition from the result's ``sampling_seconds``; for ChEES also the
   warmup's, the adapted step size, tau and the mean leapfrog count);
2. one ``torch.profiler`` trace of 100 warmup + 100 sampling transitions
   (collect="moments"): wall time, device time summed over the kernels
   and copies, the device's busy share, the counts of host launches and
   synchronisations, and the top device and host ops.

With ``--target smc`` (phase 9a: ``run_smc`` on the 32-dim standard
normal from N(0, I / 0.1), kernel A), ``smc_nbody`` (9b: BASELINE config
4 in kernel B's N-body form), ``pt`` (10: ``run_parallel_tempering`` on
the bimodal mixture, 6 replicas of 16384 walkers, 200 + 400 transitions,
kernel B's mixture form) or ``nuts`` (11: ``run_nuts`` on the 16-dim
Gaussian with sd logspace(0, 1, 16), 65536 walkers, 300 + 300): the
spread over ``--repeats`` whole runs (ms per stage or per transition),
then one profiled run.

Prints the card, the JSON lines, then the profiler's two tables.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from physicsbasedbayesianinference_tpu_torch import (  # noqa: E402
    models, run_chees_hmc, run_hmc, run_nuts, run_parallel_tempering,
    run_smc)
from physicsbasedbayesianinference_tpu_torch.ops import _build  # noqa: E402
from physicsbasedbayesianinference_tpu_torch.ops import potentials as pot  # noqa: E402,E501

W, D, STEPS = 102400, 32, 16
HOST_CALLS = ("cudaLaunchKernel", "cudaStreamSynchronize",
              "cudaDeviceSynchronize", "cudaMemcpyAsync")


def tempered_runs(dev):
    """target -> (run(seed) -> (wall seconds, units), unit name, the run
    to profile), for the tempered samplers of ``chip_smoke.py`` phases
    9-11."""
    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    def smc(target, q0, **kw):
        def run(seed):
            seconds, res = timed(lambda: run_smc(seed, target, q0, **kw))
            return seconds, res.num_stages
        return run, "stage", run

    def pt(seed):
        seconds, _ = timed(lambda: run_parallel_tempering(
            seed, bimodal, q_pt, num_replicas=6, beta_min=0.02,
            num_warmup=200, num_samples=400, num_steps=10,
            collect="moments"))
        return seconds, 600

    def nuts(seed, num=300):
        seconds, _ = timed(lambda: run_nuts(
            seed, gauss16, q_nuts, num_warmup=num, num_samples=num,
            collect="none"))
        return seconds, 2 * num

    bimodal = pot.make_gaussian_mixture(torch.tensor([[-6.0, 0.0],
                                                      [6.0, 0.0]]),
                                        device=dev)
    q_pt = torch.tensor([-6.0, 0.0], device=dev) + 0.3 * torch.randn(
        16384, 2, generator=seeded(11), device=dev)
    sd = torch.logspace(0.0, 1.0, 16)
    gauss16 = pot.make_gaussian(torch.zeros(16), cov=torch.diag(sd**2),
                                device=dev)
    q_nuts = torch.randn(65536, 16, generator=seeded(12),
                         device=dev) * sd.to(dev)
    return {
        "smc": smc(pot.make_standard_normal(D),
                   torch.randn(W, D, generator=seeded(9), device=dev)
                   / 0.1**0.5, num_mutation_steps=3, num_leapfrog_steps=10,
                   init_step_size=0.8, beta0=0.1, max_stages=40),
        "smc_nbody": smc(pot.make_nbody_potential(torch.ones(8), 8,
                                                  softening=0.3, device=dev),
                         2.0 * torch.randn(W, 24, generator=seeded(10),
                                           device=dev),
                         num_mutation_steps=3, num_leapfrog_steps=8,
                         init_step_size=0.3, beta0=0.05, max_stages=30),
        "pt": (pt, "transition", pt),
        # profiled: 30 + 30 transitions (a whole run's trace outgrows the
        # profiler)
        "nuts": (nuts, "transition", lambda seed: nuts(seed, 30)),
    }


TEMPERED = ("smc", "smc_nbody", "pt", "nuts")


def measure_tempered(args, dev) -> None:
    run, unit, profiled = tempered_runs(dev)[args.target]
    print(json.dumps({"target": args.target}))
    run(0)
    for rep in range(args.repeats):
        seconds, units = run(1 + rep)
        print(json.dumps({"rep": rep, f"{unit}s": units,
                          f"ms_per_{unit}": 1e3 * seconds / units}))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_s, units = profiled(1)
    report(prof, 1e3 * wall_s, units)


def report(prof, wall_ms, units) -> None:
    table = prof.key_averages()
    # device-side rows only: an op's row repeats its kernels' device time
    device_ms = sum(e.self_device_time_total for e in table
                    if e.device_type == DeviceType.CUDA) / 1e3
    calls = {e.key: e.count for e in table if e.key in HOST_CALLS}
    print(json.dumps({
        "profiled_units": units, "profiled_wall_ms": wall_ms,
        "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
        "host_calls": calls}))
    print(table.table(sort_by="self_device_time_total", row_limit=12))
    print(table.table(sort_by="self_cpu_time_total", row_limit=12))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=4)
    parser.add_argument("--target", default="std_normal",
                        choices=("std_normal", "correlated", "logreg",
                                 "eight_schools") + tuple(TEMPERED))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tools/measure_main_path.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    _build.load_library()
    dev = torch.device("cuda", 0)
    if args.target in TEMPERED:
        return measure_tempered(args, dev)
    init_step = None  # a model: run_chees_hmc from this step size
    if args.target == "correlated":
        gen = torch.Generator().manual_seed(7)
        a = torch.randn(D, D, generator=gen) / D**0.5
        target = pot.make_gaussian(torch.randn(D, generator=gen),
                                   cov=a @ a.T + 0.5 * torch.eye(D))
    elif args.target == "logreg":
        target = models.make_model_potential(
            models.logistic_regression,
            models.logistic_regression_data(256, 31), {}).potential
        init_step = 0.05
    elif args.target == "eight_schools":
        target = models.make_model_potential(
            models.eight_schools_noncentered, (),
            models.EIGHT_SCHOOLS_DATA).potential
        init_step = 0.22
    else:
        target = pot.make_standard_normal(D)
    print(json.dumps({"target": args.target}))
    d = 10 if args.target == "eight_schools" else D
    q0 = torch.randn(W, d, generator=torch.Generator(device=dev).manual_seed(0),
                     device=dev)

    def run(seed, num_warmup, num_samples, collect="moments"):
        if init_step is None:
            return run_hmc(seed, target, q0, num_warmup=num_warmup,
                           num_samples=num_samples, num_steps=STEPS,
                           collect=collect)
        return run_chees_hmc(seed, target, 0.3 * q0, num_warmup=num_warmup,
                             num_samples=num_samples, max_steps=256,
                             init_step_size=init_step, collect=collect)

    run(0, 20, 20)
    for rep in range(args.repeats):
        for collect in ("moments", "none"):
            res = run(1 + rep, 200, 256, collect)
            line = {
                "rep": rep, "collect": collect,
                "ms_per_transition": 1e3 * res.sampling_seconds / 256,
                "walker_transitions_per_s": W * 256 / res.sampling_seconds}
            if init_step is not None:
                line.update(
                    warmup_ms_per_transition=1e3 * res.warmup_seconds / 200,
                    step_size=res.step_size.item(),
                    trajectory_time=res.trajectory_time.item(),
                    mean_num_steps=res.mean_num_steps.item(),
                    engines=[res.warmup_kernel_used, res.kernel_used])
            print(json.dumps(line))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(1, 100, 100)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    report(prof, wall_ms, 200)


if __name__ == "__main__":
    main()
