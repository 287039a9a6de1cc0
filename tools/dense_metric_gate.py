#!/usr/bin/env python3
"""The gate of ``chip_smoke.py`` phase 12g on the dense metric's adapted
covariance, from CPU runs.

    python3 tools/dense_metric_gate.py [--walkers 8192] [--seeds 4]

Runs the warmup of ``run_hmc(metric="dense")`` (200 transitions, L = 16,
the phase's schedule) on phase 7's correlated 32-dim Gaussian (cov = a a^T
+ 0.5 I, a = randn(32, 32) / sqrt(32) from the phase's generator) on the
CPU at ``--walkers`` walkers for each of ``--seeds`` seeds, and prints the
relative Frobenius error ||Sigma - cov|| / ||cov|| of each adapted Sigma.
Their root mean square is one standard error at this width; the error of
an estimate from W walkers falls as 1 / sqrt(W), so the gate at 102400
walkers is four of them, scaled by sqrt(walkers / 102400). The script
prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import torch

from physicsbasedbayesianinference_tpu_torch import run_hmc
from physicsbasedbayesianinference_tpu_torch.ops import potentials as pot

SEED = 20261016  # chip_smoke.py's
CHIP_WALKERS = 102400


def phase7_target(d: int = 32):
    gen = torch.Generator(device="cpu").manual_seed(SEED + 7)
    a = torch.randn(d, d, generator=gen) / d**0.5
    mean = torch.randn(d, generator=gen)
    return mean, a @ a.T + 0.5 * torch.eye(d)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--walkers", type=int, default=8192)
    p.add_argument("--seeds", type=int, default=4)
    args = p.parse_args()
    mean, cov = phase7_target()
    target = pot.make_gaussian(mean, cov=cov, device="cpu")
    errors = []
    t0 = time.perf_counter()
    for seed in range(args.seeds):
        q0 = torch.randn(args.walkers, 32,
                         generator=torch.Generator().manual_seed(seed))
        res = run_hmc(SEED + seed, target, q0, num_warmup=200,
                      num_samples=0, num_steps=16, collect="none",
                      metric="dense")
        errors.append(float(torch.linalg.norm(res.metric_cov - cov)
                            / torch.linalg.norm(cov)))
    rms = math.sqrt(sum(e * e for e in errors) / len(errors))
    print(json.dumps({
        "device": "cpu", "walkers": args.walkers,
        "rel_frobenius_errors": errors, "rms": rms,
        "gate_at_102400": 4.0 * rms * math.sqrt(args.walkers / CHIP_WALKERS),
        "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
