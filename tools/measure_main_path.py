#!/usr/bin/env python3
"""Where a transition of ``run_hmc``'s main path spends its time, on the card.

    python3 tools/measure_main_path.py [--repeats 4] [--target correlated]

from the repository root, on a GPU. At the bench configuration (32-dim
standard normal, 102400 walkers, 16 leapfrog steps, fused kernel A) or,
with ``--target correlated``, at the same shape on the correlated 32-dim
Gaussian of ``chip_smoke.py`` phase 7 (cov = a a^T + 0.5 I, the generic
fused kernel B):

1. the run-to-run spread of the sampling phase: ``--repeats`` rounds of
   ``run_hmc`` with 200 warmup and 256 sampling transitions, once with
   collect="moments" and once with collect="none", one JSON line per run
   (ms per sampling transition from ``HMCRunResult.sampling_seconds``);
2. one ``torch.profiler`` trace of 100 warmup + 100 sampling transitions
   (collect="moments"): wall time, device time summed over the kernels
   and copies, the device's busy share, the counts of host launches and
   synchronisations, and the top device and host ops.

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

from physicsbasedbayesianinference_tpu_torch import run_hmc  # noqa: E402
from physicsbasedbayesianinference_tpu_torch.ops import _build  # noqa: E402
from physicsbasedbayesianinference_tpu_torch.ops import potentials as pot  # noqa: E402,E501

W, D, STEPS = 102400, 32, 16
HOST_CALLS = ("cudaLaunchKernel", "cudaStreamSynchronize",
              "cudaDeviceSynchronize", "cudaMemcpyAsync")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=4)
    parser.add_argument("--target", choices=("std_normal", "correlated"),
                        default="std_normal")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tools/measure_main_path.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    _build.load_library()
    dev = torch.device("cuda", 0)
    if args.target == "correlated":
        gen = torch.Generator().manual_seed(7)
        a = torch.randn(D, D, generator=gen) / D**0.5
        target = pot.make_gaussian(torch.randn(D, generator=gen),
                                   cov=a @ a.T + 0.5 * torch.eye(D))
    else:
        target = pot.make_standard_normal(D)
    print(json.dumps({"target": args.target}))
    q0 = torch.randn(W, D, generator=torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    run_hmc(0, target, q0, num_warmup=20, num_samples=20, num_steps=STEPS)

    for rep in range(args.repeats):
        for collect in ("moments", "none"):
            res = run_hmc(1 + rep, target, q0, num_warmup=200,
                          num_samples=256, num_steps=STEPS, collect=collect)
            print(json.dumps({
                "rep": rep, "collect": collect,
                "ms_per_transition": 1e3 * res.sampling_seconds / 256,
                "walker_transitions_per_s": W * 256 / res.sampling_seconds}))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_hmc(1, target, q0, num_warmup=100, num_samples=100,
                num_steps=STEPS, collect="moments")
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    table = prof.key_averages()
    # device-side rows only: an op's row repeats its kernels' device time
    device_ms = sum(e.self_device_time_total for e in table
                    if e.device_type == DeviceType.CUDA) / 1e3
    calls = {e.key: e.count for e in table if e.key in HOST_CALLS}
    print(json.dumps({
        "profiled_transitions": 200, "profiled_wall_ms": wall_ms,
        "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
        "host_calls": calls}))
    print(table.table(sort_by="self_device_time_total", row_limit=12))
    print(table.table(sort_by="self_cpu_time_total", row_limit=12))


if __name__ == "__main__":
    main()
