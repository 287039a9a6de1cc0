#!/usr/bin/env python3
"""The readings a cell's limits are set from, at the cell's own size, one
job a seed and side:

- ``program``: a job of the program, through the cell's check;
- ``control``: the plain reference in the program's place, in the next
  precision below the configuration's (its ``control``: TF32 data
  products for float32 products with TF32 off, a bfloat16 trajectory for
  other float32). It replays each kept sampling transition of that job
  from the draw before it, at the job's adapted settings, and hands its
  draw to the check in place of the program's;
- each of ``--faults``: the program with that fault planted in its warmup
  adaptation (``FAULTS``), through the same check.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 \\
        [--faults step_size_frozen mass_ones] [--fault-seeds 3]

on a machine with a card (one process). Prints one JSON line a seed and
side.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

FAULTS = {
    "step_size_frozen": "dual averaging never moves: the step size stays "
                        "at init_step_size",
    "mass_ones": "the metric left at ones",
    "partial_sum": "the variance's sums take three quarters of the "
                   "walkers' terms and the whole count, as an all-reduce "
                   "that drops one rank's share",
    "tau_frozen": "Adam on log tau never moves: tau stays at init_tau",
}


@contextlib.contextmanager
def planted(fault: str):
    """The program's samplers with ``fault`` planted in the adaptation
    functions they call, restored on leaving."""
    import torch
    from physicsbasedbayesianinference_tpu_torch import adaptation, chees, hmc

    def partial(q, **kw):
        k = 3 * q.shape[0] // 4
        w, mean, m2 = adaptation.batch_terms(q[:k], **kw)
        return w * (q.shape[0] / k), mean, m2
    new = {"step_size_frozen": {"da_update": lambda st, *a, **kw: st},
           "mass_ones": {"regularized_mass":
                         lambda st, **kw: torch.ones_like(st.m2)},
           "partial_sum": {"batch_terms": partial},
           "tau_frozen": {"chees_update": lambda st, *a, **kw: st}}[fault]
    saved = [(m, n, getattr(m, n)) for m in (hmc, chees) for n in new
             if hasattr(m, n)]
    for m, n, _ in saved:
        setattr(m, n, new[n])
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def control_job(run, job):
    """``job`` with each kept draw replaced by the control's: the
    reference's transition, in the configuration's control precision, from
    the draw before it at the job's step size, metric and count."""
    from portbench.reference import hmc as ref
    torch = run.torch
    prec = ref.PRECISIONS[run.cfg["control"]]
    dt = prec.dtype
    vg = run.model.value_and_grad(run.data, prec)
    out = copy.copy(job)
    out.draws = []
    eps = torch.tensor(job.step_size, dtype=dt, device=run.device)
    inv_mass = 1.0 / job.mass.to(run.device, dt)
    for t, w, before, after in job.draws:
        q = before.to(dt)
        u, g = vg(q)
        step = ref.transition(vg, job.seed, run.traffic["warmup"] + t,
                              w + run.offset, q, u, g, eps, inv_mass,
                              job.counts[t][0], prec)
        out.draws.append((t, w, before, step["q"].to(before.dtype)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[], choices=list(FAULTS))
    ap.add_argument("--fault-seeds", type=int, default=3,
                    help="the first this many seeds also run each fault")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for i, seed in enumerate(args.seeds):
        ns = argparse.Namespace(seed=seed, seconds=0.0, trace=0)
        run = harness.Run(cell, ns, 0, 1)
        run.setup(warm=i == 0)
        job_seed = harness.derive(seed, 100, 0)
        sides = ["program", "control"]
        if i < args.fault_seeds:
            sides += args.faults
        job = None
        for side in sides:
            t0 = time.perf_counter()
            if side == "program":
                job = run.run_job(0, job_seed, run.traffic)
                got = job
            elif side == "control":
                got = control_job(run, job)
            else:
                with planted(side):
                    got = run.run_job(0, job_seed, run.traffic)
            checks = run.check([got])
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "failed": got.failed,
                              "s": time.perf_counter() - t0,
                              "step_size": got.step_size, "tau": got.tau,
                              "checks": checks}), flush=True)
        del run, job, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
