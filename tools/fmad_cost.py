#!/usr/bin/env python3
"""What building the fused kernels with ``--fmad=false`` costs, on the card.

    python3 tools/fmad_cost.py       # from the repository root, on a GPU

``ops/_build.py`` compiles without multiply-add contraction, so that the
kernels round op by op as their plain torch versions do. This builds the
library with and without contraction and, for kernel A and kernel B at the
shapes ``chip_smoke.py`` checks:

* times both builds, alternating (off, on, on, off), each time the median
  over CUDA-graph replays timed with CUDA events (``chip_smoke.median_ms``);
* holds each build against the plain version as ``chip_smoke.py`` does
  (q', u', g' to rtol = atol = 1e-5 where the decisions agree) and counts
  the walkers outside that bound.

Prints the card, then one JSON line per case.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import median_ms  # noqa: E402
from physicsbasedbayesianinference_tpu_torch.ops import _build  # noqa: E402
from physicsbasedbayesianinference_tpu_torch.ops import kernels  # noqa: E402
from physicsbasedbayesianinference_tpu_torch.ops import potentials as pot  # noqa: E402,E501

SEED = 20261016


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tools/fmad_cost.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    contracted = tuple(f for f in _build.NVCC_FLAGS if f != "--fmad=false")
    libs = {"fmad_on": _build.bind(_build.build(contracted)),
            "fmad_off": _build.bind(_build.build(
                (*contracted, "--fmad=false")))}
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def metric(d):
        im = (0.5 + 1.5 * torch.rand(d, generator=gen)).to(dev)
        return dict(p_std=torch.sqrt(1.0 / im), inv_mass=im, num_steps=16)

    def scalars(step):
        return torch.tensor([step, 1.0, 1.0], device=dev)

    cases = []
    q = randn(102400, 32)
    kw = dict(scalars=scalars(0.3), k_diag=torch.ones(32, device=dev),
              mean=torch.zeros(32, device=dev), **metric(32))
    cases.append((
        "A std_normal W=102400 D=32 L=16",
        lambda: kernels.fused_hmc_diag_quadratic(SEED, 7, q, **kw),
        lambda: kernels.fused_hmc_diag_quadratic_plain(SEED, 7, q, **kw)))

    def generic_case(name, form, qb, step):
        u, g = kernels.device_value_and_grad(form)(qb)
        kwb = dict(scalars=scalars(step), **metric(qb.shape[1]))
        cases.append((
            name,
            lambda: kernels.fused_hmc_transition(form, SEED, 11, qb, u, g,
                                                 **kwb),
            lambda: kernels.fused_hmc_transition_plain(form, SEED, 11, qb,
                                                       u, g, **kwb)))

    a = torch.randn(32, 32, generator=gen) / 32**0.5
    generic_case("B gaussian W=8192 D=32 L=16", pot.make_gaussian(
        torch.randn(32, generator=gen), cov=a @ a.T + 0.5 * torch.eye(32),
        device=dev).device_form, randn(8192, 32), 0.1)
    generic_case("B gaussian W=8192 D=2 L=16", pot.make_gaussian(
        torch.tensor([2.0, -1.0]), cov=torch.tensor([[1.0, 0.8], [0.8, 2.0]]),
        device=dev).device_form, randn(8192, 2), 0.3)
    generic_case("B funnel W=8192 D=10 L=16",
                 pot.make_funnel(10, device=dev).device_form,
                 0.5 * randn(8192, 10), 0.1)
    generic_case("B nbody W=8192 N=8 D=24 L=16", pot.make_nbody_potential(
        0.5 + torch.rand(8, generator=gen), 8, softening=0.5,
        device=dev).device_form, 2.0 * randn(8192, 24), 0.05)

    for name, run, plain in cases:
        line = {"case": name}
        times = {k: [] for k in libs}
        for which in ("fmad_off", "fmad_on", "fmad_on", "fmad_off"):
            kernels.load_library = lambda lib=libs[which]: lib
            times[which].append(median_ms(run))
        for which, lib in libs.items():
            kernels.load_library = lambda lib=lib: lib
            line[f"{which}_ms"] = statistics.mean(times[which])
            line.update(agreement(which, run(), plain()))
        kernels.load_library = _build.load_library
        line["runs_ms"] = times
        print(json.dumps(line))


def agreement(which: str, out_k, out_p) -> dict:
    """Kernel vs plain: decisions that differ; walkers whose q', u' or g'
    leave rtol = atol = 1e-5 where the decisions agree; the largest
    absolute difference there."""
    agree = out_k[4] == out_p[4]
    outside, worst = 0, 0.0
    for i in range(3):
        k, p = out_k[i][agree], out_p[i][agree]
        err = (k - p).abs()
        bad = err > 1e-5 + 1e-5 * p.abs()
        if bad.ndim > 1:
            bad = bad.any(dim=1)
        outside = max(outside, int(bad.sum()))
        worst = max(worst, err.max().item())
    return {f"{which}_decisions_differing": int((~agree).sum()),
            f"{which}_walkers_outside_1e-5": outside,
            f"{which}_max_abs_err": worst}


if __name__ == "__main__":
    main()
