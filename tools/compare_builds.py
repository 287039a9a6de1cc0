#!/usr/bin/env python3
"""Kernels A, B and D of this checkout against those of another checkout of the
repository (the parent commit, say), on one card and in one process.

    python3 tools/compare_builds.py PATH_TO_OTHER_CHECKOUT

from the repository root, on a GPU. Loads the other checkout's package
under another name, builds both kernel libraries, and at each row of the
kernel table (``PERF.md`` section 6) runs both on the same inputs and the
same Philox draws:

* says whether the outputs are the same bits and the largest absolute
  difference otherwise (every row runs the fixed leapfrog count without
  the proposal outputs, which both checkouts have);
* times both in the order other, this, this, other (CUDA-graph replays
  timed with CUDA events, ``chip_smoke.median_ms``), since two cards or
  two calls differ by more than most changes.

Prints the card, then one JSON line per row.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import median_ms  # noqa: E402
from physicsbasedbayesianinference_tpu_torch.ops import kernels as this  # noqa: E402,E501
from physicsbasedbayesianinference_tpu_torch.ops import potentials as pot  # noqa: E402,E501

PACKAGE = "physicsbasedbayesianinference_tpu_torch"
SEED = 20261016


def load_other(root: Path):
    """The package of the checkout at ``root`` as module ``other_pbbi``."""
    init = root / PACKAGE / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "other_pbbi", init, submodule_search_locations=[str(init.parent)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["other_pbbi"] = module
    spec.loader.exec_module(module)
    return module


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("tools/compare_builds.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    load_other(Path(sys.argv[1]).resolve())
    import other_pbbi.ops.kernels as other
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def gaussian(d):
        a = torch.randn(d, d, generator=gen) / d**0.5
        return pot.make_gaussian(torch.randn(d, generator=gen),
                                 cov=a @ a.T + 0.5 * torch.eye(d),
                                 device=dev).device_form

    def report(row, run_this, run_other):
        outs = run_this(), run_other()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*outs))
        diff = max((a.float() - b.float()).abs().nan_to_num(0.0).max().item()
                   for a, b in zip(*outs))
        times = [median_ms(f) for f in (run_other, run_this, run_this,
                                        run_other)]
        print(json.dumps({"row": row, "same_bits": same, "max_abs_diff": diff,
                          "other_ms": [times[0], times[3]],
                          "this_ms": [times[1], times[2]]}))

    def row_b(row, form, q, step):
        d = q.shape[1]
        u, g = this.device_value_and_grad(form)(q)
        im = (0.5 + 1.5 * torch.rand(d, generator=gen)).to(dev)
        kw = dict(scalars=torch.tensor([step, 1.0, 1.0], device=dev),
                  p_std=torch.sqrt(1.0 / im), inv_mass=im, num_steps=16)
        report(row,
               lambda: this.fused_hmc_transition(form, SEED, 11, q, u, g,
                                                 **kw),
               lambda: other.fused_hmc_transition(form, SEED, 11, q, u, g,
                                                  **kw))

    def row_d(row, form, w, d, step):
        q, p = randn(w, d), randn(w, d)
        kw = dict(step_size=torch.tensor([step], device=dev), num_steps=16,
                  inv_mass=(0.5 + 1.5 * torch.rand(d, generator=gen)).to(dev))
        report(row,
               lambda: this.leapfrog_trajectory(form, q, p, **kw),
               lambda: other.leapfrog_trajectory(form, q, p, **kw))

    def row_a(row, w, d):
        q = randn(w, d)
        im = (0.5 + 1.5 * torch.rand(d, generator=gen)).to(dev)
        kw = dict(scalars=torch.tensor([0.2, 1.0, 1.0], device=dev),
                  p_std=torch.sqrt(1.0 / im), inv_mass=im,
                  k_diag=(0.5 + 1.5 * torch.rand(d, generator=gen)).to(dev),
                  mean=randn(d), num_steps=16)
        report(row,
               lambda: this.fused_hmc_diag_quadratic(SEED, 7, q, **kw),
               lambda: other.fused_hmc_diag_quadratic(SEED, 7, q, **kw))

    w = 8192
    row_a("A random metric W=102400 D=32 L=16", 102400, 32)
    row_a("A random metric W=1000 D=33 L=16 (scalar accesses)", 1000, 33)
    row_a("A random metric W=1000 D=200 L=16 (loop over groups)", 1000, 200)
    row_b("B funnel W=8192 D=10 L=16",
          pot.make_funnel(10, device=dev).device_form, 0.5 * randn(w, 10), 0.1)
    row_b("B nbody W=8192 N=8 D=24 L=16", pot.make_nbody_potential(
        (0.5 + torch.rand(8, generator=gen)), 8, softening=0.5,
        device=dev).device_form, 2.0 * randn(w, 24), 0.05)
    row_b("B banana W=8192 D=2 L=16", pot.make_banana(device=dev).device_form,
          torch.stack([1.0 + 0.3 * randn(w), 1.0 + 0.5 * randn(w)], 1), 0.005)
    row_b("B mixture W=8192 D=2 K=2 L=16", pot.make_gaussian_mixture(
        torch.tensor([[-3.0, 0.0], [3.0, 0.0]]), device=dev).device_form,
        3.0 * randn(w, 2), 0.3)
    row_b("B funnel W=1000 D=33 L=16 (scalar accesses)",
          pot.make_funnel(33, device=dev).device_form, 0.5 * randn(1000, 33),
          0.05)
    row_b("B gaussian W=8192 D=2 L=16", gaussian(2), randn(w, 2), 0.3)
    row_b("B gaussian W=8192 D=32 L=16", gaussian(32), randn(w, 32), 0.1)
    corr = gaussian(32)
    row_b("B correlated gaussian W=102400 D=32 L=16", corr,
          randn(102400, 32), 0.1)
    row_d("D correlated gaussian W=102400 D=32 L=16", corr, 102400, 32, 0.1)
    one = torch.ones(32, device=dev)
    row_d("D std_normal (diag form) W=102400 D=32 L=16",
          ("diag", (one, 0.0 * one)), 102400, 32, 0.3)
    row_d("D funnel W=8192 D=10 L=16",
          pot.make_funnel(10, device=dev).device_form, w, 10, 0.05)


if __name__ == "__main__":
    main()
