#!/usr/bin/env python3
"""Kernels A, B and D of this checkout against those of another checkout of the
repository (the parent commit, say), on one card and in one process.

    python3 tools/compare_builds.py PATH_TO_OTHER_CHECKOUT

from the repository root, on a GPU. Loads the other checkout's package
under another name, builds both kernel libraries, and at each row of the
kernel table (``PERF.md`` section 6) runs both on the same inputs and the
same Philox draws:

* says whether the outputs are the same bits (NaNs compared by their
  bits) and the largest absolute difference otherwise (every row runs the fixed leapfrog count without
  the proposal outputs, which both checkouts have); the logistic rows
  (``models.logistic_regression_data(256, 31)``, the data of phase 8a,
  kernel B at W = 102400, 101376 and 8192: at 101376 the lane groups'
  blocks make whole waves of the card) and the linear-regression rows
  (``models.linear_regression_data(256, 30)``, the data of phase 14c)
  differ wherever the two checkouts' data forms round differently, and
  the eight-schools rows (both forms on ``models.EIGHT_SCHOOLS_DATA`` at
  W = 102400, D = 10, about the posterior) wherever their eight-schools
  forms do; the funnel-model rows (``models.funnel``, D = 16, W = 102400)
  and the N-body rows (8 bodies in 3-D, D = 24: phase 9b's kernel B at
  W = 102400, L = 8 and potential scale 0.37, kernel D at L = 16, and
  kernel B at W = 8192) wherever those forms round otherwise (the thread
  layout keeps the lane groups' bits); the mixture rows (kernel B at W =
  8192, K = 2, D = 2 and at K = 3, D = 10, kernel D at W = 8192, and
  parallel tempering's launch of phase 10's six rungs of 16384 walkers at
  their betas) wherever the mixture forms do, and the coin rows (kernels
  B and D at W = 102400, D = 2, on ``examples/coin_toss.data.json``'s
  counts) wherever the coin forms do;
* times both in the order other, this, this, other (CUDA-graph replays
  timed with CUDA events, ``chip_smoke.median_ms``), since two cards or
  two calls differ by more than most changes.

Prints the card, then one JSON line per row.

    python3 tools/compare_builds.py PATH_TO_OTHER_CHECKOUT --samplers

times the samplers' unsharded warmup instead, end to end, in the same
order: ``run_chees_hmc`` on phase 8a's logistic regression and 8b's
non-centred eight schools (W = 102400, 200 warmup transitions,
``kernel="auto"``), ``run_hmc`` at the bench configuration (the standard
normal, W = 102400, D = 32, L = 16, 200 warmup transitions) and
``run_parallel_tempering`` at phase 10's (the mixture at (+-6, 0), R = 6,
W = 16384, 200 warmup transitions), each with no sampling transition, in
three rounds of other, this, this, other. Prints one JSON line per
sampler: each run's host-clock ms a warmup transition (the whole call over
its transitions, set-up included; ChEES also its own ``warmup_seconds``),
their medians, whether both checkouts adapt the same bits, and the
kernel launches a warmup transition makes in each (``cudaLaunchKernel``
under ``torch.profiler``: a run less a run of no transitions).
"""

from __future__ import annotations

import importlib.util
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import median_ms  # noqa: E402
from physicsbasedbayesianinference_tpu_torch.ops import kernels as this  # noqa: E402,E501
from physicsbasedbayesianinference_tpu_torch.ops import potentials as pot  # noqa: E402,E501
from physicsbasedbayesianinference_tpu_torch import models  # noqa: E402

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


def compare_samplers(other_pkg, dev) -> None:
    """The unsharded warmup of ChEES (8a, 8b), HMC (bench configuration)
    and PT (phase 10) in both checkouts (module docstring)."""
    import time

    import physicsbasedbayesianinference_tpu_torch as this_pkg

    n_warm, rounds = 200, 3

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(SEED + seed)

    def cases(pkg):
        lr = pkg.models.make_model_potential(
            pkg.models.logistic_regression,
            pkg.models.logistic_regression_data(256, 31), {})
        es = pkg.models.make_model_potential(
            pkg.models.eight_schools_noncentered, (),
            pkg.models.EIGHT_SCHOOLS_DATA)
        mix = pkg.ops.potentials.make_gaussian_mixture(
            torch.tensor([[-6.0, 0.0], [6.0, 0.0]]), device=dev)

        def chees(mp, init_step):
            def run(num_warmup):
                q0 = 0.3 * torch.randn(102400, mp.num_dims, generator=gen(0),
                                       device=dev)
                res = pkg.run_chees_hmc(
                    SEED + 8, mp.potential, q0, num_warmup=num_warmup,
                    num_samples=0, max_steps=256, init_step_size=init_step,
                    collect="moments", kernel="auto")
                return (res.step_size, res.trajectory_time,
                        res.state.ensemble.mass), res.warmup_seconds
            return run

        def hmc(num_warmup):
            q0 = torch.randn(102400, 32, generator=gen(0), device=dev)
            res = pkg.run_hmc(SEED, pkg.ops.potentials.make_standard_normal(
                32), q0, num_warmup=num_warmup, num_samples=0, num_steps=16,
                collect="moments", kernel="auto")
            return (res.step_size, res.state.ensemble.mass), None

        def pt(num_warmup):
            q0 = torch.tensor([-6.0, 0.0], device=dev) + 0.3 * torch.randn(
                16384, 2, generator=gen(11), device=dev)
            res = pkg.run_parallel_tempering(
                SEED + 14, mix, q0, num_replicas=6, beta_min=0.02,
                num_warmup=num_warmup, num_samples=0, num_steps=10,
                collect="none")
            return (res.step_sizes, res.q), None

        return {"8a run_chees_hmc logistic regression W=102400": chees(lr,
                                                                        0.05),
                "8b run_chees_hmc eight schools nc W=102400": chees(es, 0.22),
                "run_hmc standard normal W=102400 D=32 L=16": hmc,
                "run_parallel_tempering mixture R=6 W=16384": pt}

    def launches(run):
        """``cudaLaunchKernel`` calls a warmup transition: a run of
        ``n_warm`` transitions less one of none, under the profiler."""
        from torch.profiler import ProfilerActivity, profile
        counts = []
        for num_warmup in (n_warm, 0):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                run(num_warmup)
            counts.append(sum(e.count for e in prof.key_averages()
                              if e.key == "cudaLaunchKernel"))
        return (counts[0] - counts[1]) / n_warm

    mine, theirs = cases(this_pkg), cases(other_pkg)
    for name in mine:
        for run in (mine[name], theirs[name]):  # builds, first calls
            run(4)

        def timed(run):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, warm_s = run(n_warm)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / n_warm
            return out, ms, None if warm_s is None else 1e3 * warm_s / n_warm

        runs = {"other": [], "this": []}
        for _ in range(rounds):
            for who, run in (("other", theirs[name]), ("this", mine[name]),
                             ("this", mine[name]), ("other", theirs[name])):
                runs[who].append(timed(run))
        same = all(torch.equal(a, b) for a, b in zip(runs["this"][0][0],
                                                    runs["other"][0][0]))
        line = {"sampler": name, "warmup_transitions": n_warm,
                "same_bits": same,
                "launches_per_warmup_transition": {
                    "other": launches(theirs[name]),
                    "this": launches(mine[name])}}
        for who, got in runs.items():
            ms = [r[1] for r in got]
            line[f"{who}_ms_per_warmup_transition"] = ms
            line[f"{who}_median_ms"] = statistics.median(ms)
            if got[0][2] is not None:
                line[f"{who}_warmup_loop_ms"] = [r[2] for r in got]
        print(json.dumps(line))


def _coin_data() -> dict:
    """``examples/coin_toss.data.json``'s two coins (float32 numpy)."""
    raw = json.loads((ROOT / "examples" / "coin_toss.data.json").read_text())
    return {k: np.asarray(raw[k], np.float32) for k in ("c1", "c2")}


def main() -> None:
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([],
                                                           ["--samplers"]):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("tools/compare_builds.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    other_pkg = load_other(Path(sys.argv[1]).resolve())
    dev = torch.device("cuda", 0)
    if sys.argv[2:] == ["--samplers"]:
        compare_samplers(other_pkg, dev)
        return
    import other_pbbi.ops.kernels as other
    gen = torch.Generator().manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def gaussian(d):
        a = torch.randn(d, d, generator=gen) / d**0.5
        return pot.make_gaussian(torch.randn(d, generator=gen),
                                 cov=a @ a.T + 0.5 * torch.eye(d),
                                 device=dev).device_form

    def bits(x):
        """x as integers of its width: NaNs compare by their bits."""
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    def report(row, run_this, run_other):
        outs = run_this(), run_other()
        torch.cuda.synchronize()
        same = all(torch.equal(bits(a), bits(b)) for a, b in zip(*outs))
        diff = max((a.float() - b.float()).abs().nan_to_num(0.0).max().item()
                   for a, b in zip(*outs))
        times = [median_ms(f) for f in (run_other, run_this, run_this,
                                        run_other)]
        print(json.dumps({"row": row, "same_bits": same, "max_abs_diff": diff,
                          "other_ms": [times[0], times[3]],
                          "this_ms": [times[1], times[2]]}))

    def row_b(row, form, q, step, steps=16, scale=1.0):
        d = q.shape[1]
        u, g = this.device_value_and_grad(form)(q)
        im = (0.5 + 1.5 * torch.rand(d, generator=gen)).to(dev)
        kw = dict(scalars=torch.tensor([step, 1.0, scale], device=dev),
                  p_std=torch.sqrt(1.0 / im), inv_mass=im, num_steps=steps)
        report(row,
               lambda: this.fused_hmc_transition(form, SEED, 11, q, u, g,
                                                 **kw),
               lambda: other.fused_hmc_transition(form, SEED, 11, q, u, g,
                                                  **kw))

    def row_rungs(row, form, q, betas, steps):
        """Kernel B on the rungs of q [R, W, D] in one launch, each at its
        beta (mass 1, momenta thermal at it, step 0.5 / sqrt(beta))."""
        r, _, d = q.shape
        vg = this.device_value_and_grad(form)
        u, g = (torch.stack(x) for x in zip(*(vg(x) for x in q)))
        kw = dict(scalars=torch.stack((0.5 / betas.sqrt(), betas,
                                       torch.ones_like(betas)), 1),
                  p_std=torch.sqrt(1.0 / betas)[:, None].expand(
                      r, d).contiguous(),
                  inv_mass=torch.ones(d, device=dev), num_steps=steps)
        seeds = [SEED + i for i in range(r)]
        report(row,
               lambda: this.fused_hmc_transition(form, seeds, 11, q, u, g,
                                                 **kw),
               lambda: other.fused_hmc_transition(form, seeds, 11, q, u, g,
                                                  **kw))

    def row_d(row, form, w, d, step, q=None):
        q = randn(w, d) if q is None else q
        p = randn(w, d)
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
    mixture = pot.make_gaussian_mixture(
        torch.tensor([[-3.0, 0.0], [3.0, 0.0]]), device=dev).device_form
    row_b("B mixture W=8192 D=2 K=2 L=16", mixture, 3.0 * randn(w, 2), 0.3)
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
    x, y = models.logistic_regression_data(256, 31)
    logistic = ("logistic", (torch.as_tensor(x).to(dev),
                             torch.as_tensor(y).to(dev)))
    for w_ in (102400, 101376, 8192):
        row_b(f"B logistic W={w_} D=32 N=256 L=16", logistic,
              0.3 * randn(w_, 32), 0.05)
    row_d("D logistic W=102400 D=32 N=256 L=16", logistic, 102400, 32, 0.05)
    linear = models.make_model_potential(
        models.linear_regression, models.linear_regression_data(256, 30), {},
        device=dev).potential.device_form
    q = 0.3 * randn(102400, 32)
    row_b("B linear W=102400 D=32 N=256 L=16", linear, q, 0.02)
    row_d("D linear W=102400 D=32 N=256 L=16", linear, 102400, 32, 0.02, q=q)
    for model in (models.eight_schools_noncentered, models.eight_schools):
        form = models.make_model_potential(
            model, (), models.EIGHT_SCHOOLS_DATA,
            device=dev).potential.device_form
        # mu, log tau and theta about the posterior
        z = randn(102400, 10)
        theta = z[:, 2:] if form[0] == "eight_schools_nc" else 4.0 + 3.0 * z[
            :, 2:]
        q = torch.cat([4.0 + 3.0 * z[:, :1], 1.0 + 0.5 * z[:, 1:2], theta], 1)
        row_b(f"B {form[0]} W=102400 D=10 L=16", form, q, 0.05)
        row_d(f"D {form[0]} W=102400 D=10 L=16", form, 102400, 10, 0.05, q=q)
    funnel = models.make_model_potential(models.funnel, (), {},
                                         device=dev).potential.device_form
    z = randn(102400, 16)
    q = torch.cat([1.5 * z[:, :1], torch.exp(0.75 * z[:, :1]) * z[:, 1:]], 1)
    row_b("B funnel_model W=102400 D=16 L=16", funnel, q, 0.1)
    row_d("D funnel_model W=102400 D=16 L=16", funnel, 102400, 16, 0.1, q=q)
    nbody8 = pot.make_nbody_potential(torch.ones(8), 8, softening=0.3,
                                      device=dev).device_form
    q = 2.0 * randn(102400, 24)
    row_b("B nbody N=8 eps=0.3 W=102400 D=24 L=8 scale=0.37", nbody8, q,
          0.3, steps=8, scale=0.37)
    row_d("D nbody N=8 eps=0.3 W=102400 D=24 L=16", nbody8, 102400, 24,
          0.05, q=q)
    # the mixture and the coin forms (drawn after every earlier row, so
    # that those rows keep their inputs)
    row_b("B mixture W=8192 D=10 K=3 L=16", pot.make_gaussian_mixture(
        2.0 * randn(3, 10), device=dev).device_form, 2.0 * randn(w, 10),
        0.2)
    row_d("D mixture W=8192 D=2 K=2 L=16", mixture, w, 2, 0.3,
          q=3.0 * randn(w, 2))
    row_rungs("B mixture K=2 R=6 W=16384 D=2 L=10 (phase 10's rung launch)",
              pot.make_gaussian_mixture(
                  torch.tensor([[-6.0, 0.0], [6.0, 0.0]]),
                  device=dev).device_form, 6.0 * randn(6, 16384, 2),
              torch.logspace(0.0, math.log10(0.02), 6).to(dev), 10)
    coin = models.make_model_potential(
        models.coin_toss, (), _coin_data(), device=dev).potential.device_form
    q = 0.5 * randn(102400, 2) + torch.tensor([1.1, -0.7], device=dev)
    row_b("B coin W=102400 D=2 L=16", coin, q, 0.3)
    row_d("D coin W=102400 D=2 L=16", coin, 102400, 2, 0.3, q=q)


if __name__ == "__main__":
    main()
