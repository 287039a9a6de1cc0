#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a GPU machine

1. Prints the card (nvidia-smi name and power limit) and builds the CUDA
   kernels from the sources in this checkout with nvcc.
1, continued. Calls one constructor of each family without a ``device`` and
   fails unless what it made lies on the card.
2. Holds every fused kernel against its plain-torch version on the card, on
   the same inputs and the same Philox draws, at the main path's shapes,
   and times both (CUDA-graph replays timed with CUDA events). Kernel A
   also at a D off its 16-byte path (33), at D = 200 (its loop over
   dim-groups) and with a threshold that rejects every walker.
3. Runs the main path, ``run_hmc(kernel="auto")`` on the bench
   configuration (32-dim standard normal, 102400 walkers, 16 leapfrog
   steps), and checks its moments, acceptance and kernel launch count.
4. Runs the verify drive (correlated 2-D Gaussian, 8192 walkers) and the
   same at 10 dims through the generic kernel and checks their moments.
   The generic kernel stands for both TPU generic variants: the D | 128
   shapes (here D = 2) ran the walker-packed one there, the others (here
   D = 10) the unpacked one.
2, continued. Holds kernel D (the leapfrog trajectory) at the bench shape
   and kernel E (the N-body accelerations) at six shapes against their
   plain versions, kernel E to the bound of ``kernels.nbody_bound``
   (summation order plus each term's own rounding) and to the same bits
   from a second launch, and times them. Kernels D and B also with the
   correlated 32-dim Gaussian at W = 102400 (walker tile 4) and at shapes
   that take the other layouts of the Gaussian form (D = 128, 32 lanes a
   walker; tile 1; D = 33 off the 16-byte path; tile 2 is phase 2's W =
   8192, D = 32).
5. Runs ``run_hmc(integrator="pallas_leapfrog")`` on the bench
   configuration: the composed engine with kernel D's trajectory, one
   launch per transition; checks moments, acceptance and the count.
6. Runs the physics path at full size: a 16384-body Plummer sphere
   (``examples/make_examples.py``) through ``physics.simulate`` (velocity
   Verlet, kernel E twice per step), checks the launch count, the energy
   drift and 20 steps against the plain accelerations; then the adaptive
   Hermite and RK45 drivers on ``examples/nbody/pl1k.txt`` in float64.
7. Runs the correlated 32-dim Gaussian (cov = a a^T + 0.5 I) at the bench
   width, 102400 walkers and 16 steps: 7a ``run_hmc(kernel="auto")``
   through kernel B's Gaussian form, 7b the same through
   ``integrator="pallas_leapfrog"`` and kernel D; checks the moments
   against the closed form, the acceptance and 456 launches each.
8. Runs ChEES-HMC on models of the DSL, ``run_chees_hmc(kernel="auto")``
   at 102400 walkers, 200 warmup and 256 sampling transitions,
   ``max_steps=256``: 8a Bayesian logistic regression (D = 32, N = 256
   rows, data from numpy seeds 7, 8, 9) and 8b non-centred eight schools
   (D = 10), warmup and sampling both inside kernel B through the models'
   device forms (456 launches each, the leapfrog count read on the device,
   the warmup launches with the proposal outputs), moments held against a
   composed run of the same model (autograd through the DSL, 8192
   walkers); 8c the funnel model under ``reparam="auto"``, which has no
   device form, through the composed engine (no kernel launch); 8d the
   32-dim standard normal, whose sampling runs kernel A with the count
   read on the device; 8e the model of 8a through
   ``run_hmc(integrator="pallas_leapfrog")`` from 8a's posterior state:
   kernel D with the logistic form, one launch a transition, moments held
   to 8a's.
2, once more. Holds kernel B with the device step count (1, 7, max_steps
   and a count above it, which must clip) and with the proposal outputs,
   kernel A with the device step count, and the two model forms (the
   logistic form at W = 8192 and 102400 and at a D off the 16-byte path,
   each at the walker tile ``kernels.logistic_tile`` picks, the
   eight-schools form at W = 102400) against their plain versions, on
   the posterior states phase 8 left, each with a second launch that must
   give the same bits; kernel D with the logistic form at W = 102400 too.
   The logistic form's q', u', g' (and proposal, and kernel D's q', p',
   u', g') must be the plain version's bits, as both sum in the same order
   and round each multiply-add once. Times them, and for the logistic form
   the two ``torch.matmul`` calls and the sigmoid that its gradients
   amount to.

The line before the last is a JSON object with one entry per kernel, with
its time beside its bound (``bound_ms``: the larger of the bytes it must
move over ``HBM_BYTES_PER_S`` and its operations over the card's rate for
their type, from this run's shapes); the last line is ``{"ok": true, "device": {...}}``. Any failure raises, and the
script exits non-zero; without a CUDA device it exits non-zero at once.
It imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CSRC = "physicsbasedbayesianinference_tpu_torch/csrc"
SOURCE = f"{CSRC}/fused_hmc.cu"
TPU_KERNELS = "physicsbasedbayesianinference_tpu/ops/pallas_kernels.py"
SEED = 20261016
# The H100's published peaks (NVIDIA's data sheet, SXM part): HBM3 bytes/s,
# and arithmetic outside the tensor cores in instructions per lane and
# second, a multiply-add being one (67 TFLOP/s in float32 and 33.5 in
# float64 count it as two).
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = {torch.float32: 33.5e12, torch.float64: 16.75e12}


def bound(nbytes: float, ops: float, dtype=torch.float32) -> dict:
    """The least time the card could take: the bytes the function must
    move (each input read once, each output written once) at the memory's
    rate, or its arithmetic at the card's rate, whichever is longer."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / LANE_OPS_PER_S[dtype]
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None}  # no one PyTorch call computes any of them


def transition_bytes(w: int, d: int, cached: bool) -> int:
    """A fused transition: q in, q' and g' out, per walker u', accept_prob,
    energy_error (4 bytes each) and the decision (1); kernel B also reads
    the cached g and u."""
    return 4 * w * d * (4 if cached else 3) + w * (17 if cached else 13)


def gradient_ops(form, d: int) -> float:
    """Instructions per walker of one gradient of a device form, a
    multiply-add counted once (the transcendental functions as one)."""
    name, params = form
    if name == "gaussian":
        return d * d + d           # the D x D matvec and q - mu
    if name == "diag":
        return 2 * d
    if name == "funnel":
        return 4 * d + 8
    if name == "banana":
        return 12
    if name == "mixture":
        return params[0].shape[0] * (5 * d + 6)
    if name == "logistic":
        # z = x w + b and x^T r: N D multiply-adds each; the sigmoid and
        # the residual about 8 a row (exponential and reciprocal as one)
        n = params[1].shape[0]
        return 2 * n * d + 8 * n
    if name == "eight_schools_nc":
        return 12 * params[0].shape[0] + 4 * d
    n = params[0].shape[0]         # nbody: n^2 pairs of 12
    return 12 * n * n


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def median_ms(fn, reps: int = 20, rounds: int = 7) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA graph,
    so the host's Python overhead between launches is not timed; each
    replay timed with CUDA events; the median over ``rounds`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def compare(case: str, kernel_out: dict, plain_out: dict, log_u) -> float:
    """Kernel vs plain on one input; returns the largest absolute error."""
    derr_k, derr_p = kernel_out["energy_error"], plain_out["energy_error"]
    both_inf = torch.isinf(derr_k) & torch.isinf(derr_p)
    worst = 0.0
    for key in ("energy_error", "accept_prob"):
        k, p = kernel_out[key], plain_out[key]
        err = torch.where(both_inf, 0.0, (k - p).abs())
        err = torch.nan_to_num(err, nan=float("inf"))
        tol = 1e-4 * (1.0 + p.abs())
        if bool((err > torch.where(both_inf, 1.0, tol)).any()):
            fail(f"{case}: {key} differs by up to {err.max().item()}")
        worst = max(worst, err.max().item())
    acc_k, acc_p = kernel_out["accepted"], plain_out["accepted"]
    agree = acc_k == acc_p
    clear = (log_u + derr_p).abs() > 1e-4
    if bool((~agree & clear).any()):
        fail(f"{case}: {(~agree & clear).sum().item()} walkers decided "
             f"differently away from the accept boundary")
    if agree.float().mean().item() < 0.999:
        fail(f"{case}: decisions agree on only {agree.float().mean():.4%}")
    for key in ("q", "u", "g"):
        k, p = kernel_out[key][agree], plain_out[key][agree]
        if not torch.allclose(k, p, rtol=1e-5, atol=1e-5):
            fail(f"{case}: {key}' differs by up to "
                 f"{(k - p).abs().max().item()}")
        worst = max(worst, (k - p).abs().max().item())
    return worst


def named(out, order) -> dict:
    return dict(zip(order, out))


def make_examples():
    """``examples/make_examples.py`` of this checkout (numpy only)."""
    spec = importlib.util.spec_from_file_location(
        "make_examples", ROOT / "examples" / "make_examples.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


A_ORDER = ("q", "g", "u", "accept_prob", "accepted", "energy_error")
B_ORDER = ("q", "u", "g", "accept_prob", "accepted", "energy_error")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs only on "
             "a CUDA GPU")
    from physicsbasedbayesianinference_tpu_torch import (
        adaptation, chees, default_device, diagnostics, models, new_ensemble,
        physics, run_chees_hmc, run_hmc)
    from physicsbasedbayesianinference_tpu_torch.ops import _build, kernels
    from physicsbasedbayesianinference_tpu_torch.ops import philox
    from physicsbasedbayesianinference_tpu_torch.ops import potentials as pot
    from physicsbasedbayesianinference_tpu_torch.utils import convert

    # ---- 1. device and build ----------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch.cuda.get_device_name: {kind}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({lib.name})")

    # ---- 1, continued: constructors default to the card --------------------
    made = {
        "new_ensemble": new_ensemble(4, 3).q,
        "physics.new_system": physics.new_system(
            np.zeros((2, 3)), np.zeros((2, 3)), [1.0, 1.0]).x,
        "physics.kepler_two_body": physics.kepler_two_body()[0].x,
        "potentials.make_gaussian": pot.make_gaussian(
            [0.0, 0.0], cov=[[1.0, 0.0], [0.0, 1.0]]).device_form[1][1],
        "potentials.make_funnel": pot.make_funnel(4).device_form[1][0],
        "adaptation.variance_init": adaptation.variance_init(3).mean,
        "convert.nbody_system_from_numpy": convert.nbody_system_from_numpy(
            {"x": np.zeros((2, 3)), "v": np.zeros((2, 3)),
             "mass": np.ones(2), "time": np.zeros(())}).x}
    off_card = [k for k, t in made.items() if t.device.type != "cuda"]
    if default_device().type != "cuda" or off_card:
        fail(f"constructors called without a device made CPU tensors: "
             f"{off_card}")
    print(json.dumps({"phase": "constructors default to the card",
                      "checked": sorted(made)}))

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain Gaussian in fp32
    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def uniform(lo, hi, *shape):
        return (lo + (hi - lo) * torch.rand(*shape, generator=gen)).to(dev)

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def scalars(step, beta=1.0, scale=1.0):
        return torch.tensor([step, beta, scale], dtype=torch.float32,
                            device=dev)

    # ---- 2. kernels against their plain versions ---------------------------
    def check_a(case, w, d, steps, step, random_metric, time_it,
                threshold=1000.0):
        q = randn(w, d)
        if random_metric:
            k, mu, im = uniform(0.5, 2, d), randn(d), uniform(0.5, 2, d)
        else:
            k, mu = torch.ones(d, device=dev), torch.zeros(d, device=dev)
            im = torch.ones(d, device=dev)
        kw = dict(scalars=scalars(step), p_std=torch.sqrt(1.0 / im),
                  inv_mass=im, k_diag=k, mean=mu, num_steps=steps,
                  divergence_threshold=threshold)
        counter = 7
        out_k = named(kernels.fused_hmc_diag_quadratic(SEED, counter, q, **kw),
                      A_ORDER)
        out_p = named(kernels.fused_hmc_diag_quadratic_plain(
            SEED, counter, q, **kw), A_ORDER)
        log_u = torch.log(philox.accept_uniforms(SEED, counter, w, dev))
        err = compare(case, out_k, out_p, log_u)
        if threshold < 0 and not (
                not bool(out_k["accepted"].any())
                and torch.equal(out_k["q"], q)
                and torch.equal(out_k["g"], k * (q - mu))):
            fail(f"{case}: a rejected walker's q' is not q bit for bit, or "
                 f"its g' not k (q - mu)")
        # per dim: 4 instructions a step (drift, q - mu, times k, kick) and
        # some 10 for the two energies and the half kicks
        line = {"case": case, "max_abs_err": err,
                **bound(transition_bytes(w, d, False),
                        w * d * (4 * steps + 10))}
        if time_it:
            line["ms"] = median_ms(lambda: kernels.fused_hmc_diag_quadratic(
                SEED, counter, q, **kw))
            line["plain_ms"] = median_ms(
                lambda: kernels.fused_hmc_diag_quadratic_plain(
                    SEED, counter, q, **kw))
        print(json.dumps(line))
        return line

    def check_b(case, form, q, steps, step, time_it):
        w, d = q.shape
        vg = kernels.device_value_and_grad(form)
        u, g = vg(q)
        im = uniform(0.5, 2, d)
        kw = dict(scalars=scalars(step), p_std=torch.sqrt(1.0 / im),
                  inv_mass=im, num_steps=steps)
        counter = 11
        out_k = named(kernels.fused_hmc_transition(
            form, SEED, counter, q, u, g, **kw), B_ORDER)
        out_p = named(kernels.fused_hmc_transition_plain(
            form, SEED, counter, q, u, g, **kw), B_ORDER)
        log_u = torch.log(philox.accept_uniforms(SEED, counter, w, dev))
        err = compare(case, out_k, out_p, log_u)
        line = {"case": case, "max_abs_err": err,
                **bound(transition_bytes(w, d, True),
                        w * (steps + 1) * (gradient_ops(form, d) + 3 * d))}
        if time_it:
            line["ms"] = median_ms(lambda: kernels.fused_hmc_transition(
                form, SEED, counter, q, u, g, **kw))
            line["plain_ms"] = median_ms(
                lambda: kernels.fused_hmc_transition_plain(
                    form, SEED, counter, q, u, g, **kw))
        print(json.dumps(line))
        return line

    def gaussian_form(d):
        if d == 2:
            mean = torch.tensor([2.0, -1.0])
            cov = torch.tensor([[1.0, 0.8], [0.8, 2.0]])
        else:
            a = torch.randn(d, d, generator=gen) / d**0.5
            mean, cov = torch.randn(d, generator=gen), a @ a.T + 0.5 * \
                torch.eye(d)
        return pot.make_gaussian(mean, cov=cov, device=dev).device_form

    a_main = check_a("A std_normal W=102400 D=32 L=16", 102400, 32, 16, 0.3,
                     False, True)
    a_errs = [a_main["max_abs_err"]] + [
        check_a(case, w_, d_, 16, 0.2, True, False, thr)["max_abs_err"]
        for case, w_, d_, thr in (
            ("A random metric W=1000 D=5 L=16", 1000, 5, 1000.0),
            ("A random metric W=1000 D=33 L=16 (scalar path)", 1000, 33,
             1000.0),
            ("A random metric W=1000 D=200 L=16 (loop over groups)", 1000,
             200, 1000.0),
            ("A random metric W=1000 D=32 L=16 every walker rejected", 1000,
             32, -1e30),
            ("A random metric W=1000 D=200 L=16 every walker rejected",
             1000, 200, -1e30))]
    # shapes with D | 128 (the TPU ran them walker-packed) ...
    c_main = check_b("B gaussian W=8192 D=2 L=16", gaussian_form(2),
                     randn(8192, 2), 16, 0.3, True)
    c_errs = [c_main["max_abs_err"]]
    c_errs.append(check_b("B gaussian W=8192 D=32 L=16", gaussian_form(32),
                          randn(8192, 32), 16, 0.1, True)["max_abs_err"])
    c_errs.append(check_b(
        "B banana W=8192 D=2 L=16",
        pot.make_banana(device=dev).device_form,
        torch.stack([1.0 + 0.3 * randn(8192), 1.0 + 0.5 * randn(8192)], 1),
        16, 0.005, True)["max_abs_err"])
    c_errs.append(check_b(
        "B mixture W=8192 D=2 K=2 L=16",
        pot.make_gaussian_mixture(torch.tensor([[-3.0, 0.0], [3.0, 0.0]]),
                                  device=dev).device_form,
        3.0 * randn(8192, 2), 16, 0.3, True)["max_abs_err"])
    # ... and the others
    b_main = check_b("B funnel W=8192 D=10 L=16",
                     pot.make_funnel(10, device=dev).device_form,
                     0.5 * randn(8192, 10), 16, 0.1, True)
    b_errs = [b_main["max_abs_err"]]
    b_errs.append(check_b(
        "B nbody W=8192 N=8 D=24 L=16",
        pot.make_nbody_potential(uniform(0.5, 1.5, 8), 8, softening=0.5,
                                 device=dev).device_form,
        2.0 * randn(8192, 24), 16, 0.05, True)["max_abs_err"])

    # ---- 3. main path at full width ----------------------------------------
    kernels.reset_launch_counts()
    w, d, steps, n_warm, n_samp = 102400, 32, 16, 200, 256
    q0 = torch.randn(w, d, generator=seeded(0), device=dev)
    res = run_hmc(SEED, pot.make_standard_normal(d), q0, num_warmup=n_warm,
                  num_samples=n_samp, num_steps=steps, collect="moments",
                  kernel="auto")
    launched_a = kernels.launch_counts()["fused_hmc_diag_quadratic"]
    if res.kernel_used != "fused" or res.kernel_variant != "diag":
        fail(f"main path ran {res.kernel_used}/{res.kernel_variant}, want "
             f"fused/diag")
    if launched_a != n_warm + n_samp:
        fail(f"kernel A launched {launched_a} times in the main path, want "
             f"{n_warm + n_samp}")
    mean_err = res.mean.abs().max().item()
    var_err = (res.var - 1.0).abs().max().item()
    accept = res.accept_rate.item()
    if not (mean_err < 0.01 and var_err < 0.02 and 0.6 <= accept <= 0.99):
        fail(f"main path moments off: max|mean|={mean_err}, "
             f"max|var-1|={var_err}, accept={accept}")
    rate = w * n_samp / res.sampling_seconds
    print(json.dumps({
        "phase": "main path run_hmc std_normal_32d W=102400 L=16",
        "kernel_used": res.kernel_used, "kernel_variant": res.kernel_variant,
        "max_abs_mean": mean_err, "max_abs_var_minus_1": var_err,
        "accept_rate": accept, "step_size": res.step_size.item(),
        "sampling_seconds": res.sampling_seconds,
        "walker_transitions_per_s": rate,
        "ms_per_transition": 1e3 * res.sampling_seconds / n_samp,
        "kernel_ms": a_main["ms"]}))

    # ---- 4. verify drive: correlated 2-D Gaussian --------------------------
    target = pot.make_gaussian(torch.tensor([2.0, -1.0]),
                               cov=torch.tensor([[1.0, 0.8], [0.8, 2.0]]),
                               device=dev)
    q0 = torch.randn(8192, 2, generator=seeded(0), device=dev)
    kernels.reset_launch_counts()
    res2 = run_hmc(SEED + 1, target, q0, num_warmup=300, num_samples=300,
                   num_steps=16, collect="moments")
    launched_c = kernels.launch_counts()["fused_hmc_transition"]
    if res2.kernel_variant != "generic" or launched_c != 600:
        fail(f"verify drive ran {res2.kernel_variant} with {launched_c} "
             f"kernel B launches, want generic with 600")
    m = res2.mean.cpu()
    v = res2.var.cpu()
    if not (torch.allclose(m, torch.tensor([2.0, -1.0]), atol=0.05)
            and torch.allclose(v, torch.tensor([1.0, 2.0]), atol=0.05)):
        fail(f"verify drive moments off: mean={m.tolist()} var={v.tolist()}")
    print(json.dumps({
        "phase": "verify drive correlated 2-D Gaussian W=8192 L=16",
        "kernel_variant": res2.kernel_variant, "mean": m.tolist(),
        "var": v.tolist(), "accept_rate": res2.accept_rate.item(),
        "step_size": res2.step_size.item(),
        "walker_transitions_per_s": 8192 * 300 / res2.sampling_seconds}))

    # the same at D = 10, which the TPU ran through the unpacked generic
    # kernel; closed-form moments, held in units of each marginal's sd
    a10 = torch.randn(10, 10, generator=gen) / 10**0.5
    cov10 = a10 @ a10.T + 0.5 * torch.eye(10)
    mean10 = torch.randn(10, generator=gen)
    q0 = torch.randn(8192, 10, generator=seeded(0), device=dev)
    kernels.reset_launch_counts()
    res4 = run_hmc(SEED + 2, pot.make_gaussian(mean10, cov=cov10), q0,
                   num_warmup=300, num_samples=300, num_steps=16,
                   collect="moments")
    launched_b = kernels.launch_counts()["fused_hmc_transition"]
    if res4.kernel_variant != "generic" or launched_b != 600:
        fail(f"10-dim drive ran {res4.kernel_variant} with {launched_b} "
             f"kernel B launches, want generic with 600")
    sd10 = torch.sqrt(torch.diagonal(cov10))
    mean_err = ((res4.mean.cpu() - mean10) / sd10).abs().max().item()
    var_err = (res4.var.cpu() / sd10**2 - 1.0).abs().max().item()
    if not (mean_err < 0.05 and var_err < 0.05):
        fail(f"10-dim drive moments off: max mean error {mean_err} sd, "
             f"max relative var error {var_err}")
    print(json.dumps({
        "phase": "correlated 10-dim Gaussian W=8192 L=16",
        "kernel_variant": res4.kernel_variant, "max_mean_err_sd": mean_err,
        "max_rel_var_err": var_err, "accept_rate": res4.accept_rate.item(),
        "step_size": res4.step_size.item(),
        "walker_transitions_per_s": 8192 * 300 / res4.sampling_seconds}))

    # composed engine on the bench configuration, for comparison only
    q0 = torch.randn(w, d, generator=seeded(0), device=dev)
    res3 = run_hmc(SEED, pot.make_standard_normal(d), q0,
                   num_warmup=n_warm, num_samples=n_samp, num_steps=steps,
                   collect="moments", kernel="composed")
    print(json.dumps({
        "phase": "composed engine run_hmc std_normal_32d W=102400 L=16",
        "accept_rate": res3.accept_rate.item(),
        "walker_transitions_per_s": w * n_samp / res3.sampling_seconds}))

    # ---- 2, continued: kernels D and E against their plain versions ------
    # (after phases 3 and 4, with a generator of their own, so that the
    # earlier phases draw what they drew before these checks existed)

    # kernel D, the leapfrog trajectory, at the bench shape
    gen2 = torch.Generator(device="cpu").manual_seed(SEED + 5)

    def randn2(*shape):
        return torch.randn(*shape, generator=gen2).to(dev)

    def check_d(case, form, w, d, steps, step, inv_mass, time_it=True, *,
                q=None, p=None, library=None, bits=False):
        """Kernel D against its plain version on ``q``, ``p`` (random
        unless given); ``bits``: every output must be the plain version's
        bits, and a second launch's."""
        if q is None:
            q, p = randn2(w, d), randn2(w, d)
        kw = dict(step_size=torch.tensor([step], device=dev),
                  num_steps=steps, inv_mass=inv_mass)
        out_k = kernels.leapfrog_trajectory(form, q, p, **kw)
        out_p = kernels.leapfrog_trajectory_plain(form, q, p, **kw)
        again = (kernels.leapfrog_trajectory(form, q, p, **kw) if bits
                 else out_k)
        torch.cuda.synchronize()
        worst = 0.0
        for key, k, pl, k2 in zip(("q", "p", "u", "g"), out_k, out_p, again):
            if not torch.allclose(k, pl, rtol=1e-5, atol=1e-5):
                fail(f"{case}: {key}' differs by up to "
                     f"{(k - pl).abs().max().item()}")
            if bits and not (torch.equal(k, pl) and torch.equal(k, k2)):
                fail(f"{case}: {key}' is not the plain version's bits, or "
                     f"a second launch's ({(k != pl).sum().item()} "
                     f"differ)")
            worst = max(worst, (k - pl).abs().max().item())
        # q, p in; q', p', g' and u' out
        line = {"case": case, "max_abs_err": worst,
                **bound(4 * w * (5 * d + 1),
                        w * (steps + 1) * (gradient_ops(form, d) + 3 * d))}
        if time_it:
            line["ms"] = median_ms(lambda: kernels.leapfrog_trajectory(
                form, q, p, **kw))
            line["plain_ms"] = median_ms(
                lambda: kernels.leapfrog_trajectory_plain(form, q, p, **kw),
                **({} if library is None else dict(reps=2, rounds=3)))
            if library is not None:
                line["library_ms"] = median_ms(lambda: library(q, steps))
        if bits:
            line["same_bits_as_plain"] = True
        print(json.dumps(line))
        return line

    d_main = check_d("D std_normal (diag form) W=102400 D=32 L=16",
                     ("diag", (torch.ones(32, device=dev),
                               torch.zeros(32, device=dev))),
                     102400, 32, 16, 0.3, torch.ones(32, device=dev))
    a32 = torch.randn(32, 32, generator=gen2) / 32**0.5
    corr32 = pot.make_gaussian(torch.randn(32, generator=gen2),
                               cov=a32 @ a32.T + 0.5 * torch.eye(32),
                               device=dev).device_form
    d_corr = check_d(
        "D correlated gaussian W=102400 D=32 L=16", corr32, 102400, 32, 16,
        0.1, (0.5 + 1.5 * torch.rand(32, generator=gen2)).to(dev))
    d_errs = [d_main["max_abs_err"], d_corr["max_abs_err"]]
    # kernel B at the same shape and form, for D's time beside B's
    b_corr = check_b("B correlated gaussian W=102400 D=32 L=16", corr32,
                     randn2(102400, 32), 16, 0.1, True)
    b_errs.append(b_corr["max_abs_err"])
    # the Gaussian form's other layouts (kernels.walker_tile picks from the
    # shape; 4 above, 2 at W=8192 D=32): 32 lanes a walker with tile 4, tile
    # 1 on the 16-byte path and a D off it; held against the plain version,
    # not timed
    for w_, d_ in ((8192, 128), (1000, 32), (1000, 33)):
        form = gaussian_form(d_)
        tag = (f"gaussian W={w_} D={d_} L=16 (tile "
               f"{kernels.walker_tile(w_, d_)})")
        d_errs.append(check_d(f"D {tag}", form, w_, d_, 16, 0.1,
                              uniform(0.5, 2, d_), False)["max_abs_err"])
        b_errs.append(check_b(f"B {tag}", form, randn(w_, d_), 16, 0.1,
                              False)["max_abs_err"])

    # kernel E, the N-body accelerations: the 16384-body Plummer sphere of
    # phase 6, pl1k with a body at the origin and no softening, pl1k in
    # float64, pl100
    examples = make_examples()
    plummer_path = _build.BUILD_DIR / "plummer_16384.txt"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    examples.plummer(str(plummer_path), 16384, seed=16384, tmax=1.0,
                     dt=5e-4)
    nbody_dir = ROOT / "examples" / "nbody"

    def load(path, dtype):
        sys_, tmax, dt = physics.load_nbody_text(str(path), dtype=dtype,
                                                 device=dev)
        return physics.center_of_mass_frame(sys_), tmax, dt

    def check_e(case, x, m, softening, time_it):
        n = x.shape[0]
        kw = dict(g_const=1.0, softening=softening)
        a_k = kernels.nbody_accelerations_tiled(x, m, **kw)
        again = kernels.nbody_accelerations_tiled(x, m, **kw)
        a_p = kernels.nbody_accelerations_tiled_plain(x, m, **kw)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(a_k).all()):
            fail(f"{case}: non-finite accelerations")
        if not torch.equal(a_k, again):
            fail(f"{case}: two launches on the same input differ")
        err = (a_k - a_p).abs().double()
        # in units of u sqrt(N) S_i; the bound is C + K / sqrt(N) of them
        u = torch.finfo(x.dtype).eps / 2
        ratio = (err / (u * n**0.5 * kernels.nbody_abs_sum(
            x, m, **kw)[:, None])).max().item()
        allowed = (kernels.NBODY_BOUND_C
                   + kernels.NBODY_BOUND_TERM / n**0.5)
        if not ratio <= allowed:
            fail(f"{case}: |a_kernel - a_plain| reaches {ratio:.3g} "
                 f"u sqrt(N) S_i, over the bound {allowed:.3g}")
        # x and m in, a out; 12 instructions a pair (3 subtractions, 3
        # multiply-adds for r^2, 3 multiplications for m / r^3, 3
        # multiply-adds into a)
        line = {"case": case, "max_abs_err": err.max().item(),
                "split": kernels.nbody_split(n), "worst_ratio": ratio,
                "allowed_ratio": allowed,
                **bound(7 * n * x.element_size(), 12.0 * n * n, x.dtype)}
        if time_it:
            line["ms"] = median_ms(
                lambda: kernels.nbody_accelerations_tiled(x, m, **kw))
            line["plain_ms"] = median_ms(
                lambda: kernels.nbody_accelerations_tiled_plain(x, m, **kw),
                reps=3, rounds=3)
        print(json.dumps(line))
        return line

    plummer, _, _ = load(plummer_path, torch.float32)
    e_main = check_e("E float32 Plummer N=16384 eps=0.05", plummer.x,
                     plummer.mass, 0.05, True)
    e_errs = [e_main["max_abs_err"]]
    e_errs.append(check_e("E float32 Plummer N=16384 eps=0", plummer.x,
                          plummer.mass, 0.0, False)["max_abs_err"])
    e_errs.append(check_e("E float32 Plummer first 4096 bodies eps=0.05",
                          plummer.x[:4096].contiguous(),
                          plummer.mass[:4096].contiguous(), 0.05,
                          True)["max_abs_err"])
    pl1k32, _, _ = load(nbody_dir / "pl1k.txt", torch.float32)
    at_origin = pl1k32.x.clone()
    at_origin[0] = 0.0
    e_errs.append(check_e("E float32 N=1000 body at the origin eps=0",
                          at_origin, pl1k32.mass, 0.0, False)["max_abs_err"])
    pl1k64, _, _ = load(nbody_dir / "pl1k.txt", torch.float64)
    e_errs.append(check_e("E float64 N=1000 eps=0.05", pl1k64.x,
                          pl1k64.mass, 0.05, True)["max_abs_err"])
    pl100, _, _ = load(nbody_dir / "pl100.txt", torch.float32)
    e_errs.append(check_e("E float32 N=100 eps=0.05", pl100.x, pl100.mass,
                          0.05, True)["max_abs_err"])

    # ---- 5. run_hmc(integrator="pallas_leapfrog") on the bench config ------
    q0 = torch.randn(w, d, generator=seeded(0), device=dev)
    kernels.reset_launch_counts()
    res5 = run_hmc(SEED, pot.make_standard_normal(d), q0,
                   num_warmup=n_warm, num_samples=n_samp, num_steps=steps,
                   collect="moments", integrator="pallas_leapfrog")
    launched_d = kernels.launch_counts()["leapfrog_trajectory"]
    if res5.kernel_used != "composed" or launched_d != n_warm + n_samp:
        fail(f"pallas_leapfrog run ran {res5.kernel_used} with {launched_d} "
             f"kernel D launches, want composed with {n_warm + n_samp}")
    mean_err = res5.mean.abs().max().item()
    var_err = (res5.var - 1.0).abs().max().item()
    accept = res5.accept_rate.item()
    if not (mean_err < 0.01 and var_err < 0.02 and 0.6 <= accept <= 0.99):
        fail(f"pallas_leapfrog moments off: max|mean|={mean_err}, "
             f"max|var-1|={var_err}, accept={accept}")
    print(json.dumps({
        "phase": "run_hmc integrator=pallas_leapfrog std_normal_32d "
                 "W=102400 L=16",
        "kernel_used": res5.kernel_used, "launches": launched_d,
        "max_abs_mean": mean_err, "max_abs_var_minus_1": var_err,
        "accept_rate": accept, "step_size": res5.step_size.item(),
        "sampling_seconds": res5.sampling_seconds,
        "walker_transitions_per_s": w * n_samp / res5.sampling_seconds,
        "kernel_ms": d_main["ms"]}))

    # ---- 6. physics at full size: 16384-body Plummer sphere -----------------
    n_body, dt, n_steps = plummer.num_bodies, 5e-4, 2000
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    traj = physics.simulate(plummer, dt, n_steps, method="velocity_verlet",
                            save_every=100, softening=0.05)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched_e = kernels.launch_counts()["nbody_accelerations_tiled"]
    if launched_e != 2 * n_steps:
        fail(f"simulate launched kernel E {launched_e} times, want "
             f"{2 * n_steps}")
    drift = physics.energy_drift(traj).max().item()
    if not (traj.num_valid == 20 and drift < 1e-3
            and bool(torch.isfinite(traj.x).all())):
        fail(f"Plummer run off: {traj.num_valid} saves, max relative energy "
             f"drift {drift}")
    print(json.dumps({
        "phase": "physics simulate Plummer N=16384 velocity_verlet "
                 "dt=5e-4 2000 steps eps=0.05 float32",
        "launches": launched_e, "max_rel_energy_drift": drift,
        "seconds": seconds, "steps_per_s": n_steps / seconds,
        "pair_interactions_per_s": n_body**2 * launched_e / seconds,
        "kernel_ms": e_main["ms"],
        "kernel_pair_interactions_per_s": n_body**2 / (e_main["ms"] * 1e-3),
        "final_time": traj.final.time.item()}))

    # 20 steps through kernel E against the same steps through the plain
    # accelerations: float32 positions of O(1); the summation-order
    # differences of the accelerations move x by about (20 dt)^2 / 2 *
    # 1e-5 ~ 1e-9, so what is left is x's own rounding (~1e-7): 1e-5 abs.
    vv = physics.get_physics_integrator("velocity_verlet")
    dt_t = torch.tensor(dt, device=dev)
    ends = []
    for accel in (kernels.nbody_accelerations_tiled,
                  kernels.nbody_accelerations_tiled_plain):
        x, v = plummer.x, plummer.v
        for _ in range(20):
            x, v = vv(lambda y: accel(y, plummer.mass, g_const=1.0,
                                      softening=0.05), x, v, dt_t)
        ends.append(x)
    x_err = (ends[0] - ends[1]).abs().max().item()
    if not x_err <= 1e-5:
        fail(f"20 Plummer steps: kernel E and plain routes differ by "
             f"{x_err} in position")
    print(json.dumps({"phase": "Plummer 20 steps kernel E vs plain route",
                      "max_abs_position_err": x_err, "tolerance": 1e-5}))

    # the adaptive drivers on pl1k in float64
    for name, run in (
            ("simulate_adaptive hermite advanced dt0=0.05 to t=0.1",
             lambda s: physics.simulate_adaptive(
                 s, 0.05, 0.1, method="hermite", criterion="advanced",
                 max_steps=1024, softening=0.05)),
            ("simulate_rk45 rtol=1e-8 atol=1e-10 to t=1.0",
             lambda s: physics.simulate_rk45(
                 s, 5e-4, 1.0, rtol=1e-8, atol=1e-10, max_steps=1024,
                 softening=0.05))):
        final_time = 0.1 if "hermite" in name else 1.0
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        traj = run(pl1k64)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()["nbody_accelerations_tiled"]
        n_valid = traj.num_valid
        drift = (physics.energy_drift(traj)[:n_valid].max().item()
                 if n_valid else float("nan"))
        reached = traj.final.time.item()
        if not (0 < n_valid < 1024 and abs(reached - final_time) < 1e-12
                and drift < 1e-6 and launches > 0):
            fail(f"pl1k {name}: {n_valid} steps to t={reached}, drift "
                 f"{drift}, {launches} kernel E launches")
        print(json.dumps({
            "phase": f"physics pl1k float64 eps=0.05 {name}",
            "num_valid": n_valid, "final_time": reached,
            "max_rel_energy_drift": drift, "launches": launches,
            "seconds": seconds}))

    # ---- 7. the correlated Gaussian at full width ---------------------------
    # mean and cov = a a^T + 0.5 I with a = randn(32, 32) / sqrt(32), from a
    # generator of the phase's own; 7a through the generic fused kernel (B),
    # 7b through the composed engine around the leapfrog kernel (D).
    # Moments against the closed form in units of each marginal's sd. The
    # limits: counting each walker's 256 draws as one independent draw, the
    # mean's standard error is 1 / sqrt(W) = 0.0031 sd and the variance's
    # sqrt(2 / W) = 0.0044 of itself; 0.02 sd and 0.03 are over six of
    # those, so a miss is a fault and not a Monte-Carlo fluctuation.
    gen7 = torch.Generator(device="cpu").manual_seed(SEED + 7)
    a7 = torch.randn(d, d, generator=gen7) / d**0.5
    mean7 = torch.randn(d, generator=gen7)
    cov7 = a7 @ a7.T + 0.5 * torch.eye(d)
    sd7 = torch.sqrt(torch.diagonal(cov7))
    corr_launches = {}
    for sub, wrapper, kernel_ms, extra in (
            ("7a", "fused_hmc_transition", b_corr["ms"],
             dict(kernel="auto")),
            ("7b", "leapfrog_trajectory", d_corr["ms"],
             dict(integrator="pallas_leapfrog"))):
        q0 = torch.randn(w, d, generator=seeded(0), device=dev)
        kernels.reset_launch_counts()
        res7 = run_hmc(SEED + 3, pot.make_gaussian(mean7, cov=cov7), q0,
                       num_warmup=n_warm, num_samples=n_samp,
                       num_steps=steps, collect="moments", **extra)
        launched = kernels.launch_counts()[wrapper]
        corr_launches[sub] = launched
        ran = (res7.kernel_used, res7.kernel_variant)
        want = (("fused", "generic") if sub == "7a"
                else ("composed", "composed"))
        if ran != want or launched != n_warm + n_samp:
            fail(f"phase {sub} ran {ran} with {launched} launches of "
                 f"{wrapper}, want {want} with {n_warm + n_samp}")
        mean_err = ((res7.mean.cpu() - mean7) / sd7).abs().max().item()
        var_err = (res7.var.cpu() / sd7**2 - 1.0).abs().max().item()
        accept = res7.accept_rate.item()
        if not (mean_err < 0.02 and var_err < 0.03
                and 0.6 <= accept <= 0.99):
            fail(f"phase {sub} moments off: max mean error {mean_err} sd "
                 f"(limit 0.02), max relative var error {var_err} (limit "
                 f"0.03), accept={accept}")
        print(json.dumps({
            "phase": f"{sub} run_hmc correlated 32-dim Gaussian W=102400 "
                     f"L=16 " + " ".join(f"{k}={v}" for k, v in extra.items()),
            "kernel_used": res7.kernel_used,
            "kernel_variant": res7.kernel_variant, "launches": launched,
            "max_mean_err_sd": mean_err, "max_rel_var_err": var_err,
            "accept_rate": accept, "step_size": res7.step_size.item(),
            "sampling_seconds": res7.sampling_seconds,
            "walker_transitions_per_s": w * n_samp / res7.sampling_seconds,
            "ms_per_transition": 1e3 * res7.sampling_seconds / n_samp,
            "kernel_ms": kernel_ms}))

    # ---- 8. ChEES-HMC on models of the DSL ----------------------------------
    # 8a and 8b: warmup and sampling inside kernel B through the model's
    # device form, at the bench width. The reference is the composed engine
    # on the same model (autograd through the DSL, its own random stream) at
    # 8192 walkers. Limits: counting each of the reference's walkers as one
    # independent draw, its mean's standard error is 1 / sqrt(8192) = 0.011
    # sd and its variance's sqrt(2 / 8192) = 0.0156 of itself (more for the
    # heavy-tailed log tau); 4 of those, 0.044 sd and 0.0625, are the gates.
    n_warm8, n_samp8, max_steps8 = 200, 256, 256
    x_lr, y_lr = models.logistic_regression_data(256, 31)

    def chees_on_model(sub, title, mp, init_step):
        d8 = mp.num_dims
        kw = dict(num_warmup=n_warm8, num_samples=n_samp8,
                  max_steps=max_steps8, init_step_size=init_step,
                  collect="moments")
        q0 = 0.3 * torch.randn(w, d8, generator=seeded(0), device=dev)
        kernels.reset_launch_counts()
        res = run_chees_hmc(SEED + 8, mp.potential, q0, kernel="auto", **kw)
        counts = kernels.launch_counts()
        by = dict(kernels.fused_hmc_transition.launches_by)
        if (res.kernel_used, res.warmup_kernel_used) != ("fused", "fused"):
            fail(f"phase {sub} ran warmup {res.warmup_kernel_used}, "
                 f"sampling {res.kernel_used}, want fused, fused")
        want = {"fused_hmc_transition": n_warm8 + n_samp8,
                "fused_hmc_diag_quadratic": 0, "leapfrog_trajectory": 0,
                "nbody_accelerations_tiled": 0}
        if counts != want or by["counted"] != n_samp8 or \
                by["counted+proposal"] != n_warm8:
            fail(f"phase {sub} launched {counts} ({by}), want {want} with "
                 f"{n_warm8} counted+proposal and {n_samp8} counted")
        ref = run_chees_hmc(SEED + 9, mp.potential, q0[:8192].clone(),
                            kernel="composed", **kw)
        if ref.kernel_used != "composed" or sum(
                kernels.launch_counts().values()) != n_warm8 + n_samp8:
            fail(f"phase {sub}: the composed reference launched a kernel")
        sd = torch.sqrt(ref.var)
        mean_err = ((res.mean - ref.mean) / sd).abs().max().item()
        var_err = (res.var / ref.var - 1.0).abs().max().item()
        accept, div = res.accept_rate.item(), res.divergence_rate.item()
        if not (mean_err < 0.044 and var_err < 0.0625
                and 0.6 <= accept <= 0.99 and div <= 0.01
                and bool(torch.isfinite(res.mean).all())):
            fail(f"phase {sub} off: mean {mean_err} sd from the composed "
                 f"run (limit 0.044), var {var_err} (limit 0.0625), "
                 f"accept {accept}, divergence rate {div}")
        mean_steps = res.mean_num_steps.item()
        # min-ESS/s from a tail of 256 more transitions of 512 walkers' worth
        # of history, as the JAX package's model benchmark takes it
        step = chees.build_fused_jittered_step(
            mp.potential, num_dims=d8, max_steps=max_steps8)
        hs = torch.as_tensor(chees.halton_sequence(
            n_warm8 + 2 * n_samp8)[n_warm8 + n_samp8:]).to(dev)
        state, hist = res.state, []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_samp8):
            count = chees.steps_for(res.trajectory_time, hs[i],
                                    res.step_size, max_steps8)
            state, _ = step((SEED + 8, n_warm8 + n_samp8 + i), state,
                            res.step_size, count)
            hist.append(state.ensemble.q[:512].clone())
        torch.cuda.synchronize()
        tail_seconds = time.perf_counter() - t0
        min_ess = diagnostics.effective_sample_size(
            torch.stack(hist)).min().item() * (w / 512)
        print(json.dumps({
            "phase": f"{sub} run_chees_hmc {title} W={w} D={d8} "
                     f"warmup={n_warm8} samples={n_samp8} "
                     f"max_steps={max_steps8} kernel=auto",
            "kernel_used": res.kernel_used,
            "warmup_kernel_used": res.warmup_kernel_used,
            "launches": counts["fused_hmc_transition"], "launches_by": by,
            "max_mean_err_sd_vs_composed": mean_err,
            "max_rel_var_err_vs_composed": var_err,
            "accept_rate": accept, "divergence_rate": div,
            "step_size": res.step_size.item(),
            "trajectory_time": res.trajectory_time.item(),
            "mean_num_steps": mean_steps,
            "warmup_seconds": res.warmup_seconds,
            "sampling_seconds": res.sampling_seconds,
            "ms_per_transition": 1e3 * res.sampling_seconds / n_samp8,
            "warmup_ms_per_transition": 1e3 * res.warmup_seconds / n_warm8,
            "walker_transitions_per_s": w * n_samp8 / res.sampling_seconds,
            "grad_evals_per_s": (w * n_samp8 * mean_steps
                                 / res.sampling_seconds),
            "min_ess_per_s": min_ess / tail_seconds,
            "composed_ms_per_transition_W8192":
                1e3 * ref.sampling_seconds / n_samp8}))
        return res, counts["fused_hmc_transition"], by

    mp_lr = models.make_model_potential(models.logistic_regression,
                                        (x_lr, y_lr), {})
    res8a, launched_lr, by_lr = chees_on_model(
        "8a", "logistic regression N=256", mp_lr, 0.05)
    mp_es = models.make_model_potential(models.eight_schools_noncentered,
                                        (), models.EIGHT_SCHOOLS_DATA)
    res8b, launched_es, by_es = chees_on_model(
        "8b", "eight schools non-centred", mp_es, 0.22)

    # 8c: a DSL model without a device form takes the composed route. The
    # decentered funnel is v ~ N(0, 3), x_decentered ~ N(0, 1)^15.
    mp_fn = models.make_model_potential(models.funnel, (), {"dim": 15},
                                        reparam="auto")
    if mp_fn.potential.device_form is not None or mp_fn.num_dims != 16:
        fail("phase 8c: the reparameterised funnel has a device form")
    kernels.reset_launch_counts()
    reads = chees._host_count.reads
    res8c = run_chees_hmc(SEED + 10, mp_fn.potential, mp_fn.init(SEED, 8192),
                          num_warmup=n_warm8, num_samples=n_samp8,
                          max_steps=max_steps8, collect="moments",
                          kernel="auto")
    reads = chees._host_count.reads - reads
    sd_fn = torch.tensor([3.0] + [1.0] * 15, device=dev)
    mean_err = (res8c.mean / sd_fn).abs().max().item()
    var_err = (res8c.var / sd_fn**2 - 1.0).abs().max().item()
    values = mp_fn.trace_values(res8c.state.ensemble.q)
    x_want = torch.exp(0.5 * values["v"])[:, None] * values["x_decentered"]
    if not (res8c.kernel_used == res8c.warmup_kernel_used == "composed"
            and sum(kernels.launch_counts().values()) == 0
            and reads == n_warm8 + n_samp8
            and mean_err < 0.05 and var_err < 0.1
            and values["x"].shape == (8192, 15)
            and torch.allclose(values["x"], x_want, rtol=1e-5, atol=1e-6)):
        fail(f"phase 8c off: ran {res8c.kernel_used}, launches "
             f"{kernels.launch_counts()}, {reads} host reads, mean "
             f"{mean_err} sd, var {var_err}")
    print(json.dumps({
        "phase": "8c run_chees_hmc funnel model reparam=auto W=8192 D=16 "
                 "(no device form: the composed route)",
        "kernel_used": res8c.kernel_used, "host_reads_of_the_count": reads,
        "max_mean_err_sd": mean_err, "max_rel_var_err": var_err,
        "accept_rate": res8c.accept_rate.item(),
        "trajectory_time": res8c.trajectory_time.item(),
        "mean_num_steps": res8c.mean_num_steps.item(),
        "ms_per_transition": 1e3 * res8c.sampling_seconds / n_samp8}))

    # 8d: a diag-quadratic target: warmup composed (kernel="auto" keeps
    # it so, as the JAX package does), sampling in kernel A with the count
    # read on the device
    kernels.reset_launch_counts()
    q0 = torch.randn(w, d, generator=seeded(0), device=dev)
    res8d = run_chees_hmc(SEED + 11, pot.make_standard_normal(d), q0,
                          num_warmup=100, num_samples=n_samp8,
                          max_steps=max_steps8, collect="moments")
    launched_a_counted = kernels.launch_counts()["fused_hmc_diag_quadratic"]
    mean_err = res8d.mean.abs().max().item()
    var_err = (res8d.var - 1.0).abs().max().item()
    if not ((res8d.kernel_used, res8d.warmup_kernel_used)
            == ("fused", "composed") and launched_a_counted == n_samp8
            and kernels.launch_counts()["fused_hmc_transition"] == 0
            and mean_err < 0.01 and var_err < 0.02
            and 0.6 <= res8d.accept_rate.item() <= 0.99):
        fail(f"phase 8d off: {res8d.warmup_kernel_used}/{res8d.kernel_used},"
             f" {launched_a_counted} kernel A launches, mean {mean_err}, "
             f"var {var_err}, accept {res8d.accept_rate.item()}")
    print(json.dumps({
        "phase": "8d run_chees_hmc std_normal_32d W=102400 kernel=auto",
        "kernel_used": res8d.kernel_used,
        "warmup_kernel_used": res8d.warmup_kernel_used,
        "launches": launched_a_counted, "max_abs_mean": mean_err,
        "max_abs_var_minus_1": var_err,
        "accept_rate": res8d.accept_rate.item(),
        "trajectory_time": res8d.trajectory_time.item(),
        "mean_num_steps": res8d.mean_num_steps.item(),
        "ms_per_transition": 1e3 * res8d.sampling_seconds / n_samp8}))

    # 8e: kernel D with the logistic form, as a user reaches it: run_hmc
    # with integrator="pallas_leapfrog" on the model of 8a, from the
    # posterior state 8a left (so no burn-in), 16 steps a transition;
    # moments held to 8a's with 8a's gates
    n_warm8e, n_samp8e = 100, 100
    kernels.reset_launch_counts()
    res8e = run_hmc(SEED + 12, mp_lr.potential,
                    res8a.state.ensemble.q.clone(), num_warmup=n_warm8e,
                    num_samples=n_samp8e, num_steps=steps,
                    init_step_size=res8a.step_size.item(),
                    collect="moments", integrator="pallas_leapfrog")
    counts8e = kernels.launch_counts()
    launched_d_lr = counts8e["leapfrog_trajectory"]
    sd_8a = torch.sqrt(res8a.var)
    mean_err = ((res8e.mean - res8a.mean) / sd_8a).abs().max().item()
    var_err = (res8e.var / res8a.var - 1.0).abs().max().item()
    accept = res8e.accept_rate.item()
    if not (res8e.kernel_used == "composed"
            and launched_d_lr == n_warm8e + n_samp8e
            and sum(counts8e.values()) == launched_d_lr
            and mean_err < 0.044 and var_err < 0.0625
            and 0.6 <= accept <= 0.99):
        fail(f"phase 8e off: ran {res8e.kernel_used} with {counts8e}, mean "
             f"{mean_err} sd from 8a (limit 0.044), var {var_err} (limit "
             f"0.0625), accept {accept}")
    print(json.dumps({
        "phase": f"8e run_hmc logistic regression N=256 W={w} D=32 L={steps} "
                 f"integrator=pallas_leapfrog from 8a's posterior",
        "kernel_used": res8e.kernel_used, "launches": launched_d_lr,
        "max_mean_err_sd_vs_8a": mean_err, "max_rel_var_err_vs_8a": var_err,
        "accept_rate": accept, "step_size": res8e.step_size.item(),
        "ms_per_transition": 1e3 * res8e.sampling_seconds / n_samp8e,
        "walker_transitions_per_s": w * n_samp8e / res8e.sampling_seconds}))

    # ---- 2, once more: the count on the device, the proposal, the forms ---
    gen8 = torch.Generator(device="cpu").manual_seed(SEED + 8)

    def count(n):
        return torch.tensor([n], dtype=torch.int32, device=dev)

    def check_b8(case, form, q, steps, step, time_it, *, counted=None,
                 proposal=False, plain_reps=20, library=None, mass=None,
                 bits=False):
        """Kernel B against its plain version; ``counted``: the count goes
        as a device tensor with this max_steps (and the fixed-count
        kernel's first six outputs must be the same bits); ``mass``: the
        metric [D] (a random one unless given); ``bits``: q', u', g' of
        every walker whose decision agrees, and the proposal, must be the
        plain version's bits."""
        w_, d_ = q.shape
        u, g = kernels.device_value_and_grad(form)(q)
        im = ((0.5 + 1.5 * torch.rand(d_, generator=gen8)).to(dev)
              if mass is None else (1.0 / mass).contiguous())
        kw = dict(scalars=scalars(step), p_std=torch.sqrt(1.0 / im),
                  inv_mass=im, emit_proposal=proposal)
        ran = steps if counted is None else min(max(steps, 1), counted)
        if counted is not None:
            kw.update(num_steps=count(steps), max_steps=counted)
        else:
            kw.update(num_steps=steps)
        counter = 13

        def run():
            return kernels.fused_hmc_transition(form, SEED, counter, q, u, g,
                                                **kw)

        def run_plain():
            return kernels.fused_hmc_transition_plain(form, SEED, counter, q,
                                                      u, g, **kw)

        out, again, plain = run(), run(), run_plain()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            fail(f"{case}: two launches on the same input differ")
        if counted is not None:
            fixed = kernels.fused_hmc_transition(
                form, SEED, counter, q, u, g, **{
                    **kw, "num_steps": ran, "max_steps": None,
                    "emit_proposal": False})
            if not all(torch.equal(a, b) for a, b in zip(out, fixed)):
                fail(f"{case}: the device count {steps} (max {counted}) "
                     f"does not give the fixed count {ran}'s bits")
        log_u = torch.log(philox.accept_uniforms(SEED, counter, w_, dev))
        err = compare(case, named(out, B_ORDER), named(plain, B_ORDER), log_u)
        if bits:
            agree = out[4] == plain[4]
            pairs = [(k, a[agree], b[agree]) for k, a, b in zip(
                ("q", "u", "g"), out[:3], plain[:3])]
            pairs += list(zip(("q_prop", "p_prop"), out[6:], plain[6:]))
            for key, a, b in pairs:
                if not torch.equal(a, b):
                    fail(f"{case}: {key} is not the plain version's bits "
                         f"({(a != b).sum().item()} differ)")
        if proposal:
            for key, k, pl in zip(("q_prop", "p_prop"), out[6:], plain[6:]):
                if not torch.allclose(k, pl, rtol=1e-5, atol=1e-5):
                    fail(f"{case}: {key} differs by up to "
                         f"{(k - pl).abs().max().item()}")
                err = max(err, (k - pl).abs().max().item())
        line = {"case": case, "max_abs_err": err,
                "accepted": out[4].float().mean().item(),
                **({"same_bits_as_plain": True} if bits else {}),
                **bound(transition_bytes(w_, d_, True)
                        + (8 * w_ * d_ if proposal else 0),
                        w_ * (ran + 1) * (gradient_ops(form, d_) + 3 * d_))}
        if time_it:
            line["ms"] = median_ms(run)
            # the plain version reads a tensor count on the host, which a
            # graph capture cannot hold: it is timed at the int it holds
            plain_kw = {**kw, "num_steps": ran, "max_steps": None}
            line["plain_ms"] = median_ms(
                lambda: kernels.fused_hmc_transition_plain(
                    form, SEED, counter, q, u, g, **plain_kw),
                reps=plain_reps, rounds=3)
            if library is not None:
                line["library_ms"] = median_ms(lambda: library(q, ran))
        print(json.dumps(line))
        return line

    # the correlated Gaussian of phase 7 at the bench shape (walker tile 4)
    q_corr = randn2(102400, 32)
    n_errs = [check_b8(f"B counted n={n} max=16 correlated gaussian "
                       f"W=102400 D=32", corr32, q_corr, n, 0.1, n == 16,
                       counted=16, plain_reps=2) for n in (1, 7, 16, 40)]
    b_counted = n_errs[2]
    b_prop = check_b8("B counted+proposal n=16 correlated gaussian W=102400 "
                      "D=32", corr32, q_corr, 16, 0.1, True, counted=16,
                      proposal=True, plain_reps=2)
    b8_errs = [line["max_abs_err"] for line in n_errs] + [
        b_prop["max_abs_err"],
        check_b8("B proposal (fixed count) funnel W=8192 D=10 L=16",
                 pot.make_funnel(10, device=dev).device_form,
                 0.5 * randn2(8192, 10), 16, 0.1, False,
                 proposal=True)["max_abs_err"],
        check_b8("B counted+proposal diag form W=8192 D=32 n=9 max=16",
                 ("diag", (torch.ones(32, device=dev),
                           torch.zeros(32, device=dev))),
                 randn2(8192, 32), 9, 0.3, False, counted=16,
                 proposal=True)["max_abs_err"]]

    # kernel A with the count on the device: the fixed count's bits
    q_a = randn2(102400, 32)
    one = torch.ones(32, device=dev)
    kw_a = dict(scalars=scalars(0.3), p_std=one, inv_mass=one, k_diag=one,
                mean=torch.zeros(32, device=dev))
    for n, ran in ((1, 1), (7, 7), (16, 16), (40, 16)):
        a_dev = kernels.fused_hmc_diag_quadratic(
            SEED, 7, q_a, num_steps=count(n), max_steps=16, **kw_a)
        a_fix = kernels.fused_hmc_diag_quadratic(SEED, 7, q_a, num_steps=ran,
                                                 **kw_a)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a_dev, a_fix)):
            fail(f"kernel A: the device count {n} (max 16) does not give "
                 f"the fixed count {ran}'s bits")
    count16 = count(16)  # made outside the timing's graph capture
    a_plain = kernels.fused_hmc_diag_quadratic_plain(
        SEED, 7, q_a, num_steps=count(40), max_steps=16, **kw_a)
    a_counted = {
        "case": "A counted n=16 max=16 std_normal W=102400 D=32",
        "max_abs_err": compare(
            "A counted", named(a_dev, A_ORDER), named(a_plain, A_ORDER),
            torch.log(philox.accept_uniforms(SEED, 7, 102400, dev))),
        **bound(transition_bytes(102400, 32, False),
                102400 * 32 * (4 * 16 + 10)),
        "ms": median_ms(lambda: kernels.fused_hmc_diag_quadratic(
            SEED, 7, q_a, num_steps=count16, max_steps=16, **kw_a)),
        "plain_ms": median_ms(
            lambda: kernels.fused_hmc_diag_quadratic_plain(
                SEED, 7, q_a, num_steps=16, **kw_a)),
        "fixed_ms": median_ms(lambda: kernels.fused_hmc_diag_quadratic(
            SEED, 7, q_a, num_steps=16, **kw_a))}
    print(json.dumps(a_counted))

    # the model forms, on the posterior states phase 8 left, under the
    # metric and (for the logistic form) the step size it adapted
    form_lr = mp_lr.potential.device_form
    x_dev, y_dev = form_lr[1]

    def logistic_library(q, steps):
        """What one PyTorch call per product makes of the logistic form's
        gradients over a transition: two torch.matmul and a sigmoid for
        each of its steps + 1 gradients (the trajectory, the energies and
        the Metropolis test left out)."""
        for _ in range(steps + 1):
            resid = torch.sigmoid(q[:, :-1] @ x_dev.T + q[:, -1:]) - y_dev
            grad = torch.cat([q[:, :-1] + resid @ x_dev,
                              q[:, -1:] + resid.sum(1, keepdim=True)], 1)
        return grad

    q_lr, mass_lr = res8a.state.ensemble.q, res8a.state.ensemble.mass
    step_lr = res8a.step_size.item()

    def tile_lr(w_, d_):
        return f"(tile {kernels.logistic_tile(w_, 256, d_)})"

    lr_main = check_b8(f"B logistic W=102400 D=32 N=256 L=16 "
                       f"{tile_lr(102400, 32)}", form_lr, q_lr,
                       16, step_lr, True, plain_reps=2,
                       library=logistic_library, mass=mass_lr, bits=True)
    lr_errs = [lr_main["max_abs_err"]]
    lr_errs.append(check_b8(
        f"B logistic W=8192 D=32 N=256 L=16 {tile_lr(8192, 32)}", form_lr,
        q_lr[:8192].contiguous(), 16, step_lr, True, plain_reps=2,
        library=logistic_library, mass=mass_lr, bits=True)["max_abs_err"])
    lr_errs.append(check_b8(
        f"B logistic counted+proposal W=8192 D=31 N=256 n=9 max=16 (off the "
        f"16-byte path) {tile_lr(8192, 31)}",
        ("logistic", (x_dev[:, 1:].contiguous(), y_dev)),
        q_lr[:8192, 1:].contiguous(), 9, step_lr, False, counted=16,
        proposal=True, mass=mass_lr[1:], bits=True)["max_abs_err"])
    lr_errs.append(check_b8(
        f"B logistic counted+proposal W=102400 D=32 N=256 n=40 max=16 "
        f"{tile_lr(102400, 32)}", form_lr, q_lr, 40, step_lr, False,
        counted=16, proposal=True, plain_reps=2, mass=mass_lr,
        bits=True)["max_abs_err"])
    # kernel D with the logistic form at the same shape and state (its
    # launches: phase 8e)
    d_lr = check_d(f"D logistic W=102400 D=32 N=256 L=16 "
                   f"{tile_lr(102400, 32)}", form_lr, 102400, 32, 16,
                   step_lr, (1.0 / mass_lr).contiguous(), q=q_lr,
                   p=randn2(102400, 32), library=logistic_library, bits=True)
    # A float32 trajectory through tau = e^q1 amplifies the last-bit
    # differences between the kernel and its plain version: at the adapted
    # step, after 16 steps, one walker in 102400 (a near-divergent one,
    # energy error 29) passed the flat tolerance (1.3e-4 relative). So the
    # comparison runs 16 steps of half the adapted step; the time is the
    # same.
    form_es = mp_es.potential.device_form
    mass_es = res8b.state.ensemble.mass
    step_es = 0.5 * res8b.step_size.item()
    es_main = check_b8("B eight_schools_nc W=102400 D=10 L=16", form_es,
                       res8b.state.ensemble.q, 16, step_es, True,
                       mass=mass_es)
    es_errs = [es_main["max_abs_err"], check_b8(
        "B eight_schools_nc counted+proposal W=8192 D=10 n=40 max=16",
        form_es, res8b.state.ensemble.q[:8192].contiguous(), 40, step_es,
        False, counted=16, proposal=True, mass=mass_es)["max_abs_err"]]

    def entry(name, source, replaces, launches, errs, main):
        return {"name": name, "case": main["case"], "route": "cuda",
                "source": source,
                "replaces": f"{TPU_KERNELS}:{replaces}",
                "launches": launches, "max_abs_err": max(errs),
                **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}}

    print(json.dumps({"kernels": [
        entry("fused_hmc_diag_quadratic", SOURCE, 893, launched_a, a_errs,
              a_main),
        entry("fused_hmc_transition", SOURCE, 373, launched_b, b_errs,
              b_main),
        entry("fused_hmc_transition", SOURCE, 576, launched_c, c_errs,
              c_main),
        entry("leapfrog_trajectory", f"{CSRC}/leapfrog.cu", 140, launched_d,
              d_errs, d_main),
        # B and D once more, at the correlated Gaussian of phase 7
        entry("fused_hmc_transition", SOURCE, 373, corr_launches["7a"],
              b_errs, b_corr),
        entry("leapfrog_trajectory", f"{CSRC}/leapfrog.cu", 140,
              corr_launches["7b"], d_errs, d_corr),
        entry("nbody_accelerations_tiled", f"{CSRC}/nbody.cu", 252,
              launched_e, e_errs, e_main),
        # this slice: the count read on the device (A: phase 8d's sampling;
        # B: the sampling launches of 8a and 8b), the proposal outputs
        # (their warmup launches), and the two model forms
        entry("fused_hmc_diag_quadratic", SOURCE, 901, launched_a_counted,
              [a_counted["max_abs_err"]], a_counted),
        entry("fused_hmc_transition", SOURCE, 379,
              by_lr["counted"] + by_es["counted"], b8_errs, b_counted),
        entry("fused_hmc_transition", SOURCE, 380,
              by_lr["counted+proposal"] + by_es["counted+proposal"], b8_errs,
              b_prop),
        entry("fused_hmc_transition", f"{CSRC}/forms.cuh", 576, launched_lr,
              lr_errs, lr_main),
        entry("fused_hmc_transition", f"{CSRC}/forms.cuh", 576, launched_es,
              es_errs, es_main),
        # the logistic form in kernel D (phase 8e)
        entry("leapfrog_trajectory", f"{CSRC}/forms.cuh", 140,
              launched_d_lr, [d_lr["max_abs_err"]], d_lr),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
