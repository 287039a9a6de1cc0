#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a GPU machine

1. Prints the card (nvidia-smi name and power limit) and builds the CUDA
   kernels from the sources in this checkout with nvcc.
2. Holds every fused kernel against its plain-torch version on the card, on
   the same inputs and the same Philox draws, at the main path's shapes,
   and times both (CUDA-graph replays timed with CUDA events).
3. Runs the main path, ``run_hmc(kernel="auto")`` on the bench
   configuration (32-dim standard normal, 102400 walkers, 16 leapfrog
   steps), and checks its moments, acceptance and kernel launch count.
4. Runs the verify drive (correlated 2-D Gaussian, 8192 walkers) and the
   same at 10 dims through the generic kernel and checks their moments.
   The generic kernel stands for both TPU generic variants: the D | 128
   shapes (here D = 2) ran the walker-packed one there, the others (here
   D = 10) the unpacked one.
2, continued. Holds kernel D (the leapfrog trajectory) at the bench shape
   and kernel E (the N-body accelerations) at four shapes against their
   plain versions, kernel E to a bound argued from summation order
   (``E_BOUND_C``), and times them.
5. Runs ``run_hmc(integrator="pallas_leapfrog")`` on the bench
   configuration: the composed engine with kernel D's trajectory, one
   launch per transition; checks moments, acceptance and the count.
6. Runs the physics path at full size: a 16384-body Plummer sphere
   (``examples/make_examples.py``) through ``physics.simulate`` (velocity
   Verlet, kernel E twice per step), checks the launch count, the energy
   drift and 20 steps against the plain accelerations; then the adaptive
   Hermite and RK45 drivers on ``examples/nbody/pl1k.txt`` in float64.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failure raises, and the
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

import torch

ROOT = Path(__file__).resolve().parent
CSRC = "physicsbasedbayesianinference_tpu_torch/csrc"
SOURCE = f"{CSRC}/fused_hmc.cu"
TPU_KERNELS = "physicsbasedbayesianinference_tpu/ops/pallas_kernels.py"
SEED = 20261016
# kernel E against its plain version: per body and component
# |a_kernel - a_plain| <= E_BOUND_C * u * sqrt(N) * S_i, with u the dtype's
# unit roundoff and S_i the sum of the magnitudes of a_i's terms: two
# summation orders of N terms differ by about u sqrt(N) S_i (a random walk
# of roundings), and the factor covers the largest of 3N components and
# the per-term rounding of the square root and the division.
E_BOUND_C = 4.0


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
    from physicsbasedbayesianinference_tpu_torch import physics, run_hmc
    from physicsbasedbayesianinference_tpu_torch.ops import _build, kernels
    from physicsbasedbayesianinference_tpu_torch.ops import philox
    from physicsbasedbayesianinference_tpu_torch.ops import potentials as pot

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
    def check_a(case, w, d, steps, step, random_metric, time_it):
        q = randn(w, d)
        if random_metric:
            k, mu, im = uniform(0.5, 2, d), randn(d), uniform(0.5, 2, d)
        else:
            k, mu = torch.ones(d, device=dev), torch.zeros(d, device=dev)
            im = torch.ones(d, device=dev)
        kw = dict(scalars=scalars(step), p_std=torch.sqrt(1.0 / im),
                  inv_mass=im, k_diag=k, mean=mu, num_steps=steps)
        counter = 7
        out_k = named(kernels.fused_hmc_diag_quadratic(SEED, counter, q, **kw),
                      A_ORDER)
        out_p = named(kernels.fused_hmc_diag_quadratic_plain(
            SEED, counter, q, **kw), A_ORDER)
        log_u = torch.log(philox.accept_uniforms(SEED, counter, w, dev))
        err = compare(case, out_k, out_p, log_u)
        line = {"case": case, "max_abs_err": err}
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
        line = {"case": case, "max_abs_err": err}
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
    a_errs = [a_main["max_abs_err"],
              check_a("A random metric W=1000 D=5 L=16", 1000, 5, 16, 0.2,
                      True, False)["max_abs_err"]]
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

    def check_d(case, form, w, d, steps, step, inv_mass):
        q, p = randn2(w, d), randn2(w, d)
        kw = dict(step_size=torch.tensor([step], device=dev),
                  num_steps=steps, inv_mass=inv_mass)
        out_k = kernels.leapfrog_trajectory(form, q, p, **kw)
        out_p = kernels.leapfrog_trajectory_plain(form, q, p, **kw)
        torch.cuda.synchronize()
        worst = 0.0
        for key, k, pl in zip(("q", "p", "u", "g"), out_k, out_p):
            if not torch.allclose(k, pl, rtol=1e-5, atol=1e-5):
                fail(f"{case}: {key}' differs by up to "
                     f"{(k - pl).abs().max().item()}")
            worst = max(worst, (k - pl).abs().max().item())
        line = {"case": case, "max_abs_err": worst,
                "ms": median_ms(lambda: kernels.leapfrog_trajectory(
                    form, q, p, **kw)),
                "plain_ms": median_ms(
                    lambda: kernels.leapfrog_trajectory_plain(
                        form, q, p, **kw))}
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
    d_errs = [d_main["max_abs_err"], check_d(
        "D correlated gaussian W=102400 D=32 L=16", corr32, 102400, 32, 16,
        0.1, (0.5 + 1.5 * torch.rand(32, generator=gen2)).to(dev))[
            "max_abs_err"]]
    # kernel B at the same shape and form, for D's time beside B's
    b_errs.append(check_b("B correlated gaussian W=102400 D=32 L=16",
                          corr32, randn2(102400, 32), 16, 0.1,
                          True)["max_abs_err"])

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
        a_p = kernels.nbody_accelerations_tiled_plain(x, m, **kw)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(a_k).all()):
            fail(f"{case}: non-finite accelerations")
        u = torch.finfo(x.dtype).eps / 2
        scale = u * n**0.5 * kernels.nbody_abs_sum(x, m, **kw)[:, None]
        ratio = ((a_k - a_p).abs().double() / scale).max().item()
        if not ratio <= E_BOUND_C:
            fail(f"{case}: |a_kernel - a_plain| reaches {ratio:.3g} "
                 f"u sqrt(N) S_i, over the bound {E_BOUND_C}")
        line = {"case": case, "max_abs_err": (a_k - a_p).abs().max().item(),
                "bound_c": E_BOUND_C, "worst_ratio": ratio}
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
    pl1k32, _, _ = load(nbody_dir / "pl1k.txt", torch.float32)
    at_origin = pl1k32.x.clone()
    at_origin[0] = 0.0
    e_errs = [e_main["max_abs_err"]]
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

    print(json.dumps({"kernels": [
        {"name": "fused_hmc_diag_quadratic", "route": "cuda",
         "source": SOURCE, "replaces": f"{TPU_KERNELS}:893",
         "launches": launched_a,
         "max_abs_err": max(a_errs), "ms": a_main["ms"],
         "plain_ms": a_main["plain_ms"]},
        {"name": "fused_hmc_transition", "route": "cuda",
         "source": SOURCE, "replaces": f"{TPU_KERNELS}:373",
         "launches": launched_b, "max_abs_err": max(b_errs),
         "ms": b_main["ms"], "plain_ms": b_main["plain_ms"]},
        {"name": "fused_hmc_transition", "route": "cuda",
         "source": SOURCE, "replaces": f"{TPU_KERNELS}:576",
         "launches": launched_c, "max_abs_err": max(c_errs),
         "ms": c_main["ms"], "plain_ms": c_main["plain_ms"]},
        {"name": "leapfrog_trajectory", "route": "cuda",
         "source": f"{CSRC}/leapfrog.cu", "replaces": f"{TPU_KERNELS}:140",
         "launches": launched_d, "max_abs_err": max(d_errs),
         "ms": d_main["ms"], "plain_ms": d_main["plain_ms"]},
        {"name": "nbody_accelerations_tiled", "route": "cuda",
         "source": f"{CSRC}/nbody.cu", "replaces": f"{TPU_KERNELS}:252",
         "launches": launched_e, "max_abs_err": max(e_errs),
         "ms": e_main["ms"], "plain_ms": e_main["plain_ms"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
