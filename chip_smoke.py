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
   dim-groups) and with a threshold that rejects every walker. Kernel B's
   funnel (D = 10), N-body (8 bodies, D = 24) and mixture (K = 2, D = 2)
   forms run one walker a thread, and the lane-group layout forced on the
   same input must give their bits (the funnel's and N-body's timed beside
   them); the mixture's q', u', g' must also be the plain version's
   bits.
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
   8192, D = 32). Kernel D with the mixture (W = 8192, D = 2), one walker
   a thread: the plain version's bits and the lane groups'. Kernels B and
   D with the diagonal forms at W = 102400, timed: the funnel model under
   ``reparam="auto"`` (form 12, D = 16, phase 14c's) and form 5 (D = 32),
   every output the plain version's bits (B's where the decisions agree),
   as kernel D's standard normal at the bench shape.
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
   walkers); 8c the funnel model decentred by a site dict
   (``reparam={"x": True}``), which has no device form, through the
   composed engine (no kernel launch); 8d the
   32-dim standard normal, whose sampling runs kernel A with the count
   read on the device; 8e the model of 8a through
   ``run_hmc(integrator="pallas_leapfrog")`` from 8a's posterior state:
   kernel D with the logistic form, one launch a transition, moments held
   to 8a's; 8f the model of 8b the same way (20 + 20 transitions from
   8b's posterior, 40 launches of kernel D's eight-schools form, finite
   moments; run after the checks of 2 below). Every launch of kernels B
   and D in phases 8, 9, 12c, 14 and 15a must be in the walker layout that
   ``kernels.walker_layout`` names (one walker a thread for the
   eight-schools forms at D = 10, the funnel model at D = 16 and the
   N-body form at D = 24, the lane groups for the others).
2, once more. Holds kernel B with the device step count (1, 7, max_steps
   and a count above it, which must clip) and with the proposal outputs,
   kernel A with the device step count, and the two model forms (the
   logistic form at W = 8192 and 102400 and at a D off the 16-byte path,
   each at the walker tile ``kernels.logistic_tile`` picks, the
   eight-schools form at W = 102400) against their plain versions, on
   the posterior states phase 8 left, each with a second launch that must
   give the same bits; kernel D with the logistic and the eight-schools
   forms at W = 102400 too. The eight-schools form runs one walker a
   thread in both kernels, and the lane-group layout forced on the same
   input must give its bits (timed beside it).
   The logistic form's q', u', g' (and proposal, and kernel D's q', p',
   u', g') must be the plain version's bits, as both sum in the same order
   and round each multiply-add once. Kernel B's logistic form is also
   held and timed at W = 101376, where its blocks make 3 whole waves of
   the card (102400 make 3.03: the last wave's cost). Times them, and for
   the logistic form the two ``torch.matmul`` calls and the sigmoid that
   its gradients amount to.
2, at the tempered shapes. Holds kernel A (W = 102400, D = 32) and kernel
   B's N-body form (W = 102400, D = 24, one walker a thread, the lane
   groups forced giving its bits) with a potential scale of 0.37 in
   their device scalars, and B's mixture form (W = 16384, D = 2, one
   walker a thread: the plain version's bits and the lane groups') at
   beta = 0.21 with momenta thermal at it, against their plain versions;
   times them; and kernel B at phase 4's 10-dim Gaussian drive.
9. Runs tempered SMC, ``run_smc(kernel="auto")``, at 102400 walkers, each
   mutation one launch with the stage beta as the kernel's potential scale
   and the stage loop's condition the one host read a stage: 9a the 32-dim
   standard normal from N(0, I / 0.1) in kernel A, held to the closed-form
   log-evidence (16 ln 0.1) and moments; 9b BASELINE config 4 (8 unit-mass
   bodies, softening 0.3, D = 24) in kernel B's N-body form, every launch
   one walker a thread. A second run of each with the same seed must give
   the same bits, and two more stages under the profiler must make no
   blocking call. 9c runs ``run_hmc(integrator="pallas_leapfrog")`` on
   9b's target from 9b's particles (40 launches of kernel D's N-body
   form, one walker a thread), then holds that form in kernel D at W =
   102400 against its plain version (every output its bits) and the lane
   groups forced, timed.
10. Runs parallel tempering, ``run_parallel_tempering``, on the bimodal
   mixture with modes at (+-6, 0), 6 replicas down to beta = 0.02, 16384
   walkers a replica all started in the left mode: one launch of kernel
   B's mixture form a transition for all six replicas (the kernels' rung
   axis), each at its beta, every launch one walker a thread; checks the
   cold replica's share of the right mode, the acceptance and swap rates,
   and that the run's blocking calls do not grow with its transitions.
   Then holds that rung launch, on the run's final ladder and state,
   against six launches of one rung each, the lane-group layout forced
   and the plain version (every output their bits), timed beside the six
   launches. 10b and 10c run the same sampler
   through kernel A's rungs (the 2-D standard normal) and kernel B's
   rungs one walker a thread (8b's eight schools from its posterior), 50
   + 50 transitions of 6 rungs, one launch each, and hold their rung
   launches the same way.
11. Runs lockstep NUTS, ``run_nuts``, on the sampler-matrix target (the
   16-dim Gaussian with sd logspace(0, 1, 16)) at 65536 walkers: no fused
   kernel; checks moments, acceptance and mean depth, and prints the host
   reads a transition.
12. Drives the command-line driver (``python -m
   physicsbasedbayesianinference_tpu_torch.main`` and ``main.run``): 12a
   the bench configuration as a process of its own (456 launches of kernel
   A, phase 3's gates, the ``.npz``), then in this process with every
   sample kept (the summary over [256, 102400, 32]); 12b checkpointed hmc
   at the same width, resumed half way, bitwise the uninterrupted run and
   ``run_hmc``, two chunks profiled without a blocking call, the bytes and
   milliseconds of a save; 12c chees on logistic regression and non-centred
   eight schools as processes (456 launches of kernel B each, moments held
   to phase 8's composed runs) and a checkpointed chees resume; 12d
   checkpointed SMC resumed from a stage copied into a fresh directory
   (the same log-evidence bits, 3 launches of kernel A a stage); 12e
   checkpointed parallel tempering (kernel B's mixture form, one walker a
   thread) and NUTS,
   resumed, bitwise; 12f stream mode into a sample file; 12g
   ``run_hmc(metric="dense")`` on phase 7's Gaussian (composed, no kernel):
   moments and the adapted covariance.
13. Drives the sharded paths (``parallel/``). 13a holds what a K-rank run
   needs of the kernels: kernel A at the bench shape and kernel B's
   Gaussian form at phase 7's, each launched on the two halves of the
   walkers at their global offsets, joined bitwise to the whole launch
   (and the plain version's halves to the plain whole, the kernel to the
   plain version within phase 2's tolerance); kernel E with the bodies as
   their own sources (bitwise the one-set launch) and over two blocks of
   8192 sources (within ``kernels.nbody_bound``); times the new variants.
   13b ``sharded_run_hmc`` in a one-rank NCCL group at the bench
   configuration (456 launches of A, phase 3's gates, the fixed-step run's
   q bitwise ``run_hmc``'s, NCCL collectives a warmup and a sampling
   transition, no blocking call) and on phase 7's Gaussian (456 of B);
   13c ``run_smc(mesh=)`` on phase 9a's target (its gates, the same bits
   from a second run, collectives and host reads a stage); 13d the CLI with
   ``sharded=true`` through ``torch.distributed.run`` (phase 3's gates);
   13e ``ring_simulate`` on phase 6's Plummer sphere (one launch of kernel
   E's source-block form a step and one more, the energy drift, the final
   positions against ``physics.simulate``). With two or more cards 13b and
   13d also run with two processes; on one card the phase says it ran one.
   With ``--sharded-rank PATH STEP`` the script is one rank of that
   two-process 13b run and needs the launcher's environment.
14. Drives this slice's path. 14a kernel A with ``trajectory_dtype=
   torch.bfloat16``: held against its plain version at W = 102400, D = 32
   (and at D = 33; q' and g' the plain version's bits), timed beside the
   float32 launch, then the TPU kernel's statistics test, 100 transitions
   at W = 16384, step 0.6, with its four gates. 14c ChEES through the
   command-line driver's entry (``main.run``) on every example model phase
   8 did not run, at W = 102400, 200 + 256 transitions: linear regression
   (N = 256, P = 30, numpy seeds 10, 11, 12), the centred eight schools,
   the centred eight schools under ``--reparam auto``, the coin toss
   (``examples/coin_toss.data.json``), the funnel and the funnel under
   ``--reparam auto``, each with both phases in kernel B (456 launches);
   moments against closed forms (the coins, the decentred funnel) or a
   composed run (linear regression; the decentred eight schools against
   phase 8b's), the two centred models gated on finite moments and their
   divergence share. 14d kernel D on each new form through
   ``run_hmc(integrator="pallas_leapfrog")`` from 14c's posterior. 14b
   each new form in kernels B and D against its plain version on those
   states, timed (the linear and coin forms bitwise; the centred eight
   schools, the non-centred form it takes under ``auto`` and the funnel
   model, which run one walker a thread, also against the lane-group
   layout forced, bitwise).
15. Drives every sampler over the one-rank NCCL group of phase 13: 15a
   ``run_chees_hmc(mesh=)`` on 8a's logistic regression (456 launches of
   kernel B, 8a's bits), 15b ``run_parallel_tempering`` on a 1 x 1
   replica mesh at phase 10's configuration (600 launches of B, one walker
   a thread, phase 10's bits), 15c ``run_nuts(mesh=)`` at phase 11's (its
   bits and host
   reads), 15d the dense metric sharded at 12g's configuration (12g's
   gates: its step folds the rank into its seed), 15e ``main.run`` with
   ``sharded=True``: SMC against 12d's log Z bit for bit, a checkpointed
   chees run stopped after its first chunk and resumed against the
   uninterrupted run and 12c's, stream mode against 12f's rows. Each
   prints its ms a transition beside the unsharded phase's, its
   collectives and host copies a transition and its launches. 15w times a
   warmup transition of ``sharded_run_hmc`` against ``run_hmc`` at the
   bench configuration and prints the profiler's host operators that the
   sharded one adds. With two or more cards 15a and 15e's SMC also run
   with two processes (``--sharded-rank-15 PATH``).

Each phase prints its wall seconds on a line of its own
(``phase_wall_seconds``) when the next one starts. The line before the
last is a JSON object with one entry per kernel, with its time beside its
bound (``bound_ms``: the larger of the bytes it must move over
``HBM_BYTES_PER_S`` and its operations over the card's rate for their
type, from this run's shapes; for kernels A and B the whole transition,
the momentum and Metropolis draws and both energies with the trajectory,
``a_ops`` and ``b_ops``); the last line is ``{"ok": true, "device":
{...}}``. Any failure raises, and the script exits non-zero; without a
CUDA device it exits non-zero at once. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
# Phase 12g's limit on the dense metric's adapted covariance, relative
# Frobenius error at W = 102400: four standard errors from the CPU runs of
# tools/dense_metric_gate.py at W = 8192 (rms 0.01244 over 4 seeds, scaled
# by sqrt(8192 / 102400))
DENSE_COV_GATE = 0.0141
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
            "cudaMemcpyAsync")
CLI = "physicsbasedbayesianinference_tpu_torch.main"
aten = torch.ops.aten


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


# Instructions of the SASS sequence each transcendental function and IEEE
# division takes with the library's flags (the path that finite, normal
# operands take; a MUFU instruction once), read with cuobjdump -sass on an
# NVIDIA H100 80GB HBM3 at 700.00 W (tools/kernel_sweeps.py --only sass):
# gradient_ops counts each at this length, not as one instruction.
SASS_EXPF = 10
SASS_LOGF = 26
SASS_LOG1PF = 28
SASS_DIV = 10
SASS_RCP = 10
SASS_SQRTF = 10


def gradient_ops(form, d: int) -> float:
    """Instructions per walker of one gradient of a device form, a
    multiply-add counted once and each exponential, division, reciprocal
    and root at the length of its SASS sequence (``SASS_*``)."""
    name, params = form
    if name == "gaussian":
        return d * d + d           # the D x D matvec and q - mu
    if name in ("diag", "diag_model"):
        return 2 * d
    if name in ("funnel", "funnel_model"):
        # sum x_j^2 (D - 1), e^-v (a negation and the exponential), e^-v
        # x_j (D - 1), g_0: 2 v, its division by 2 s^2 and four more
        return 2 * d + 4 + SASS_EXPF + SASS_DIV
    if name == "banana":
        return 12
    if name == "mixture":
        # a component: q - mu and the sum of squares (2 D), its term log w
        # - (iv / 2) s (one multiply-add), the max, t - m and the
        # exponential, the sum s, num's multiply-adds on the same
        # differences (D); a dim: iv num and its division by s
        k = params[0].shape[0]
        return k * (3 * d + 4 + SASS_EXPF) + d * (1 + SASS_DIV)
    if name == "logistic":
        # z = x w + b and x^T r: N D multiply-adds each; a row's sigmoid
        # (its negation, exponential, 1 + e and reciprocal) and residual
        # and their bookkeeping, about 6 besides the two functions
        n = params[1].shape[0]
        return 2 * n * d + n * (6 + SASS_EXPF + SASS_RCP)
    if name == "eight_schools_nc":
        # a school: mu + tau theta, y minus it, the two products by
        # 1 / sigma, the two sums and theta - tau e (7); the walker's
        # exponential, the mu term (1) and the log-tau term's division and
        # six more
        return 7 * params[0].shape[0] + 7 + SASS_EXPF + SASS_DIV
    if name == "linear":
        # z = x w + b and x^T r: N D multiply-adds each; the residual, its
        # square and its scaled copy about 4 a row; the walker's e^-2s and
        # e^2s
        n = params[1].shape[0]
        return 2 * n * d + 4 * n + 2 * SASS_EXPF
    if name == "eight_schools":
        # a school: theta - mu and y - theta, their products by e^-q1 and
        # 1 / sigma, the two sums and z e^-q1 - o / sigma (8); the walker's
        # two exponentials and a negation, the mu term's 2 and the log-tau
        # term's division and seven more (10)
        return 8 * params[0].shape[0] + 10 + 2 * SASS_EXPF + SASS_DIV
    if name == "coin":
        # a dim: e^-|x| (the exponential), 1 + e, the numerator's
        # multiply-add and its select (3), and the division
        return d * (3 + SASS_EXPF + SASS_DIV)
    # nbody, each pair once (thread_layout.cu): S differences and S
    # multiply-adds of d2, + eps^2, the root and the reciprocal, inv^3 (2),
    # the two masses' products (2) and 2 S multiply-adds into the two
    # bodies' sums; then -m_i (G acc) a dim (2)
    n = params[0].shape[0]
    s = d // n
    return n * (n - 1) // 2 * (3 * s + 5 + SASS_SQRTF + SASS_RCP) + 2 * d


# The SASS lengths of what every fused transition draws, beside SASS_LOGF,
# SASS_SQRTF and SASS_EXPF (tools/kernel_sweeps.py --only sass, NVIDIA H100
# 80GB HBM3 at 700.00 W): a Philox4x32-10 block with its key and three
# counter words known at run time only; sincosf on the path that arguments
# in (0, 2 pi] take; the Metropolis draw, a Philox block, the uniform of
# its first word and its logf, as the compiler joins them (76, where the
# three apart count 59 + 4 + 26). A Box-Muller pair probed whole is the 80
# that draw_ops counts for it.
SASS_PHILOX = 59
SASS_SINCOSF = 32
SASS_ACCEPT = 76
# a uniform in (0, 1] from a word: a shift, a conversion, a multiply, an add
UNIFORM_OPS = 4


def draw_ops(d: int) -> float:
    """Instructions per walker of what every fused transition draws and
    decides, counted once a walker whatever the layout repeats: the
    momentum, ceil(D / 4) Philox blocks of two Box-Muller pairs each (a
    pair: two uniforms, -2 log u1 and its root, 2 pi u2 and its sine and
    cosine, the two products) and p = sd n a dim; the Metropolis draw
    (``SASS_ACCEPT``); and the test, beta (H1 - H0), the finite and
    divergence tests, the comparison and exp(min(0, -dH)) (6 and the
    exponential)."""
    pair = 2 * UNIFORM_OPS + SASS_LOGF + SASS_SQRTF + SASS_SINCOSF + 4
    return (-(-d // 4) * (SASS_PHILOX + 2 * pair) + d
            + SASS_ACCEPT + 6 + SASS_EXPF)


def a_ops(w: int, d: int, steps: int) -> float:
    """Kernel A's instructions over W walkers: per dim 4 a leapfrog step
    (drift, q - mu, times k, kick) and some 10 for the two energies and
    the half kicks, and the draws (``draw_ops``)."""
    return w * (d * (4 * steps + 10) + draw_ops(d))


def b_ops(w: int, d: int, steps: int, form) -> float:
    """Kernel B's instructions over W walkers: steps + 1 evaluations of the
    form and 3 D more a step (drift and kick), both energies' kinetic
    terms (p^2 / m a dim: a multiply and a multiply-add, twice) and the
    scaling of their sums (4), and the draws (``draw_ops``)."""
    return w * ((steps + 1) * (gradient_ops(form, d) + 3 * d) + 4 * d + 4
                + draw_ops(d))


class PhaseClock:
    """Each phase's wall seconds, printed as a JSON line of its own when
    the next phase starts, and for the last when ``start(None)`` ends it."""

    def __init__(self):
        self.name, self.t0 = None, time.perf_counter()

    def start(self, name) -> None:
        now = time.perf_counter()
        if self.name is not None:
            print(json.dumps({"phase_wall_seconds": self.name,
                              "seconds": now - self.t0}), flush=True)
        self.name, self.t0 = name, now


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def median_ms(fn, reps: int = 20, rounds: int = 7, warm: int = 3) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in a CUDA graph,
    so the host's Python overhead between launches is not timed; each
    replay timed with CUDA events; the median over ``rounds`` replays,
    after ``warm`` calls outside the graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
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


def same_bits(a, b) -> bool:
    """Bit for bit, NaNs included (``torch.equal`` holds a NaN unequal to
    itself): float32 tensors are compared as their int32 words."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def close_where_finite(k, p, rtol=1e-5, atol=1e-5) -> bool:
    """``k`` and ``p`` are finite at the same entries and close there: a
    trajectory that overflowed leaves non-finite values on both sides (inf
    on one, NaN on the other, as the operations met them)."""
    fin = torch.isfinite(k)
    return (torch.equal(fin, torch.isfinite(p))
            and torch.allclose(k[fin], p[fin], rtol=rtol, atol=atol))


def finite_err(k, p) -> float:
    """The largest |k - p| where both are finite (0 where none is)."""
    fin = torch.isfinite(k) & torch.isfinite(p)
    return (k[fin] - p[fin]).abs().max().item() if bool(fin.any()) else 0.0


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
        nuts, physics, run_chees_hmc, run_hmc, run_nuts,
        run_parallel_tempering, run_smc, smc)
    from physicsbasedbayesianinference_tpu_torch.ops import _build, kernels
    from physicsbasedbayesianinference_tpu_torch.ops import philox
    from physicsbasedbayesianinference_tpu_torch.ops import potentials as pot
    from physicsbasedbayesianinference_tpu_torch.utils import convert

    clock = PhaseClock()
    # ---- 1. device and build ----------------------------------------------
    clock.start('1. device and build')
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
    clock.start('1, continued: constructors default to the card')
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
             "mass": np.ones(2), "time": np.zeros(())}).x,
        # an entry point given numpy positions runs them on the card
        "run_hmc(numpy init_q)": run_hmc(
            0, pot.make_standard_normal(4), np.zeros((64, 4), np.float32),
            num_warmup=1, num_samples=1, num_steps=2,
            collect="none").state.ensemble.q}
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
    clock.start('2. kernels against their plain versions')
    def check_a(case, w, d, steps, step, random_metric, time_it,
                threshold=1000.0, beta=1.0, scale=1.0, trajectory_dtype=None,
                q=None):
        """Kernel A against its plain version; ``beta``, ``scale``: the
        device scalars' (momenta thermal at beta, std sqrt(m / beta));
        ``trajectory_dtype``: the drift/kick chain's (then q' and g' of
        every walker whose decision agrees must be the plain version's
        bits, and the line holds the float32 launch's time on the same
        input beside it); ``q``: the positions (random unless given)."""
        if q is None:
            q = randn(w, d)
        if random_metric:
            k, mu, im = uniform(0.5, 2, d), randn(d), uniform(0.5, 2, d)
        else:
            k, mu = torch.ones(d, device=dev), torch.zeros(d, device=dev)
            im = torch.ones(d, device=dev)
        kw = dict(scalars=scalars(step, beta, scale),
                  p_std=torch.sqrt(1.0 / (im * beta)),
                  inv_mass=im, k_diag=k, mean=mu, num_steps=steps,
                  divergence_threshold=threshold)
        if trajectory_dtype is not None:
            kw["trajectory_dtype"] = trajectory_dtype
        counter = 7
        out_k = named(kernels.fused_hmc_diag_quadratic(SEED, counter, q, **kw),
                      A_ORDER)
        out_p = named(kernels.fused_hmc_diag_quadratic_plain(
            SEED, counter, q, **kw), A_ORDER)
        log_u = torch.log(philox.accept_uniforms(SEED, counter, w, dev))
        err = compare(case, out_k, out_p, log_u)
        if trajectory_dtype is not None:
            agree = out_k["accepted"] == out_p["accepted"]
            for key in ("q", "g"):
                if not torch.equal(out_k[key][agree], out_p[key][agree]):
                    fail(f"{case}: {key}' is not the plain version's bits")
        if threshold < 0 and not (
                not bool(out_k["accepted"].any())
                and torch.equal(out_k["q"], q)
                and torch.equal(out_k["g"], k * (q - mu))):
            fail(f"{case}: a rejected walker's q' is not q bit for bit, or "
                 f"its g' not k (q - mu)")
        line = {"case": case, "max_abs_err": err,
                **bound(transition_bytes(w, d, False), a_ops(w, d, steps))}
        if time_it:
            line["ms"] = median_ms(lambda: kernels.fused_hmc_diag_quadratic(
                SEED, counter, q, **kw))
            line["plain_ms"] = median_ms(
                lambda: kernels.fused_hmc_diag_quadratic_plain(
                    SEED, counter, q, **kw))
            if trajectory_dtype is not None:
                f32 = {k: v for k, v in kw.items() if k != "trajectory_dtype"}
                line["float32_ms"] = median_ms(
                    lambda: kernels.fused_hmc_diag_quadratic(
                        SEED, counter, q, **f32))
                line["same_bits_as_plain"] = True
        print(json.dumps(line))
        return line

    def check_b(case, form, q, steps, step, time_it, beta=1.0, scale=1.0,
                plain_reps=20, layouts=False, bits=False, group_ms=True):
        """Kernel B against its plain version, as ``check_a``;
        ``layouts``: the lane-group layout forced must give the chosen
        thread layout's bits, and with ``group_ms`` is timed beside it;
        ``bits``: q', u', g' of every walker whose decision agrees must be
        the plain version's bits."""
        w, d = q.shape
        vg = kernels.device_value_and_grad(form)
        u, g = vg(q)
        im = uniform(0.5, 2, d)
        kw = dict(scalars=scalars(step, beta, scale),
                  p_std=torch.sqrt(1.0 / (im * beta)), inv_mass=im,
                  num_steps=steps)
        counter = 11
        out_k = named(kernels.fused_hmc_transition(
            form, SEED, counter, q, u, g, **kw), B_ORDER)
        out_p = named(kernels.fused_hmc_transition_plain(
            form, SEED, counter, q, u, g, **kw), B_ORDER)
        log_u = torch.log(philox.accept_uniforms(SEED, counter, w, dev))
        err = compare(case, out_k, out_p, log_u)
        if bits:
            agree = out_k["accepted"] == out_p["accepted"]
            differ = [k for k in ("q", "u", "g")
                      if not same_bits(out_k[k][agree], out_p[k][agree])]
            if differ:
                fail(f"{case}: {differ} are not the plain version's bits")
        layout = kernels.form_layout(form, d, "B")
        if layouts:
            forced = kernels.fused_hmc_transition(
                form, SEED, counter, q, u, g, _layout="group", **kw)
            torch.cuda.synchronize()
            if layout != "thread" or not all(
                    same_bits(out_k[k], v)
                    for k, v in named(forced, B_ORDER).items()):
                fail(f"{case}: the lane-group layout does not give the "
                     f"thread layout's bits")
        line = {"case": case, "max_abs_err": err, "layout": layout,
                **({"same_bits_as_group_layout": True} if layouts else {}),
                **({"same_bits_as_plain": True} if bits else {}),
                **bound(transition_bytes(w, d, True),
                        b_ops(w, d, steps, form))}
        if time_it:
            line["ms"] = median_ms(lambda: kernels.fused_hmc_transition(
                form, SEED, counter, q, u, g, **kw))
            if layouts and group_ms:
                line["group_layout_ms"] = median_ms(
                    lambda: kernels.fused_hmc_transition(
                        form, SEED, counter, q, u, g, _layout="group", **kw))
            line["plain_ms"] = median_ms(
                lambda: kernels.fused_hmc_transition_plain(
                    form, SEED, counter, q, u, g, **kw), reps=plain_reps,
                rounds=7 if plain_reps == 20 else 3)
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
    c_mix = check_b(
        "B mixture W=8192 D=2 K=2 L=16",
        pot.make_gaussian_mixture(torch.tensor([[-3.0, 0.0], [3.0, 0.0]]),
                                  device=dev).device_form,
        3.0 * randn(8192, 2), 16, 0.3, True, layouts=True, bits=True,
        group_ms=False)
    c_errs.append(c_mix["max_abs_err"])
    # ... and the others: the funnel and N-body forms one walker a thread,
    # the lane-group layout forced beside them
    b_main = check_b("B funnel W=8192 D=10 L=16",
                     pot.make_funnel(10, device=dev).device_form,
                     0.5 * randn(8192, 10), 16, 0.1, True, layouts=True)
    b_errs = [b_main["max_abs_err"]]
    b_nbody8k = check_b(
        "B nbody W=8192 N=8 D=24 L=16",
        pot.make_nbody_potential(uniform(0.5, 1.5, 8), 8, softening=0.5,
                                 device=dev).device_form,
        2.0 * randn(8192, 24), 16, 0.05, True, layouts=True)
    b_errs.append(b_nbody8k["max_abs_err"])

    # ---- 3. main path at full width ----------------------------------------
    clock.start('3. main path at full width')
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
    clock.start('4. verify drive: correlated 2-D Gaussian')
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
    clock.start('2, continued: kernels D and E against their plain versions')
    # (after phases 3 and 4, with a generator of their own, so that the
    # earlier phases draw what they drew before these checks existed)

    # kernel D, the leapfrog trajectory, at the bench shape
    gen2 = torch.Generator(device="cpu").manual_seed(SEED + 5)

    def randn2(*shape):
        return torch.randn(*shape, generator=gen2).to(dev)

    def check_d(case, form, w, d, steps, step, inv_mass, time_it=True, *,
                q=None, p=None, library=None, bits=False, plain_timing=None,
                check_steps=None, layouts=False, group_ms=True):
        """Kernel D against its plain version on ``q``, ``p`` (random
        unless given), and a second launch's bits; ``bits``: every output
        must be the plain version's bits; ``plain_timing``: median_ms's
        arguments for the plain version (for the slow ones);
        ``check_steps``: the comparison runs this many steps, the timing
        ``steps``; ``layouts``: the lane-group layout forced must give the
        chosen thread layout's bits, and with ``group_ms`` is timed beside
        it."""
        if q is None:
            q, p = randn2(w, d), randn2(w, d)
        kw = dict(step_size=torch.tensor([step], device=dev),
                  num_steps=steps, inv_mass=inv_mass)
        checked = kw if check_steps is None else {**kw,
                                                  "num_steps": check_steps}
        out_k = kernels.leapfrog_trajectory(form, q, p, **checked)
        out_p = kernels.leapfrog_trajectory_plain(form, q, p, **checked)
        again = kernels.leapfrog_trajectory(form, q, p, **checked)
        forced = (kernels.leapfrog_trajectory(form, q, p, _layout="group",
                                              **checked) if layouts
                  else again)
        torch.cuda.synchronize()
        if layouts and kernels.form_layout(form, d, "D") != "thread":
            fail(f"{case}: not a thread-layout shape")
        worst = 0.0
        for key, k, pl, k2, k3 in zip(("q", "p", "u", "g"), out_k, out_p,
                                      again, forced):
            if not close_where_finite(k, pl):
                fail(f"{case}: {key}' differs by up to "
                     f"{(k - pl).abs().max().item()}")
            if not (same_bits(k, k2) and same_bits(k, k3)):
                fail(f"{case}: {key}' of a second launch, or of the "
                     f"lane-group layout, is not the first's bits")
            if bits and not torch.equal(k, pl):
                fail(f"{case}: {key}' is not the plain version's bits "
                     f"({(k != pl).sum().item()} differ)")
            worst = max(worst, finite_err(k, pl))
        # q, p in; q', p', g' and u' out
        line = {"case": case, "max_abs_err": worst,
                "layout": kernels.form_layout(form, d, "D"),
                **({"same_bits_as_group_layout": True} if layouts else {}),
                **bound(4 * w * (5 * d + 1),
                        w * (steps + 1) * (gradient_ops(form, d) + 3 * d))}
        if time_it:
            line["ms"] = median_ms(lambda: kernels.leapfrog_trajectory(
                form, q, p, **kw))
            if layouts and group_ms:
                line["group_layout_ms"] = median_ms(
                    lambda: kernels.leapfrog_trajectory(form, q, p,
                                                        _layout="group", **kw))
            if plain_timing is None:
                plain_timing = {} if library is None else dict(reps=2,
                                                               rounds=3)
            line["plain_ms"] = median_ms(
                lambda: kernels.leapfrog_trajectory_plain(form, q, p, **kw),
                **plain_timing)
            if library is not None:
                line["library_ms"] = median_ms(lambda: library(q, steps))
        if bits:
            line["same_bits_as_plain"] = True
        print(json.dumps(line))
        return line

    d_main = check_d("D std_normal (diag form) W=102400 D=32 L=16",
                     ("diag", (torch.ones(32, device=dev),
                               torch.zeros(32, device=dev))),
                     102400, 32, 16, 0.3, torch.ones(32, device=dev),
                     bits=True)
    a32 = torch.randn(32, 32, generator=gen2) / 32**0.5
    corr32 = pot.make_gaussian(torch.randn(32, generator=gen2),
                               cov=a32 @ a32.T + 0.5 * torch.eye(32),
                               device=dev).device_form
    d_corr = check_d(
        "D correlated gaussian W=102400 D=32 L=16", corr32, 102400, 32, 16,
        0.1, (0.5 + 1.5 * torch.rand(32, generator=gen2)).to(dev))
    # kernel D with phase 2's mixture, one walker a thread: the plain
    # version's bits and the lane groups' (its own generators, so that the
    # later checks draw what they drew before it)
    d_mix = check_d(
        "D mixture W=8192 D=2 K=2 L=16",
        pot.make_gaussian_mixture(torch.tensor([[-3.0, 0.0], [3.0, 0.0]]),
                                  device=dev).device_form, 8192, 2, 16, 0.3,
        torch.ones(2, device=dev),
        q=3.0 * torch.randn(8192, 2, generator=seeded(21), device=dev),
        p=torch.randn(8192, 2, generator=seeded(22), device=dev),
        bits=True, layouts=True, group_ms=False)
    d_errs = [d_main["max_abs_err"], d_corr["max_abs_err"]]
    # the diagonal forms in kernels B and D at W = 102400: phase 14c's
    # funnel model under reparam="auto" (form 12, D = 16) and form 5 at D =
    # 32 with a random k and mean, every output the plain version's bits
    # (B's where the decisions agree); their inputs from generators of
    # their own and gen's state kept, so that later checks draw what they
    # drew before these rows
    kept = gen.get_state()
    funnel_auto = models.make_model_potential(
        models.funnel, (), {}, reparam="auto",
        device=dev).potential.device_form
    diag32 = ("diag", ((0.5 + 1.5 * torch.rand(
        32, generator=seeded(24), device=dev)), torch.randn(
            32, generator=seeded(25), device=dev)))
    diag_rows = {}
    for key, form, d_ in (("diag_model", funnel_auto, 16),
                          ("diag", diag32, 32)):
        q_ = torch.randn(102400, d_, generator=seeded(26), device=dev)
        diag_rows["B " + key] = check_b(
            f"B {key} W=102400 D={d_} L=16", form, q_, 16, 0.2, True,
            bits=True, plain_reps=2)
        diag_rows["D " + key] = check_d(
            f"D {key} W=102400 D={d_} L=16", form, 102400, d_, 16, 0.2,
            (0.5 + 1.5 * torch.rand(d_, generator=seeded(27),
                                    device=dev)),
            q=q_, p=torch.randn(102400, d_, generator=seeded(28),
                                device=dev), bits=True)
    gen.set_state(kept)
    d_errs += [diag_rows[k]["max_abs_err"] for k in ("D diag_model",
                                                      "D diag")]
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
    clock.start('5. run_hmc(integrator="pallas_leapfrog") on the bench config')
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
    clock.start('6. physics at full size: 16384-body Plummer sphere')
    n_body, dt, n_steps = plummer.num_bodies, 5e-4, 2000
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    traj = physics.simulate(plummer, dt, n_steps, method="velocity_verlet",
                            save_every=100, softening=0.05)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    steps_per_s_6 = n_steps / seconds
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
    clock.start('7. the correlated Gaussian at full width')
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
    corr_launches, corr_steps, corr_ms = {}, {}, {}
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
        corr_steps[sub] = res7.step_size.item()
        corr_ms[sub] = 1e3 * res7.sampling_seconds / n_samp
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
    clock.start('8. ChEES-HMC on models of the DSL')
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
        by_layout = dict(kernels.fused_hmc_transition.launches_by_layout)
        layout = kernels.form_layout(mp.potential.device_form, d8, "B")
        if by_layout[layout] != n_warm8 + n_samp8:
            fail(f"phase {sub} launched kernel B in the layouts {by_layout}, "
                 f"want {layout} only")
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
            "launches_by_layout": by_layout,
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
        return res, counts["fused_hmc_transition"], by, ref

    mp_lr = models.make_model_potential(models.logistic_regression,
                                        (x_lr, y_lr), {})
    res8a, launched_lr, by_lr, ref8a = chees_on_model(
        "8a", "logistic regression N=256", mp_lr, 0.05)
    mp_es = models.make_model_potential(models.eight_schools_noncentered,
                                        (), models.EIGHT_SCHOOLS_DATA)
    res8b, launched_es, by_es, ref8b = chees_on_model(
        "8b", "eight schools non-centred", mp_es, 0.22)

    # 8c: a DSL model without a device form takes the composed route. The
    # funnel decentred by a site dict (reparam={"x": True}, the rewrite
    # "auto" makes, but no config the form registry knows) is v ~ N(0, 3),
    # x_decentered ~ N(0, 1)^15.
    mp_fn = models.make_model_potential(models.funnel, (), {"dim": 15},
                                        reparam={"x": True})
    if mp_fn.potential.device_form is not None or mp_fn.num_dims != 16:
        fail("phase 8c: the funnel decentred by a site dict has a device "
             "form")
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
        "phase": "8c run_chees_hmc funnel model reparam={x: True} W=8192 "
                 "D=16 (no device form: the composed route)",
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
    layout8e = dict(kernels.leapfrog_trajectory.launches_by_layout)
    sd_8a = torch.sqrt(res8a.var)
    mean_err = ((res8e.mean - res8a.mean) / sd_8a).abs().max().item()
    var_err = (res8e.var / res8a.var - 1.0).abs().max().item()
    accept = res8e.accept_rate.item()
    if not (res8e.kernel_used == "composed"
            and launched_d_lr == n_warm8e + n_samp8e
            and layout8e[kernels.form_layout(mp_lr.potential.device_form,
                                             32, "D")] == launched_d_lr
            and sum(counts8e.values()) == launched_d_lr
            and mean_err < 0.044 and var_err < 0.0625
            and 0.6 <= accept <= 0.99):
        fail(f"phase 8e off: ran {res8e.kernel_used} with {counts8e} "
             f"({layout8e}), mean "
             f"{mean_err} sd from 8a (limit 0.044), var {var_err} (limit "
             f"0.0625), accept {accept}")
    print(json.dumps({
        "phase": f"8e run_hmc logistic regression N=256 W={w} D=32 L={steps} "
                 f"integrator=pallas_leapfrog from 8a's posterior",
        "kernel_used": res8e.kernel_used, "launches": launched_d_lr,
        "launches_by_layout": layout8e, "max_mean_err_sd_vs_8a": mean_err,
        "max_rel_var_err_vs_8a": var_err,
        "accept_rate": accept, "step_size": res8e.step_size.item(),
        "ms_per_transition": 1e3 * res8e.sampling_seconds / n_samp8e,
        "walker_transitions_per_s": w * n_samp8e / res8e.sampling_seconds}))

    # ---- 2, once more: the count on the device, the proposal, the forms ---
    clock.start('2, once more: the count on the device, the proposal, the forms')
    gen8 = torch.Generator(device="cpu").manual_seed(SEED + 8)

    def count(n):
        return torch.tensor([n], dtype=torch.int32, device=dev)

    def check_b8(case, form, q, steps, step, time_it, *, counted=None,
                 proposal=False, plain_reps=20, library=None, mass=None,
                 bits=False, plain_timing=None, check_steps=None,
                 layouts=False):
        """Kernel B against its plain version; ``counted``: the count goes
        as a device tensor with this max_steps (and the fixed-count
        kernel's first six outputs must be the same bits); ``mass``: the
        metric [D] (a random one unless given); ``bits``: q', u', g' of
        every walker whose decision agrees, and the proposal, must be the
        plain version's bits; ``plain_timing``: median_ms's arguments for
        the plain version (``plain_reps`` replays of 3 rounds unless
        given); ``check_steps``: the comparison runs this many steps, the
        timing ``steps``; ``layouts``: the lane-group layout forced must
        give the chosen thread layout's bits, and is timed beside it."""
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
        checked = kw if check_steps is None else {**kw,
                                                  "num_steps": check_steps}

        def run(**over):
            return kernels.fused_hmc_transition(form, SEED, counter, q, u, g,
                                                **{**kw, **over})

        def run_plain():
            return kernels.fused_hmc_transition_plain(form, SEED, counter, q,
                                                      u, g, **checked)

        out, again, plain = run(**checked), run(**checked), run_plain()
        torch.cuda.synchronize()
        if not all(same_bits(a, b) for a, b in zip(out, again)):
            fail(f"{case}: two launches on the same input differ")
        if layouts:
            forced = run(**{**checked, "_layout": "group"})
            torch.cuda.synchronize()
            if kernels.form_layout(form, d_, "B") != "thread" or not all(
                    same_bits(a, b) for a, b in zip(out, forced)):
                fail(f"{case}: the lane-group layout does not give the "
                     f"thread layout's bits")
        if counted is not None:
            fixed = kernels.fused_hmc_transition(
                form, SEED, counter, q, u, g, **{
                    **kw, "num_steps": ran, "max_steps": None,
                    "emit_proposal": False})
            if not all(same_bits(a, b) for a, b in zip(out, fixed)):
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
                if not close_where_finite(k, pl):
                    fail(f"{case}: {key} differs by up to "
                         f"{(k - pl).abs().max().item()}")
                err = max(err, finite_err(k, pl))
        line = {"case": case, "max_abs_err": err,
                "accepted": out[4].float().mean().item(),
                "layout": kernels.form_layout(form, d_, "B"),
                **({"same_bits_as_plain": True} if bits else {}),
                **({"same_bits_as_group_layout": True} if layouts else {}),
                **bound(transition_bytes(w_, d_, True)
                        + (8 * w_ * d_ if proposal else 0),
                        b_ops(w_, d_, ran, form))}
        if time_it:
            line["ms"] = median_ms(run)
            if layouts:
                line["group_layout_ms"] = median_ms(
                    lambda: run(_layout="group"))
            # the plain version reads a tensor count on the host, which a
            # graph capture cannot hold: it is timed at the int it holds
            plain_kw = {**kw, "num_steps": ran, "max_steps": None}
            line["plain_ms"] = median_ms(
                lambda: kernels.fused_hmc_transition_plain(
                    form, SEED, counter, q, u, g, **plain_kw),
                **(plain_timing or dict(reps=plain_reps, rounds=3)))
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
                 proposal=True, layouts=True)["max_abs_err"],
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
        **bound(transition_bytes(102400, 32, False), a_ops(102400, 32, 16)),
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

    # the data forms' plain versions take some 3 s a transition at W=102400:
    # one replay of one call times them
    slow = dict(reps=1, rounds=1, warm=1)
    lr_main = check_b8(f"B logistic W=102400 D=32 N=256 L=16 "
                       f"{tile_lr(102400, 32)}", form_lr, q_lr,
                       16, step_lr, True, plain_timing=slow,
                       library=logistic_library, mass=mass_lr, bits=True)
    lr_errs = [lr_main["max_abs_err"]]
    # the last wave: at W = 101376 the lane groups' 792 blocks make 3
    # whole waves of 264, at 102400 their 800 make 3.03
    lr_tail = check_b8(
        f"B logistic W=101376 D=32 N=256 L=16 {tile_lr(101376, 32)}",
        form_lr, q_lr[:101376].contiguous(), 16, step_lr, True,
        plain_timing=slow, library=logistic_library, mass=mass_lr, bits=True)
    lr_errs.append(lr_tail["max_abs_err"])
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
                   p=randn2(102400, 32), library=logistic_library, bits=True,
                   plain_timing=slow)
    # A float32 trajectory through tau = e^q1 amplifies the last-bit
    # differences between the kernel and its plain version: at the adapted
    # step, after 16 steps, one walker in 102400 (a near-divergent one,
    # energy error 29) passed the flat tolerance (1.3e-4 relative). So the
    # comparison runs 16 steps of half the adapted step; the time is the
    # same.
    form_es = mp_es.potential.device_form
    mass_es = res8b.state.ensemble.mass
    step_es = 0.5 * res8b.step_size.item()
    # Both run one walker a thread (kernels.walker_layout), whose bits the
    # lane-group layout forced must give.
    q_es = res8b.state.ensemble.q
    es_main = check_b8("B eight_schools_nc W=102400 D=10 L=16", form_es,
                       q_es, 16, step_es, True, mass=mass_es, layouts=True)
    es_errs = [es_main["max_abs_err"], check_b8(
        "B eight_schools_nc counted+proposal W=8192 D=10 n=40 max=16",
        form_es, q_es[:8192].contiguous(), 40, step_es, False, counted=16,
        proposal=True, mass=mass_es, layouts=True)["max_abs_err"]]
    # kernel D with the same form, state and step, the momenta drawn under
    # the metric (its launches: 8f)
    d_es = check_d("D eight_schools_nc W=102400 D=10 L=16", form_es,
                   q_es.shape[0], 10, 16, step_es,
                   (1.0 / mass_es).contiguous(), q=q_es,
                   p=torch.randn(q_es.shape, generator=seeded(80),
                                 device=dev) * mass_es.sqrt(),
                   layouts=True)

    # 8f: kernel D with the eight-schools form, as a user reaches it:
    # run_hmc with integrator="pallas_leapfrog" on the model of 8b from 8b's
    # posterior state, 20 + 20 transitions at half 8b's step; every launch
    # one walker a thread, finite moments
    kernels.reset_launch_counts()
    res8f = run_hmc(SEED + 13, mp_es.potential, q_es.clone(), num_warmup=20,
                    num_samples=20, num_steps=steps, init_step_size=step_es,
                    collect="moments", integrator="pallas_leapfrog")
    counts8f = kernels.launch_counts()
    launched_d_es = counts8f["leapfrog_trajectory"]
    layout8f = dict(kernels.leapfrog_trajectory.launches_by_layout)
    if not (res8f.kernel_used == "composed" and launched_d_es == 40
            and sum(counts8f.values()) == 40 and layout8f["thread"] == 40
            and bool(torch.isfinite(res8f.mean).all())):
        fail(f"phase 8f off: ran {res8f.kernel_used} with {counts8f} "
             f"({layout8f}), mean {res8f.mean}")
    print(json.dumps({
        "phase": f"8f run_hmc eight schools non-centred W={w} D=10 "
                 f"L={steps} integrator=pallas_leapfrog 20 + 20 from 8b's "
                 f"posterior",
        "kernel_used": res8f.kernel_used, "launches": launched_d_es,
        "launches_by_layout": layout8f,
        "accept_rate": res8f.accept_rate.item(),
        "ms_per_transition": 1e3 * res8f.sampling_seconds / 20}))

    # ---- 2, at the tempered shapes: a potential scale and a beta ----------
    clock.start('2, at the tempered shapes: a potential scale and a beta')
    # the shapes phases 9 and 10 give kernels A and B, with SMC's stage beta
    # as the potential scale (9a, 9b) and a tempering rung's beta with its
    # thermal momenta (10); drawn after every earlier phase's draws
    a_scaled = check_a("A std_normal W=102400 D=32 L=10 beta=1 scale=0.37",
                       102400, 32, 10, 0.8, False, True, scale=0.37)
    nbody8 = pot.make_nbody_potential(torch.ones(8), 8, softening=0.3,
                                      device=dev)
    b_nbody = check_b(
        "B nbody N=8 eps=0.3 W=102400 D=24 L=8 beta=1 scale=0.37",
        nbody8.device_form, 2.0 * randn(102400, 24), 8, 0.3, True,
        scale=0.37, plain_reps=2, layouts=True)
    bimodal = pot.make_gaussian_mixture(
        torch.tensor([[-6.0, 0.0], [6.0, 0.0]]), device=dev)
    b_mixture = check_b(
        "B mixture K=2 W=16384 D=2 L=10 beta=0.21 scale=1",
        bimodal.device_form, 6.0 * randn(16384, 2), 10, 0.5, True,
        beta=0.21, layouts=True, bits=True, group_ms=False)
    # kernel B at the target and shape of phase 4's 10-dim drive, whose
    # launches the funnel's row above does not make
    b_gauss10 = check_b(
        "B correlated gaussian W=8192 D=10 L=16 (phase 4's drive)",
        pot.make_gaussian(mean10, cov=cov10, device=dev).device_form,
        mean10.to(dev) + randn(8192, 10), 16, 0.1, True)
    b_errs.append(b_gauss10["max_abs_err"])

    # ---- 9. tempered SMC, mutating in kernels A and B -----------------------
    clock.start('9. tempered SMC, mutating in kernels A and B')
    def smc_phase(sub, title, target, q0, wanted, **kw):
        """run_smc(kernel="auto") with every mutation one launch of
        ``wanted`` at the stage beta as the kernel's potential scale, one
        host read a stage (and one for the last check), none in a stage."""
        kernels.reset_launch_counts()
        reads = smc._host_read.reads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_smc(SEED + 13, target, q0, kernel="auto", **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = kernels.launch_counts()
        by_layout = dict(kernels.fused_hmc_transition.launches_by_layout)
        reads = smc._host_read.reads - reads
        n = res.num_stages
        k_mut = kw["num_mutation_steps"]
        if not (res.kernel_used == "fused"
                and counts[wanted] == k_mut * n
                and sum(counts.values()) == counts[wanted]
                and reads == n + 1):
            fail(f"phase {sub} ran {res.kernel_used}: {counts} launches in "
                 f"{n} stages, {reads} host reads (want {k_mut} x {n} "
                 f"launches of {wanted} and {n + 1} reads)")
        # the same seed gives the same bits (the resamplers' CDF is
        # integer: no sum whose order depends on the card's timing)
        again = run_smc(SEED + 13, target, q0, kernel="auto", **kw)
        if not (torch.equal(again.q, res.q)
                and torch.equal(again.log_evidence, res.log_evidence)):
            fail(f"phase {sub}: a second run with the same seed differs "
                 f"(log Z {again.log_evidence.item()} and "
                 f"{res.log_evidence.item()})")
        # a stage's own program reads nothing back: profile two more
        m = smc.build_smc_machinery(
            target, q0.shape[0], q0.dtype, num_dims=q0.shape[1],
            device=dev, **{k: v for k, v in kw.items()
                           if k != "max_stages"})
        carry = m["body"](m["init_carry"](SEED, q0))
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                carry = m["body"](carry)
            torch.cuda.synchronize()
        calls = {e.key: e.count for e in prof.key_averages()}
        blocking = {k: calls.get(k, 0) for k in (
            "cudaStreamSynchronize", "cudaMemcpy", "cudaMemcpyAsync")}
        if any(blocking.values()):
            fail(f"phase {sub}: two SMC stages made blocking calls "
                 f"{blocking}")
        accepts = res.accept_history[:n]
        line = {
            "phase": f"{sub} run_smc {title} kernel=auto",
            "kernel_used": res.kernel_used, "launches": counts[wanted],
            "num_stages": n, "final_beta": res.betas[n].item(),
            "log_evidence": res.log_evidence.item(),
            "mean_stage_accept": accepts.mean().item(),
            "min_stage_accept": accepts.min().item(),
            "final_step_size": res.final_step_size.item(),
            "launches_by_layout": by_layout,
            "host_reads": reads, "seconds": seconds,
            "ms_per_stage": 1e3 * seconds / n,
            "walker_mutations_per_s": q0.shape[0] * k_mut * n / seconds}
        return res, line, counts[wanted]

    # 9a: the 32-dim standard normal from N(0, I / beta0); log Z = 16 ln 0.1
    beta0 = 0.1
    q9 = torch.randn(w, d, generator=seeded(9), device=dev) / beta0**0.5
    res9a, line9a, launched_9a = smc_phase(
        "9a", "std_normal_32d W=102400 beta0=0.1 K=3 L=10",
        pot.make_standard_normal(d), q9, "fused_hmc_diag_quadratic",
        num_mutation_steps=3, num_leapfrog_steps=10, init_step_size=0.8,
        beta0=beta0, max_stages=40)
    z_err = abs(res9a.log_evidence.item() - 0.5 * d * np.log(beta0))
    mean_err = res9a.q.mean(0).abs().max().item()
    var_err = (res9a.q.var(0) - 1.0).abs().max().item()
    line9a.update(log_evidence_err=z_err, max_abs_mean=mean_err,
                  max_abs_var_minus_1=var_err)
    print(json.dumps(line9a))
    if not (res9a.num_stages < 40 and res9a.betas[res9a.num_stages] == 1.0
            and z_err < 0.25 and mean_err < 0.05 and var_err < 0.1):
        fail(f"phase 9a off: {res9a.num_stages} stages to beta "
             f"{res9a.betas[res9a.num_stages].item()}, log Z error {z_err} "
             f"(limit 0.25), max|mean| {mean_err} (0.05), max|var-1| "
             f"{var_err} (0.1)")

    # 9b: BASELINE config 4, 8 unit-mass bodies with softening 0.3
    q9b = 2.0 * torch.randn(w, 24, generator=seeded(10), device=dev)
    res9b, line9b, launched_9b = smc_phase(
        "9b", "nbody N=8 eps=0.3 D=24 W=102400 beta0=0.05 K=3 L=8", nbody8,
        q9b, "fused_hmc_transition", num_mutation_steps=3,
        num_leapfrog_steps=8, init_step_size=0.3, beta0=0.05, max_stages=30)
    print(json.dumps(line9b))
    if not (np.isfinite(line9b["log_evidence"])
            and line9b["mean_stage_accept"] > 0.5
            and line9b["launches_by_layout"]["thread"] == launched_9b):
        fail(f"phase 9b off: log Z {line9b['log_evidence']}, mean stage "
             f"accept {line9b['mean_stage_accept']} (limit 0.5), launches "
             f"by layout {line9b['launches_by_layout']} (want all "
             f"{launched_9b} one walker a thread)")

    # 9c: kernel D with the N-body form, as a user reaches it: run_hmc with
    # integrator="pallas_leapfrog" on 9b's target from 9b's particles, 20 +
    # 20 transitions of L=8; every launch one walker a thread, finite
    # moments. Then the form in kernel D against its plain version (every
    # output its bits) and against the lane-group layout forced, timed.
    kernels.reset_launch_counts()
    res9c = run_hmc(SEED + 18, nbody8, res9b.q.contiguous(), num_warmup=20,
                    num_samples=20, num_steps=8,
                    init_step_size=res9b.final_step_size.item(),
                    collect="moments", integrator="pallas_leapfrog")
    counts9c = kernels.launch_counts()
    launched_9c = counts9c["leapfrog_trajectory"]
    layout9c = dict(kernels.leapfrog_trajectory.launches_by_layout)
    if not (res9c.kernel_used == "composed" and launched_9c == 40
            and sum(counts9c.values()) == 40 and layout9c["thread"] == 40
            and bool(torch.isfinite(res9c.mean).all())):
        fail(f"phase 9c off: ran {res9c.kernel_used} with {counts9c} "
             f"({layout9c}), mean {res9c.mean}")
    print(json.dumps({
        "phase": f"9c run_hmc nbody N=8 eps=0.3 D=24 W={w} L=8 "
                 f"integrator=pallas_leapfrog 20 + 20 from 9b's particles",
        "kernel_used": res9c.kernel_used, "launches": launched_9c,
        "launches_by_layout": layout9c,
        "accept_rate": res9c.accept_rate.item(),
        "ms_per_transition": 1e3 * res9c.sampling_seconds / 20}))
    d_nbody = check_d("D nbody N=8 eps=0.3 W=102400 D=24 L=16",
                      nbody8.device_form, w, 24, 16,
                      0.5 * res9b.final_step_size.item(),
                      torch.ones(24, device=dev), q=res9b.q.contiguous(),
                      p=torch.randn(w, 24, generator=seeded(90), device=dev),
                      bits=True, layouts=True,
                      plain_timing=dict(reps=2, rounds=3))

    # ---- 10. parallel tempering on the bimodal mixture ----------------------
    clock.start('10. parallel tempering on the bimodal mixture')
    # modes at (+-6, 0), sigma 1; every walker starts in the left one
    r10, w10, n_warm10, n_samp10 = 6, 16384, 200, 400
    q10 = torch.tensor([-6.0, 0.0], device=dev) + 0.3 * torch.randn(
        w10, 2, generator=seeded(11), device=dev)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res10 = run_parallel_tempering(
        SEED + 14, bimodal, q10, num_replicas=r10, beta_min=0.02,
        num_warmup=n_warm10, num_samples=n_samp10, num_steps=10,
        collect="samples")
    torch.cuda.synchronize()
    seconds10 = time.perf_counter() - t0
    counts10 = kernels.launch_counts()
    launched_10 = counts10["fused_hmc_transition"]
    layout10 = dict(kernels.fused_hmc_transition.launches_by_layout)
    right = (res10.samples[:, :, 0] > 0).float().mean().item()
    min_acc = res10.accept_rate.min().item()
    max_swap = res10.swap_rate.max().item()

    def pt_blocking(num_warmup, num_samples):
        """The run's blocking calls under the profiler; with moments, since
        collect="samples" copies the cold replica on the device once a
        transition, which the profiler counts as a cudaMemcpyAsync too."""
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            run_parallel_tempering(SEED, bimodal, q10, num_replicas=r10,
                                   beta_min=0.02, num_warmup=num_warmup,
                                   num_samples=num_samples, num_steps=10,
                                   collect="moments")
        calls = {e.key: e.count for e in prof.key_averages()}
        return {k: calls.get(k, 0) for k in (
            "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
            "cudaMemcpyAsync")}

    # the blocking calls of a run (its set-up, the synchronisations around
    # sampling) do not grow with the transitions: no read in either loop
    blocking_short, blocking_long = pt_blocking(5, 5), pt_blocking(20, 30)
    print(json.dumps({
        "phase": f"10 run_parallel_tempering bimodal mixture (+-6, 0) "
                 f"R={r10} beta_min=0.02 W={w10} L=10 warmup={n_warm10} "
                 f"samples={n_samp10} kernel=auto",
        "kernel_used": res10.kernel_used, "launches": launched_10,
        "launches_by_layout": layout10, "right_mode_share": right,
        "accept_rate": res10.accept_rate.tolist(),
        "swap_rate": res10.swap_rate.tolist(),
        "step_sizes": res10.step_sizes.tolist(),
        "betas": res10.betas.tolist(),
        "blocking_calls_10_vs_50_transitions": [blocking_short,
                                                blocking_long],
        "seconds": seconds10,
        "ms_per_transition": 1e3 * seconds10 / (n_warm10 + n_samp10),
        "sampling_ms_per_transition":
            1e3 * res10.sampling_seconds / n_samp10}))
    # the r10 rungs in one launch a transition
    if not (res10.kernel_used == "fused"
            and launched_10 == n_warm10 + n_samp10
            and layout10["thread"] == launched_10
            and sum(counts10.values()) == launched_10
            and 0.35 <= right <= 0.65 and min_acc > 0.5 and max_swap > 0.05
            and blocking_short == blocking_long):
        fail(f"phase 10 off: ran {res10.kernel_used} with {launched_10} "
             f"launches (want {n_warm10 + n_samp10}, by layout {layout10}: "
             f"want every one one walker a thread), right-mode "
             f"share {right} (limits 0.35-0.65), min accept {min_acc}, max "
             f"swap rate {max_swap}, blocking calls {blocking_short} and "
             f"{blocking_long}")

    # ---- 2, at the rung axis: a ladder's rungs in one launch ------------
    clock.start("2, at the rung axis: a ladder's rungs in one launch")
    def check_rungs(case, form, q, steps, step_sizes, betas, seeds, u=None,
                    g=None, plain_bits=True, layouts=False):
        """A launch of kernel A (``form`` None: the standard normal) or B
        on the R rungs of ``q`` [R, W, D] at a ladder's step sizes and betas
        (mass 1, momenta thermal at each beta): every output the bits of R
        launches of one rung each and, with ``plain_bits``, of the plain
        version (without: within ``compare``'s limits of it, as a launch of
        one rung of that form is); timed beside those R launches
        (``before_ms``), as the sweep ran before the rung axis. ``layouts``:
        kernel B in the lane-group layout forced gives the chosen thread
        layout's bits."""
        r, w, d = q.shape
        counter = 600
        kw = dict(scalars=torch.stack((step_sizes, betas,
                                       torch.ones_like(betas)), 1),
                  p_std=torch.sqrt(1.0 / betas)[:, None].expand(
                      r, d).contiguous(),
                  inv_mass=torch.ones(d, device=dev), num_steps=steps)
        if form is None:
            kw.update(k_diag=torch.ones(d, device=dev),
                      mean=torch.zeros(d, device=dev))
            kernel, plain = (kernels.fused_hmc_diag_quadratic,
                             kernels.fused_hmc_diag_quadratic_plain)
            order = A_ORDER
        else:
            kernel, plain = (kernels.fused_hmc_transition,
                             kernels.fused_hmc_transition_plain)
            order = B_ORDER

        def call(fn, i=None, **extra):
            """``fn`` on every rung, or on rung ``i`` alone"""
            pick = (lambda x: x) if i is None else (lambda x: x[i])
            args = {k: pick(v) if k in ("scalars", "p_std") else v
                    for k, v in kw.items()}
            keys = seeds if i is None else seeds[i]
            if form is None:
                return fn(keys, counter, pick(q), **args, **extra)
            return fn(form, keys, counter, pick(q), pick(u), pick(g), **args,
                      **extra)

        before = kernel.launches
        out = call(kernel)
        if kernel.launches != before + 1:
            fail(f"{case}: {kernel.launches - before} launches, want 1")
        each = kernels._stack_rungs(call(kernel, i) for i in range(r))
        want = call(plain)
        group = call(kernel, _layout="group") if layouts else None
        torch.cuda.synchronize()
        held = ((each, "its rungs' own launches"),
                (want, "the plain version"))
        if layouts:
            if kernels.form_layout(form, d, "B") != "thread":
                fail(f"{case}: not a thread-layout shape")
            held += ((group, "the lane-group layout"),)
        for other, label in held if plain_bits else held[:1] + held[2:]:
            differ = [k for k, a, b in zip(order, out, other)
                      if not same_bits(a, b)]
            if differ:
                fail(f"{case}: {differ} are not the bits of {label}")
        err = max(compare(
            f"{case} rung {i}", named([x[i] for x in out], order),
            named([x[i] for x in want], order),
            torch.log(philox.accept_uniforms(seeds[i], counter, w, dev)))
            for i in range(r))
        ops = (a_ops(w, d, steps) if form is None
               else b_ops(w, d, steps, form))
        line = {"case": case, "max_abs_err": err,
                "same_bits_as_plain": plain_bits,
                "same_bits_as_rung_launches": True,
                **({"same_bits_as_group_layout": True} if layouts else {}),
                **bound(r * transition_bytes(w, d, form is not None),
                        r * ops),
                "ms": median_ms(lambda: call(kernel)),
                "before_ms": median_ms(
                    lambda: [call(kernel, i) for i in range(r)]),
                "plain_ms": median_ms(lambda: call(plain), reps=2,
                                      rounds=3)}
        if form is not None:
            line["layout"] = kernels.form_layout(form, d, "B")
        print(json.dumps(line))
        return line

    from physicsbasedbayesianinference_tpu_torch.tempering import (
        _replica_seed)
    b_rungs = check_rungs(
        f"B mixture K=2 R={r10} W={w10} D=2 L=10, phase 10's ladder and "
        f"state", bimodal.device_form, res10.q, 10, res10.step_sizes,
        res10.betas, [_replica_seed(SEED + 14, i) for i in range(r10)],
        res10.u, res10.g, layouts=True)

    # 10b, 10c: parallel tempering through kernel A's rungs (the 2-D
    # standard normal) and kernel B's one walker a thread (8b's eight
    # schools from 8b's posterior), 50 + 50 transitions, one launch each
    def pt_route(sub, title, target, q0, wanted, layout, init_step,
                 min_accept):
        kernels.reset_launch_counts()
        res = run_parallel_tempering(
            SEED + 16, target, q0, num_replicas=r10, beta_min=0.1,
            num_warmup=50, num_samples=50, num_steps=10,
            init_step_size=init_step, collect="moments")
        counts = kernels.launch_counts()
        by_layout = dict(kernels.fused_hmc_transition.launches_by_layout)
        ok = (res.kernel_used == "fused" and counts[wanted] == 100
              and sum(counts.values()) == 100
              and (layout is None or by_layout[layout] == 100)
              and bool(torch.isfinite(res.mean).all())
              and res.accept_rate.min().item() > min_accept)
        print(json.dumps({
            "phase": f"{sub} run_parallel_tempering {title} R={r10} "
                     f"W={q0.shape[0]} L=10 beta_min=0.1 50 + 50",
            "kernel_used": res.kernel_used, "launches": counts[wanted],
            "launches_by_layout": by_layout,
            "accept_rate": res.accept_rate.tolist(),
            "swap_rate": res.swap_rate.tolist(),
            "cold_mean": res.mean.tolist(), "cold_var": res.var.tolist(),
            "sampling_ms_per_transition": 1e3 * res.sampling_seconds / 50}))
        if not ok:
            fail(f"phase {sub} off: ran {res.kernel_used} with {counts} "
                 f"({by_layout}), accept {res.accept_rate.tolist()}, cold "
                 f"mean {res.mean.tolist()}")
        return res, counts[wanted]

    res10b, launched_10b = pt_route(
        "10b", "standard normal D=2 (kernel A)", pot.make_standard_normal(2),
        torch.randn(w10, 2, generator=seeded(13), device=dev),
        "fused_hmc_diag_quadratic", None, 0.5, 0.5)
    if not (res10b.mean.abs().max().item() < 0.05
            and (res10b.var - 1.0).abs().max().item() < 0.1):
        fail(f"phase 10b moments off: mean {res10b.mean.tolist()}, var "
             f"{res10b.var.tolist()} (limits 0.05, 0.1)")
    a_rungs = check_rungs(
        f"A std_normal R={r10} W={w10} D=2 L=10, phase 10b's ladder and "
        f"state", None, res10b.q, 10, res10b.step_sizes, res10b.betas,
        [_replica_seed(SEED + 16, i) for i in range(r10)])
    res10c, launched_10c = pt_route(
        "10c", "eight schools non-centred D=10 (kernel B, one walker a "
        "thread)", mp_es.potential, q_es[:w10].contiguous(),
        "fused_hmc_transition", "thread", step_es, 0.3)
    b_thread_rungs = check_rungs(
        f"B eight_schools_nc R={r10} W={w10} D=10 L=10, phase 10c's ladder "
        f"and state", form_es, res10c.q, 10, res10c.step_sizes,
        res10c.betas, [_replica_seed(SEED + 16, i) for i in range(r10)],
        res10c.u, res10c.g, plain_bits=False)

    # ---- 11. lockstep NUTS on the sampler-matrix target ---------------------
    clock.start('11. lockstep NUTS on the sampler-matrix target')
    # the ill-conditioned 16-dim Gaussian, sd logspace(0, 1, 16); NUTS has
    # no fused kernel: the Gaussian's batched value and gradient on the card
    w11, d11, n_warm11, n_samp11 = 65536, 16, 300, 300
    sd11 = torch.logspace(0.0, 1.0, d11, device=dev)
    target11 = pot.make_gaussian(torch.zeros(d11), cov=torch.diag(
        sd11.cpu() ** 2), device=dev)
    q11 = torch.randn(w11, d11, generator=seeded(12), device=dev) * sd11
    kernels.reset_launch_counts()
    reads = nuts._host_read.reads
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res11 = run_nuts(SEED + 15, target11, q11, num_warmup=n_warm11,
                     num_samples=n_samp11, max_depth=8)
    torch.cuda.synchronize()
    seconds11 = time.perf_counter() - t0
    reads = nuts._host_read.reads - reads
    reads11 = reads / (n_warm11 + n_samp11)
    var11, mean11 = torch.var_mean(res11.samples.reshape(-1, d11), dim=0)
    mean_err = (mean11 / sd11).abs().max().item()
    var_err = (var11 / sd11**2 - 1.0).abs().max().item()
    accept, depth = res11.accept_rate.item(), res11.mean_depth.item()
    print(json.dumps({
        "phase": f"11 run_nuts lockstep ill-conditioned Gaussian sd "
                 f"logspace(0, 1, {d11}) W={w11} max_depth=8 "
                 f"warmup={n_warm11} samples={n_samp11}",
        "launches": sum(kernels.launch_counts().values()),
        "max_mean_err_sd": mean_err, "max_rel_var_err": var_err,
        "accept_rate": accept, "divergence_rate":
            res11.divergence_rate.item(),
        "mean_depth": depth, "step_size": res11.step_size.item(),
        "host_reads_per_transition": reads / (n_warm11 + n_samp11),
        "seconds": seconds11,
        "sampling_ms_per_transition": 1e3 * res11.sampling_seconds
        / n_samp11,
        "walker_transitions_per_s": w11 * n_samp11 / res11.sampling_seconds}))
    if not (mean_err < 0.05 and var_err < 0.1 and 0.6 <= accept <= 0.99
            and 2.0 <= depth <= 8.0
            and sum(kernels.launch_counts().values()) == 0):
        fail(f"phase 11 off: mean {mean_err} sd (limit 0.05), var "
             f"{var_err} (0.1), accept {accept} (0.6-0.99), mean depth "
             f"{depth} (2-8), launches {kernels.launch_counts()}")

    # ---- 12. the command-line driver on the card ----------------------------
    clock.start('12. the command-line driver on the card')
    from physicsbasedbayesianinference_tpu_torch import main as cli
    from physicsbasedbayesianinference_tpu_torch import native
    from physicsbasedbayesianinference_tpu_torch.checkpoint import (
        CheckpointManager)
    from physicsbasedbayesianinference_tpu_torch.config import RunConfig

    def cli_process(args):
        """``python -m ...main args``, the entry point a user calls, as a
        process of its own: its JSON summary, its kernels' launches (the
        ``# launches`` line of its standard error) and its wall seconds."""
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", CLI, *args], cwd=ROOT,
                              capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"the CLI {' '.join(args)} exited {proc.returncode}: "
                 f"{proc.stderr[-3000:]}")
        launches = json.loads(
            proc.stderr.split("# launches ")[1].splitlines()[0])
        return json.loads(proc.stdout), launches, seconds

    def cli_run(cfg):
        """``main.run(cfg)`` in this process: (summary, its stderr lines)."""
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            summary = cli.run(cfg)
        return summary, err.getvalue()

    def checkpoints(err):
        return [json.loads(line[len("# checkpoint "):])
                for line in err.splitlines()
                if line.startswith("# checkpoint ")]

    def final_q(directory, state, steps_shape=()):
        """The positions of the last checkpoint in ``directory``, restored
        into the structure of ``state``."""
        nd = (state["q"] if isinstance(state, dict)
              else state.ensemble.q).shape[-1]
        z = torch.zeros(nd, device=dev)
        st = CheckpointManager(str(directory)).restore({
            "schema": 0, "state": state, "tau": torch.zeros((), device=dev),
            "step_size": torch.zeros(steps_shape, device=dev), "mean": z,
            "m2": z, "n": 0})["state"]
        return st["q"] if isinstance(st, dict) else st.ensemble.q

    def others_zero(launches, used):
        return all(v == 0 for k, v in launches.items()
                   if k != used and isinstance(v, int))

    with tempfile.TemporaryDirectory(prefix="pbbi_cli_") as tmp_name:
        tmp = Path(tmp_name)
        # 12a: the bench configuration through the CLI, a process of its own
        kernels.reset_launch_counts()  # the process counts from 0 too
        s12a, l12a, sec12a = cli_process([
            "--model", "builtin:std_normal_32d", "--num-walkers", str(w),
            "--num-steps", str(steps), "--num-warmup", str(n_warm),
            "--num-samples", str(n_samp), "--collect", "moments",
            "--output-path", str(tmp / "12a.npz")])
        launched_12a = l12a["fused_hmc_diag_quadratic"]
        mean_err = max(abs(x) for x in s12a["posterior_mean"])
        var_err = max(abs(x - 1.0) for x in s12a["posterior_var"])
        accept = s12a["accept_rate"]
        with np.load(tmp / "12a.npz", allow_pickle=False) as saved:
            saved_summary = json.loads(str(saved["summary"]))
        if not ((s12a["kernel_used"], s12a["kernel_variant"])
                == ("fused", "diag") and launched_12a == n_warm + n_samp
                and others_zero(l12a, "fused_hmc_diag_quadratic")
                and mean_err < 0.01 and var_err < 0.02
                and 0.6 <= accept <= 0.99
                and saved_summary["accept_rate"] == accept):
            fail(f"phase 12a off: {s12a['kernel_used']}/"
                 f"{s12a['kernel_variant']}, launches {l12a}, max|mean| "
                 f"{mean_err}, max|var-1| {var_err}, accept {accept}")
        # the same in this process with every sample kept: the summary's
        # ESS, R-hat and quantiles over [256, 102400, 32] on the card
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s12s, _ = cli_run(RunConfig(
            model="builtin:std_normal_32d", num_walkers=w, num_steps=steps,
            num_warmup=n_warm, num_samples=n_samp, collect="samples"))
        wall12s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        if not (np.isfinite(s12s["min_ess"]) and np.isfinite(s12s["max_rhat"])
                and kernels.launch_counts()["fused_hmc_diag_quadratic"]
                == n_warm + n_samp):
            fail(f"phase 12a with samples off: min ESS {s12s['min_ess']}, "
                 f"max R-hat {s12s['max_rhat']}")
        print(json.dumps({
            "phase": f"12a CLI hmc builtin:std_normal_32d W={w} L={steps} "
                     f"warmup={n_warm} samples={n_samp}",
            "kernel_used": s12a["kernel_used"],
            "kernel_variant": s12a["kernel_variant"],
            "launches": launched_12a, "max_abs_mean": mean_err,
            "max_abs_var_minus_1": var_err, "accept_rate": accept,
            "step_size": s12a["step_size"],
            "sampling_seconds": s12a["sampling_seconds"],
            "wall_seconds_of_run": s12a["wall_seconds"],
            "process_seconds": sec12a,
            "with_samples": {
                "wall_s": wall12s, "wall_seconds_of_run": s12s["wall_seconds"],
                "sampling_seconds": s12s["sampling_seconds"],
                "warmup_and_setup_s": (s12s["wall_seconds"]
                                       - s12s["sampling_seconds"]),
                "summary_s": wall12s - s12s["wall_seconds"],
                "min_ess": s12s["min_ess"], "max_rhat": s12s["max_rhat"]}}))

        # 12b: checkpointed hmc at the same width, resumed half way
        base = dict(model="builtin:std_normal_32d", num_walkers=w,
                    num_steps=steps, num_warmup=n_warm)
        every = 64
        kernels.reset_launch_counts()
        s_a1, e_a1 = cli_run(RunConfig(num_samples=128, checkpoint_every=every,
                                       checkpoint_dir=str(tmp / "b_a"),
                                       **base))
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            s_a2, e_a2 = cli_run(RunConfig(
                num_samples=n_samp, checkpoint_every=every,
                checkpoint_dir=str(tmp / "b_a"), **base))
        launched_12b = kernels.launch_counts()["fused_hmc_diag_quadratic"]
        s_b, e_b = cli_run(RunConfig(num_samples=n_samp,
                                     checkpoint_every=every,
                                     checkpoint_dir=str(tmp / "b_b"), **base))
        inputs = cli.prepare(RunConfig(num_samples=n_samp, **base))
        ref = run_hmc(inputs.seed, inputs.potential, inputs.init_q,
                      num_warmup=n_warm, num_samples=n_samp, num_steps=steps,
                      collect="moments")
        q_a, q_b = final_q(tmp / "b_a", ref.state), final_q(tmp / "b_b",
                                                            ref.state)
        mean_rel = max(abs(a - b) for a, b in zip(s_a2["posterior_mean"],
                                                  ref.mean.tolist()))
        var_rel = max(abs(a / b - 1.0) for a, b in zip(
            s_a2["posterior_var"], ref.var.tolist()))
        events = prof.events()
        chunks = [(e.time_range.start, e.time_range.end) for e in events
                  if e.name == "checkpoint_chunk"]

        def in_chunks(name):
            return sum(1 for e in events if e.name == name and any(
                a <= e.time_range.start <= b for a, b in chunks))
        blocking = {k: in_chunks(k) for k in BLOCKING}
        launched_in_chunks = in_chunks("cudaLaunchKernel")
        saves = checkpoints(e_a1 + e_a2 + e_b)
        if not (s_a2["resumed_from"] == 128 and s_a2["samples_done"] == n_samp
                and s_b["resumed_from"] is None
                and torch.equal(q_a, q_b)
                and torch.equal(q_a, ref.state.ensemble.q)
                and mean_rel <= 1e-6 and var_rel <= 1e-6
                and launched_12b == n_warm + n_samp
                and len(chunks) == 2 and not any(blocking.values())
                and launched_in_chunks > 0 and len(saves) == 8):
            fail(f"phase 12b off: resumed from {s_a2['resumed_from']}, final "
                 f"q equal {torch.equal(q_a, q_b)} / "
                 f"{torch.equal(q_a, ref.state.ensemble.q)}, moments "
                 f"{mean_rel} {var_rel}, launches {launched_12b}, "
                 f"{len(chunks)} chunks profiled with blocking calls "
                 f"{blocking} and {launched_in_chunks} launches")
        print(json.dumps({
            "phase": f"12b CLI hmc checkpointed every {every} W={w}: 128, "
                     f"resumed to {n_samp}; fresh to {n_samp}; run_hmc",
            "final_q_bitwise": True, "max_abs_mean_diff": mean_rel,
            "max_rel_var_diff": var_rel, "launches": launched_12b,
            "blocking_calls_in_2_chunks": blocking,
            "launches_in_2_chunks": launched_in_chunks,
            "checkpoint_bytes": saves[0]["bytes"],
            "save_ms": [c["save_ms"] for c in saves],
            "chunk_ms": [c["chunk_ms"] for c in saves],
            "ms_per_transition_in_chunks": statistics.median(
                c["chunk_ms"] for c in saves) / every}))

        # 12c: the CLI's chees on the two models with a device form
        lr_json = tmp / "logreg.json"
        lr_json.write_text(json.dumps({"x": x_lr.tolist(),
                                       "labels": y_lr.tolist()}))
        es_json = ROOT / "examples" / "eight_schools.data.json"
        launched_12c = {}
        for model, data, init_step, ref8 in (
                ("logistic_regression", lr_json, 0.05, ref8a),
                ("eight_schools_noncentered", es_json, 0.22, ref8b)):
            kernels.reset_launch_counts()
            s12c, l12c, sec12c = cli_process([
                "--sampler", "chees", "--model", f"example:{model}",
                "--data-path", str(data), "--num-walkers", str(w),
                "--num-warmup", str(n_warm8), "--num-samples", str(n_samp8),
                "--init-step-size", str(init_step), "--collect", "moments"])
            by = l12c["fused_hmc_transition_by"]
            by_layout = l12c["fused_hmc_transition_by_layout"]
            launched_12c[model] = l12c["fused_hmc_transition"]
            layout12c = {"logistic_regression": "group",
                         "eight_schools_noncentered": "thread"}[model]
            mean = torch.tensor(s12c["posterior_mean"], device=dev)
            var = torch.tensor(s12c["posterior_var"], device=dev)
            mean_err = ((mean - ref8.mean) / torch.sqrt(ref8.var)).abs().max(
                ).item()
            var_err = (var / ref8.var - 1.0).abs().max().item()
            if not ((s12c["kernel_used"], s12c["warmup_kernel_used"])
                    == ("fused", "fused")
                    and launched_12c[model] == n_warm8 + n_samp8
                    and by["counted"] == n_samp8
                    and by["counted+proposal"] == n_warm8
                    and by_layout[layout12c] == n_warm8 + n_samp8
                    and others_zero(l12c, "fused_hmc_transition")
                    and mean_err < 0.044 and var_err < 0.0625):
                fail(f"phase 12c {model} off: {s12c['warmup_kernel_used']}/"
                     f"{s12c['kernel_used']}, launches {l12c}, mean "
                     f"{mean_err} sd from phase 8's composed run (limit "
                     f"0.044), var {var_err} (limit 0.0625)")
            print(json.dumps({
                "phase": f"12c CLI chees example:{model} W={w} "
                         f"warmup={n_warm8} samples={n_samp8}",
                "kernel_used": s12c["kernel_used"],
                "warmup_kernel_used": s12c["warmup_kernel_used"],
                "launches": launched_12c[model], "launches_by": by,
                "launches_by_layout": by_layout,
                "max_mean_err_sd_vs_composed": mean_err,
                "max_rel_var_err_vs_composed": var_err,
                "accept_rate": s12c["accept_rate"],
                "step_size": s12c["step_size"],
                "trajectory_time": s12c["trajectory_time"],
                "mean_num_steps": s12c["mean_num_steps"],
                "wall_seconds_of_run": s12c["wall_seconds"],
                "process_seconds": sec12c}))
        # a checkpointed chees run on eight schools, resumed half way
        base = dict(model="example:eight_schools_noncentered",
                    data_path=str(es_json), sampler="chees", num_walkers=w,
                    num_warmup=n_warm8, init_step_size=0.22,
                    checkpoint_every=128)
        cli_run(RunConfig(num_samples=128, checkpoint_dir=str(tmp / "c_a"),
                          **base))
        s_ca, _ = cli_run(RunConfig(num_samples=n_samp8,
                                    checkpoint_dir=str(tmp / "c_a"), **base))
        s_cb, _ = cli_run(RunConfig(num_samples=n_samp8,
                                    checkpoint_dir=str(tmp / "c_b"), **base))
        inputs = cli.prepare(RunConfig(num_samples=n_samp8, **base))
        ref = run_chees_hmc(inputs.seed, inputs.potential, inputs.init_q,
                            num_warmup=n_warm8, num_samples=n_samp8,
                            init_step_size=0.22, collect="moments")
        q_a, q_b = final_q(tmp / "c_a", ref.state), final_q(tmp / "c_b",
                                                            ref.state)
        if not (s_ca["resumed_from"] == 128 and torch.equal(q_a, q_b)
                and torch.equal(q_a, ref.state.ensemble.q)
                and s_ca["posterior_mean"] == s_cb["posterior_mean"]):
            fail("phase 12c: the resumed chees run is not the uninterrupted "
                 "one bit for bit")
        print(json.dumps({
            "phase": f"12c CLI chees eight schools checkpointed every 128 "
                     f"W={w}: 128, resumed to {n_samp8}; fresh; "
                     f"run_chees_hmc",
            "final_q_bitwise": True, "resumed_from": s_ca["resumed_from"]}))

        # 12d: checkpointed SMC, resumed from an intermediate stage copied
        # into a fresh directory
        base = dict(model="builtin:std_normal_32d", sampler="smc",
                    num_walkers=w, num_steps=10, smc_beta0=0.02)
        kernels.reset_launch_counts()
        s_d1, e_d1 = cli_run(RunConfig(checkpoint_dir=str(tmp / "d_a"),
                                       **base))
        launched_12d = kernels.launch_counts()["fused_hmc_diag_quadratic"]
        others_d = others_zero(kernels.launch_counts(),
                               "fused_hmc_diag_quadratic")
        stages = sorted(int(p.name) for p in (tmp / "d_a").iterdir()
                        if p.name.isdigit())
        mid = stages[0]
        (tmp / "d_b").mkdir()
        shutil.copytree(tmp / "d_a" / str(mid), tmp / "d_b" / str(mid))
        kernels.reset_launch_counts()
        s_d2, _ = cli_run(RunConfig(checkpoint_dir=str(tmp / "d_b"), **base))
        launched_resumed = kernels.launch_counts()["fused_hmc_diag_quadratic"]
        n_st = s_d1["num_stages"]
        if not (s_d2["resumed_from"] == mid and mid < n_st
                and s_d2["num_stages"] == n_st
                and s_d2["log_evidence"] == s_d1["log_evidence"]
                and s_d2["posterior_mean"] == s_d1["posterior_mean"]
                and launched_12d == 3 * n_st and others_d
                and launched_resumed == 3 * (n_st - mid)):
            fail(f"phase 12d off: {n_st} stages, resumed from {mid} to "
                 f"{s_d2['num_stages']}, log Z {s_d1['log_evidence']} and "
                 f"{s_d2['log_evidence']}, launches {launched_12d} and "
                 f"{launched_resumed}")
        saves = checkpoints(e_d1)
        print(json.dumps({
            "phase": f"12d CLI smc checkpointed std_normal_32d W={w} "
                     f"beta0=0.02, resumed from stage {mid}",
            "num_stages": n_st, "log_evidence": s_d1["log_evidence"],
            "log_evidence_bitwise": True, "launches": launched_12d,
            "resumed_launches": launched_resumed,
            "checkpoint_bytes": saves[0]["bytes"],
            "save_ms": [c["save_ms"] for c in saves],
            "stage_ms": [c["chunk_ms"] for c in saves]}))

        # 12e: checkpointed pt (kernel B's mixture form) and nuts, resumed
        # half way, against the uninterrupted runs
        launched_12e = None
        for sampler, extra, n_w, n_s, chunk in (
                ("pt", dict(model="builtin:bimodal_2d", pt_replicas=6,
                            num_steps=10, num_walkers=16384), 100, 128, 64),
                ("nuts", dict(model="builtin:std_normal_32d",
                              num_walkers=8192), 50, 64, 32)):
            base = dict(sampler=sampler, num_warmup=n_w,
                        checkpoint_every=chunk, **extra)
            kernels.reset_launch_counts()
            cli_run(RunConfig(num_samples=chunk, checkpoint_dir=str(
                tmp / f"e_{sampler}_a"), **base))
            s_ea, _ = cli_run(RunConfig(num_samples=n_s, checkpoint_dir=str(
                tmp / f"e_{sampler}_a"), **base))
            counts = kernels.launch_counts()
            by_layout = dict(kernels.fused_hmc_transition.launches_by_layout)
            s_eb, _ = cli_run(RunConfig(num_samples=n_s, checkpoint_dir=str(
                tmp / f"e_{sampler}_b"), **base))
            inputs = cli.prepare(RunConfig(num_samples=n_s, **base))
            if sampler == "pt":
                ref = run_parallel_tempering(
                    inputs.seed, inputs.potential, inputs.init_q,
                    num_replicas=6, num_warmup=n_w, num_samples=n_s,
                    num_steps=10, init_step_size=0.1, collect="moments")
                state, ref_q, shape = ({"q": ref.q, "u": ref.u, "g": ref.g},
                                       ref.q, (6,))
                launched_12e = counts["fused_hmc_transition"]
                layout12e = by_layout
                launches_ok = (launched_12e == n_w + n_s
                               and layout12e["thread"] == launched_12e
                               and others_zero(counts,
                                               "fused_hmc_transition"))
            else:
                ref = run_nuts(inputs.seed, inputs.potential, inputs.init_q,
                               num_warmup=n_w, num_samples=n_s,
                               init_step_size=0.1, collect="none")
                state, ref_q, shape = ref.state, ref.state.ensemble.q, ()
                launches_ok = sum(counts.values()) == 0
            q_a = final_q(tmp / f"e_{sampler}_a", state, shape)
            q_b = final_q(tmp / f"e_{sampler}_b", state, shape)
            if not (s_ea["resumed_from"] == chunk and launches_ok
                    and torch.equal(q_a, q_b) and torch.equal(q_a, ref_q)
                    and s_ea["posterior_mean"] == s_eb["posterior_mean"]):
                fail(f"phase 12e {sampler} off: resumed from "
                     f"{s_ea['resumed_from']}, final q equal "
                     f"{torch.equal(q_a, q_b)} / {torch.equal(q_a, ref_q)}, "
                     f"launches {counts}")
            print(json.dumps({
                "phase": f"12e CLI {sampler} checkpointed every {chunk} "
                         f"{extra['model']} W={extra['num_walkers']}: "
                         f"resumed to {n_s}; fresh; the run_* call",
                "final_q_bitwise": True, "launches": counts,
                **({"launches_by_layout": layout12e} if sampler == "pt"
                   else {}),
                "accept_rate": s_ea["accept_rate"]}))

        # 12f: stream mode into a sample file
        out = tmp / "12f.pbbi"
        kernels.reset_launch_counts()
        s12f, _ = cli_run(RunConfig(
            model="builtin:std_normal_32d", num_walkers=8192, num_warmup=100,
            num_samples=64, num_steps=steps, thin=4, collect="stream",
            output_path=str(out)))
        data = np.asarray(native.read_samples(str(out)))
        rows12f = data
        mean_err = float(np.abs(data.mean(0)).max())
        sd_err = float(np.abs(data.std(0) - 1.0).max())
        launched_12f = kernels.launch_counts()["fused_hmc_diag_quadratic"]
        out.unlink()
        if not (data.shape == (64 * 8192, 32) and mean_err < 0.02
                and sd_err < 0.02 and launched_12f == 100 + 64 * 4):
            fail(f"phase 12f off: {data.shape} rows, max|mean| {mean_err}, "
                 f"max|sd-1| {sd_err}, launches {launched_12f}")
        print(json.dumps({
            "phase": "12f CLI hmc collect=stream std_normal_32d W=8192 "
                     "64 rows thin=4",
            "rows": data.shape[0], "max_abs_mean": mean_err,
            "max_abs_sd_minus_1": sd_err, "launches": launched_12f,
            "accept_rate": s12f["accept_rate"],
            "wall_seconds_of_run": s12f["wall_seconds"]}))

    # 12g: run_hmc(metric="dense") on phase 7's correlated Gaussian: the
    # step is torch.matmul and the potential, no kernel
    q0 = torch.randn(w, d, generator=seeded(0), device=dev)
    kernels.reset_launch_counts()
    res12g = run_hmc(SEED + 3, pot.make_gaussian(mean7, cov=cov7), q0,
                     num_warmup=n_warm, num_samples=n_samp, num_steps=steps,
                     collect="moments", metric="dense")
    mean_err = ((res12g.mean.cpu() - mean7) / sd7).abs().max().item()
    var_err = (res12g.var.cpu() / sd7**2 - 1.0).abs().max().item()
    cov_err = (torch.linalg.norm(res12g.metric_cov.cpu() - cov7)
               / torch.linalg.norm(cov7)).item()
    accept = res12g.accept_rate.item()
    print(json.dumps({
        "phase": f"12g run_hmc metric=dense correlated 32-dim Gaussian "
                 f"W={w} L={steps}",
        "kernel_used": res12g.kernel_used,
        "launches": sum(kernels.launch_counts().values()),
        "max_mean_err_sd": mean_err, "max_rel_var_err": var_err,
        "metric_cov_rel_frobenius_err": cov_err,
        "metric_cov_gate": DENSE_COV_GATE, "accept_rate": accept,
        "step_size": res12g.step_size.item(),
        "step_size_7a_diag": corr_steps["7a"],
        "ms_per_transition": 1e3 * res12g.sampling_seconds / n_samp}))
    if not (res12g.kernel_used == "dense"
            and sum(kernels.launch_counts().values()) == 0
            and mean_err < 0.02 and var_err < 0.03
            and cov_err < DENSE_COV_GATE and 0.6 <= accept <= 0.99):
        fail(f"phase 12g off: mean {mean_err} sd (limit 0.02), var "
             f"{var_err} (0.03), Sigma {cov_err} ({DENSE_COV_GATE}), accept "
             f"{accept}")

    # ---- 13. the sharded paths (parallel/) on the card ----------------------
    clock.start('13. the sharded paths (parallel/) on the card')
    # One card: the sharded paths run in a one-rank NCCL group in this
    # process (13b, 13c, 13e) and through torchrun with one process (13d).
    # What a K-rank run needs of the kernels is held at the kernel level
    # (13a): launches over two blocks of walkers at their global offsets,
    # and kernel E over two blocks of sources. With two or more cards 13b
    # and 13d also run K = 2 under torchrun and are held to K = 1.
    import torch.distributed as dist
    from physicsbasedbayesianinference_tpu_torch import build_fused_hmc_kernel
    from physicsbasedbayesianinference_tpu_torch import parallel as par
    gen13 = torch.Generator(device="cpu").manual_seed(SEED + 13)
    halves = (slice(0, w // 2), slice(w // 2, w))

    def check_offsets(case, launch, plain, order, nbytes, ops):
        """``launch(rows, offset)`` and ``plain(rows, offset)`` on the whole
        and on the two halves at their global walker offsets: the kernel's
        halves joined must be the whole launch bit for bit, the plain
        version's the plain whole, and the kernel within phase 2's
        tolerance of the plain version. Times the half at offset W / 2."""
        outs = {}
        for name, fn in (("kernel", launch), ("plain", plain)):
            whole = named(fn(slice(0, w), 0), order)
            parts = [named(fn(rows, rows.start), order) for rows in halves]
            torch.cuda.synchronize()
            for key in order:
                if not torch.equal(whole[key],
                                   torch.cat([p[key] for p in parts])):
                    fail(f"13a {case}: the {name} halves' {key} at their "
                         f"offsets is not the whole {name} launch's")
            outs[name] = whole
        log_u = torch.log(philox.accept_uniforms(SEED, 13, w, dev))
        line = {"case": case, "halves_join_bitwise": True,
                "max_abs_err": compare(f"13a {case}", outs["kernel"],
                                       outs["plain"], log_u),
                **bound(nbytes, ops),
                "ms": median_ms(lambda: launch(halves[1], w // 2)),
                "plain_ms": median_ms(lambda: plain(halves[1], w // 2))}
        print(json.dumps(line))
        return line

    q13 = torch.randn(w, d, generator=gen13).to(dev)
    ones, zeros = torch.ones(d, device=dev), torch.zeros(d, device=dev)
    kw13 = dict(scalars=scalars(0.3), p_std=ones, inv_mass=ones,
                num_steps=steps)
    a_off = check_offsets(
        "A std_normal W=102400 D=32 L=16, halves at offsets 0 and 51200",
        lambda rows, off: kernels.fused_hmc_diag_quadratic(
            SEED, 13, q13[rows], k_diag=ones, mean=zeros,
            walker_offset=off, **kw13),
        lambda rows, off: kernels.fused_hmc_diag_quadratic_plain(
            SEED, 13, q13[rows], k_diag=ones, mean=zeros,
            walker_offset=off, **kw13),
        A_ORDER, transition_bytes(w // 2, d, False),
        a_ops(w // 2, d, steps))
    form7 = pot.make_gaussian(mean7, cov=cov7, device=dev).device_form
    u13, g13 = kernels.device_value_and_grad(form7)(q13)
    im13 = (0.5 + 1.5 * torch.rand(d, generator=gen13)).to(dev)
    kw13b = dict(scalars=scalars(0.1), p_std=torch.sqrt(1.0 / im13),
                 inv_mass=im13, num_steps=steps)
    b_off = check_offsets(
        f"B correlated gaussian (phase 7) W=102400 D=32 L=16 tile "
        f"{kernels.walker_tile(w, d)}, halves at offsets 0 and 51200",
        lambda rows, off: kernels.fused_hmc_transition(
            form7, SEED, 13, q13[rows], u13[rows], g13[rows],
            walker_offset=off, **kw13b),
        lambda rows, off: kernels.fused_hmc_transition_plain(
            form7, SEED, 13, q13[rows], u13[rows], g13[rows],
            walker_offset=off, **kw13b),
        B_ORDER, transition_bytes(w // 2, d, True),
        b_ops(w // 2, d, steps, form7))

    # kernel E: the sources a separate array. As their own sources the
    # bodies give the one-set launch's bits; over two blocks of sources,
    # summed, the ring's K = 2 tiles, within the bound of check_e of the
    # one-set launch and of the plain version.
    x16, m16 = plummer.x, plummer.mass
    kw_e = dict(g_const=1.0, softening=0.05)
    one_set = kernels.nbody_accelerations_tiled(x16, m16, **kw_e)
    as_sources = kernels.nbody_accelerations_tiled(x16, None,
                                                   sources=(x16, m16), **kw_e)
    torch.cuda.synchronize()
    if not torch.equal(one_set, as_sources):
        fail("13a: kernel E with the bodies as their own sources is not the "
             "one-set launch bit for bit")
    tiles = [(x16[rows].contiguous(), m16[rows].contiguous())
             for rows in (slice(0, 8192), slice(8192, 16384))]
    two_blocks = sum(kernels.nbody_accelerations_tiled(x16, None,
                                                       sources=src, **kw_e)
                     for src in tiles)
    n16 = x16.shape[0]
    u32 = torch.finfo(torch.float32).eps / 2
    allowed_e = kernels.NBODY_BOUND_C + kernels.NBODY_BOUND_TERM / n16**0.5
    scale_e = u32 * n16**0.5 * kernels.nbody_abs_sum(x16, m16, **kw_e)[:, None]
    ratios = {}
    for name, ref in (("one_set_launch", one_set),
                      ("plain", kernels.nbody_accelerations_tiled_plain(
                          x16, m16, **kw_e))):
        ratios[name] = ((two_blocks - ref).abs().double()
                        / scale_e).max().item()
        if not ratios[name] <= allowed_e:
            fail(f"13a: kernel E over two source blocks reaches "
                 f"{ratios[name]:.3g} u sqrt(N) S_i from the {name}, over "
                 f"the bound {allowed_e:.3g}")
    # x and m of the targets in, a out: as check_e; a tile reads its
    # sources' x and m
    e_src = {"case": "E source-block form, Plummer N=16384 as its own "
                     "sources eps=0.05 (13e's launch)",
             "same_bits_as_one_set": True,
             "max_abs_err": (as_sources - kernels.nbody_accelerations_tiled_plain(
                 x16, None, sources=(x16, m16), **kw_e)).abs().max().item(),
             **bound(4 * (6 * n16 + 4 * n16), 12.0 * n16 * n16),
             "ms": median_ms(lambda: kernels.nbody_accelerations_tiled(
                 x16, None, sources=(x16, m16), **kw_e)),
             "plain_ms": median_ms(
                 lambda: kernels.nbody_accelerations_tiled_plain(
                     x16, None, sources=(x16, m16), **kw_e),
                 reps=3, rounds=3)}
    e_tile = {"case": "E one ring tile: 16384 targets, 8192 sources",
              "two_tiles_ratio_u_sqrtN_S": ratios, "allowed_ratio": allowed_e,
              **bound(4 * (6 * n16 + 4 * 8192), 12.0 * n16 * 8192),
              "ms": median_ms(lambda: kernels.nbody_accelerations_tiled(
                  x16, None, sources=tiles[1], **kw_e)),
              "plain_ms": median_ms(
                  lambda: kernels.nbody_accelerations_tiled_plain(
                      x16, None, sources=tiles[1], **kw_e),
                  reps=3, rounds=3)}
    print(json.dumps(e_src))
    print(json.dumps(e_tile))

    # ---- 13b. sharded_run_hmc in a one-rank NCCL group ----------------------
    clock.start('13b. sharded_run_hmc in a one-rank NCCL group')
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    mesh = par.make_walker_mesh()
    std32 = pot.make_standard_normal(d)
    bench = dict(num_warmup=n_warm, num_samples=n_samp, num_steps=steps,
                 collect="moments")

    def timed(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def transition_ms(r, wall):
        """ms a sampling transition, and a warmup transition with the
        run's set-up (wall time less sampling, over the warmup)."""
        return {"sampling_ms": 1e3 * r.sampling_seconds / n_samp,
                "warmup_ms": 1e3 * (wall - r.sampling_seconds) / n_warm}

    def profile_counts(run):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return {e.key: e.count for e in prof.key_averages()}

    # what profiling nothing records: the closing synchronize above and
    # the profiler's own with the card's activity on
    profile_floor = profile_counts(lambda: None)

    def profiled(run):
        """The run's host calls and the card's copies under the profiler:
        {name: count}, less what profiling nothing records."""
        return {k: c - profile_floor.get(k, 0)
                for k, c in profile_counts(run).items()}

    def collectives(calls):
        """The collectives and point-to-point calls: the c10d operators
        (one a call) and NCCL's own annotations, by name."""
        return {k: c for k, c in calls.items()
                if k.startswith(("c10d::", "nccl:"))}

    def census(calls):
        """How many collective calls: the c10d operators, or NCCL's
        annotations where the profiler shows no operator."""
        return (sum(c for k, c in calls.items() if k.startswith("c10d::"))
                or sum(c for k, c in calls.items() if k.startswith("nccl:")))

    def blocking(calls):
        """What makes the host wait for the card: the synchronisations
        and the copies between host and card. A device-to-device
        cudaMemcpyAsync (NCCL's, a tensor's copy into the gather buffer)
        does not, so copies are counted at the operators that make them
        (``host_copies``): the profiler's records of the card's copies
        gave the same run 0, 1 or 2 copies from pageable memory on an
        H100 80GB HBM3 at 700 W. A copy made inside a
        tensor factory (``torch.tensor(x, device=...)``) is no operator of
        its own and is not counted."""
        out = {k: calls.get(k, 0) for k in (
            "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")}
        out["host_copies"] = calls["host_copies"]
        return out

    class HostCopies(TorchDispatchMode):
        """Counts the operators that move data between host and card: a
        copy or a conversion from one to the other, and a scalar read from
        the card."""

        def __init__(self):
            super().__init__()
            self.count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is aten._local_scalar_dense.default:
                self.count += args[0].device.type == "cuda"
            elif func in (aten._to_copy.default, aten.copy_.default):
                src, dst = ((args[1], args[0]) if func is aten.copy_.default
                            else (args[0], out))
                # under torch.func's transforms an operand may be a number
                self.count += (isinstance(src, torch.Tensor)
                               and isinstance(dst, torch.Tensor)
                               and {src.device.type, dst.device.type}
                               == {"cpu", "cuda"})
            return out

    def profiled_with_copies(run):
        """``profiled(run)``, and ``host_copies`` the copies between host
        and card of a second run (``HostCopies``; not under the profiler,
        which records an operator that a dispatch mode re-dispatches
        twice)."""
        calls = profiled(run)
        mode = HostCopies()
        with mode:
            run()
        torch.cuda.synchronize()
        return {**calls, "host_copies": mode.count}

    q0 = torch.randn(w, d, generator=seeded(0), device=dev)
    # the step size fixed, no adaptation: run_hmc's final positions (and
    # NCCL's communicator made at its one collective, before the timed
    # runs)
    fixed = dict(num_warmup=0, num_samples=32, num_steps=steps,
                 init_step_size=res.step_size.item(), collect="none")
    q_fixed = par.sharded_run_hmc(SEED, std32, q0, mesh=mesh,
                                  **fixed).state.ensemble.q
    if not torch.equal(q_fixed,
                       run_hmc(SEED, std32, q0, **fixed).state.ensemble.q):
        fail("phase 13b: the fixed-step sharded run's q is not run_hmc's")
    ref13, wall_ref13 = timed(lambda: run_hmc(SEED, std32, q0, **bench))
    kernels.reset_launch_counts()
    res13, wall13 = timed(lambda: par.sharded_run_hmc(SEED, std32, q0,
                                                      mesh=mesh, **bench))
    counts13 = kernels.launch_counts()
    launched_13b_a = counts13["fused_hmc_diag_quadratic"]
    mean_err = res13.mean.abs().max().item()
    var_err = (res13.var - 1.0).abs().max().item()
    accept = res13.accept_rate.item()
    same_bits_13 = all(torch.equal(a, b) for a, b in (
        (res13.mean, res.mean), (res13.var, res.var),
        (res13.step_size, res.step_size),
        (res13.state.ensemble.q, res.state.ensemble.q)))
    if not ((res13.kernel_used, res13.kernel_variant) == ("fused", "diag")
            and launched_13b_a == n_warm + n_samp
            and sum(counts13.values()) == launched_13b_a
            and mean_err < 0.01 and var_err < 0.02
            and 0.6 <= accept <= 0.99):
        fail(f"phase 13b off: {res13.kernel_used}/{res13.kernel_variant}, "
             f"launches {counts13}, max|mean| {mean_err}, max|var-1| "
             f"{var_err}, accept {accept}")
    # collectives and blocking calls: three short runs, whose differences
    # are 4 warmup and 4 sampling transitions
    short = {}
    for n_w, n_s in ((4, 2), (8, 2), (4, 6)):
        def run13():
            return par.sharded_run_hmc(
                SEED, std32, q0, mesh=mesh, num_warmup=n_w, num_samples=n_s,
                num_steps=steps, collect="moments")
        calls = profiled_with_copies(run13)
        short[n_w, n_s] = (census(calls), blocking(calls),
                           collectives(calls))
    per_warmup = (short[8, 2][0] - short[4, 2][0]) / 4
    per_sampling = (short[4, 6][0] - short[4, 2][0]) / 4
    # two sampling transitions alone: the bound kernel's step and the
    # loop's ensemble means
    hk13 = par.shard_map_kernel(build_fused_hmc_kernel(std32, num_steps=steps),
                                mesh)
    st13 = hk13.init(q0)

    def two_transitions():
        state = st13
        for t in range(2):
            state, info = hk13.step((SEED, t), state, res.step_size)
            torch.mean(info.accept_prob)
            torch.var_mean(state.ensemble.q, dim=0, correction=0)

    blocking_two = blocking(profiled_with_copies(two_transitions))
    if not (short[4, 2][0] > 0 and per_warmup <= 1 and per_sampling == 0
            and not any(blocking_two.values())
            and short[4, 2][1] == short[8, 2][1] == short[4, 6][1]):
        fail(f"phase 13b: {per_warmup} collectives a warmup transition, "
             f"{per_sampling} a sampling transition ({short}), blocking "
             f"calls "
             f"{blocking_two} in two sampling transitions, runs' blocking "
             f"calls {[v[1] for v in short.values()]}")
    print(json.dumps({
        "phase": f"13b sharded_run_hmc std_normal_32d W={w} L={steps} "
                 f"one-rank NCCL group",
        "kernel_used": res13.kernel_used, "launches": launched_13b_a,
        "max_abs_mean": mean_err, "max_abs_var_minus_1": var_err,
        "accept_rate": accept, "step_size": res13.step_size.item(),
        "same_bits_as_phase_3": same_bits_13,
        "fixed_step_q_bitwise_run_hmc": True,
        "collectives_per_warmup_transition": per_warmup,
        "collectives_per_sampling_transition": per_sampling,
        "collectives_run_4_warmup_2_sampling": short[4, 2][2],
        "blocking_calls_two_sampling_transitions": blocking_two,
        "sharded": transition_ms(res13, wall13),
        "run_hmc_same_call": transition_ms(ref13, wall_ref13),
        "phase_3_sampling_ms": 1e3 * res.sampling_seconds / n_samp,
        "card": card}))

    corr7 = pot.make_gaussian(mean7, cov=cov7)
    q0 = torch.randn(w, d, generator=seeded(0), device=dev)
    kernels.reset_launch_counts()
    res13g, wall13g = timed(lambda: par.sharded_run_hmc(
        SEED + 3, corr7, q0, mesh=mesh, **bench))
    counts13g = kernels.launch_counts()
    launched_13b_b = counts13g["fused_hmc_transition"]
    mean_err = ((res13g.mean.cpu() - mean7) / sd7).abs().max().item()
    var_err = (res13g.var.cpu() / sd7**2 - 1.0).abs().max().item()
    accept = res13g.accept_rate.item()
    if not ((res13g.kernel_used, res13g.kernel_variant) == ("fused",
                                                             "generic")
            and launched_13b_b == n_warm + n_samp
            and sum(counts13g.values()) == launched_13b_b
            and mean_err < 0.02 and var_err < 0.03
            and 0.6 <= accept <= 0.99):
        fail(f"phase 13b correlated off: {res13g.kernel_variant}, launches "
             f"{counts13g}, mean {mean_err} sd, var {var_err}, accept "
             f"{accept}")
    print(json.dumps({
        "phase": f"13b sharded_run_hmc correlated 32-dim Gaussian (phase 7) "
                 f"W={w} L={steps} one-rank NCCL group",
        "kernel_variant": res13g.kernel_variant, "launches": launched_13b_b,
        "max_mean_err_sd": mean_err, "max_rel_var_err": var_err,
        "accept_rate": accept, "step_size": res13g.step_size.item(),
        "sharded": transition_ms(res13g, wall13g),
        "phase_7a_sampling_ms": corr_ms["7a"], "card": card}))

    # ---- 13c. sharded SMC, one rank, on phase 9a's target and start ----------
    clock.start("13c. sharded SMC, one rank, on phase 9a's target and start")
    kw9 = dict(num_mutation_steps=3, num_leapfrog_steps=10,
               init_step_size=0.8, beta0=beta0, max_stages=40)
    kernels.reset_launch_counts()
    reads = smc._host_read.reads
    res13c, sec13c = timed(lambda: run_smc(SEED + 13, std32, q9,
                                           kernel="auto", mesh=mesh, **kw9))
    reads = smc._host_read.reads - reads
    counts13c = kernels.launch_counts()
    n13c = res13c.num_stages
    z_err = abs(res13c.log_evidence.item() - 0.5 * d * np.log(beta0))
    again = run_smc(SEED + 13, std32, q9, kernel="auto", mesh=mesh, **kw9)
    m13c = smc.build_smc_machinery(std32, w, q9.dtype, num_dims=d,
                                   device=dev, mesh=mesh,
                                   **{k: v for k, v in kw9.items()
                                      if k != "max_stages"})
    carry13c = m13c["body"](m13c["init_carry"](SEED + 13, q9))

    def two_stages():
        c = carry13c
        for _ in range(2):
            c = m13c["body"](c)

    calls13c = profiled_with_copies(two_stages)
    if not (n13c < 40 and res13c.betas[n13c] == 1.0 and z_err < 0.25
            and counts13c["fused_hmc_diag_quadratic"] == 3 * n13c
            and sum(counts13c.values()) == 3 * n13c and reads == n13c + 1
            and torch.equal(again.log_evidence, res13c.log_evidence)
            and not any(blocking(calls13c).values())):
        fail(f"phase 13c off: {n13c} stages, log Z error {z_err}, launches "
             f"{counts13c}, {reads} host reads, second log Z "
             f"{again.log_evidence.item()} against "
             f"{res13c.log_evidence.item()}, blocking "
             f"{blocking(calls13c)}")
    print(json.dumps({
        "phase": "13c run_smc(mesh=) std_normal_32d W=102400 beta0=0.1 K=3 "
                 "L=10 one-rank NCCL group",
        "kernel_used": res13c.kernel_used,
        "launches": counts13c["fused_hmc_diag_quadratic"],
        "num_stages": n13c, "num_stages_9a": res9a.num_stages,
        "log_evidence": res13c.log_evidence.item(),
        "log_evidence_err": z_err,
        "same_bits_as_9a": bool(
            torch.equal(res13c.log_evidence, res9a.log_evidence)
            and torch.equal(res13c.q, res9a.q)),
        "host_reads": reads,
        "collectives_per_stage": census(calls13c) / 2,
        "collectives_two_stages": collectives(calls13c),
        "ms_per_stage": 1e3 * sec13c / n13c,
        "ms_per_stage_9a": line9a["ms_per_stage"], "card": card}))

    # ---- 13d. the CLI, sharded, through torchrun ------------------------------
    clock.start('13d. the CLI, sharded, through torchrun')
    def torchrun(k, args):
        """``python -m torch.distributed.run --nproc_per_node=k args`` from
        the checkout: (its summary, rank 0's launches, seconds)."""
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc_per_node={k}", *args], cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"torchrun {' '.join(args)} with {k} processes exited "
                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        parts = proc.stderr.split("# launches ")
        launches = (json.loads(parts[1].splitlines()[0]) if len(parts) > 1
                    else None)
        return proc.stdout, launches, seconds

    sizes = [1] + ([2] if torch.cuda.device_count() >= 2 else [])
    with tempfile.TemporaryDirectory(prefix="pbbi_sharded_") as tmp13:
        cfg13 = Path(tmp13) / "run.json"
        cfg13.write_text(RunConfig(
            model="builtin:std_normal_32d", num_walkers=w, num_steps=steps,
            num_warmup=n_warm, num_samples=n_samp, collect="moments",
            sharded=True).to_json())
        cli13 = {}
        for k in sizes:
            out, launches, sec = torchrun(k, ["-m", CLI, "--config",
                                              str(cfg13)])
            s13 = json.loads(out)
            mean_err = max(abs(x) for x in s13["posterior_mean"])
            var_err = max(abs(x - 1.0) for x in s13["posterior_var"])
            accept = s13["accept_rate"]
            if not ((s13["kernel_used"], s13["kernel_variant"])
                    == ("fused", "diag")
                    and launches["fused_hmc_diag_quadratic"]
                    == n_warm + n_samp
                    and others_zero(launches, "fused_hmc_diag_quadratic")
                    and mean_err < 0.01 and var_err < 0.02
                    and 0.6 <= accept <= 0.99):
                fail(f"phase 13d K={k} off: {s13['kernel_used']}/"
                     f"{s13['kernel_variant']}, launches {launches}, "
                     f"max|mean| {mean_err}, max|var-1| {var_err}, accept "
                     f"{accept}")
            cli13[k] = {"kernel_used": s13["kernel_used"],
                        "launches_rank_0": launches[
                            "fused_hmc_diag_quadratic"],
                        "max_abs_mean": mean_err,
                        "max_abs_var_minus_1": var_err,
                        "accept_rate": accept,
                        "sampling_seconds": s13["sampling_seconds"],
                        "process_seconds": sec}
        launched_13d = cli13[1]["launches_rank_0"]
        # K = 2 of 13b on two cards: the fixed-step q against K = 1's
        if len(sizes) > 1:
            out13b2 = Path(tmp13) / "k2.pt"
            torchrun(2, ["chip_smoke.py", "--sharded-rank", str(out13b2),
                         repr(res.step_size.item())])
            k2 = torch.load(out13b2)
            if not torch.equal(k2["q_fixed"].to(dev), q_fixed):
                fail("phase 13b K=2: the fixed-step q is not K=1's")
            if not (k2["mean"].abs().max() < 0.01
                    and (k2["var"] - 1.0).abs().max() < 0.02):
                fail(f"phase 13b K=2 moments off: {k2}")
            cli13["13b_K2"] = {"fixed_step_q_bitwise_K1": True,
                               "max_abs_mean": k2["mean"].abs().max().item(),
                               "step_size": k2["step_size"].item()}
    print(json.dumps({
        "phase": f"13d CLI hmc sharded=true builtin:std_normal_32d W={w} "
                 f"L={steps} through torchrun",
        "process_counts_run": sizes,
        "note": ("ran K=1 only: one CUDA device" if len(sizes) == 1
                 else "ran K=1 and K=2"),
        "runs": cli13, "card": card}))

    # ---- 13e. ring_simulate, one rank, on phase 6's Plummer sphere ------------
    clock.start("13e. ring_simulate, one rank, on phase 6's Plummer sphere")
    # The K = 1 ring is phase 6's velocity Verlet with one launch of kernel
    # E's source-block form a step (and one to start). Tolerance on the
    # final positions against physics.simulate: a per-step difference of
    # the accelerations up to kernels.nbody_bound moves x by at most
    # (n dt)^2 max_i bound_i over n steps, and each step rounds x once
    # more, 2 n u max|x|.
    bodies = par.make_body_mesh()
    n_ring, save_ring, dt_ring = 200, 50, 5e-4
    kernels.reset_launch_counts()
    (x13, v13, e13), sec13e = timed(lambda: par.ring_simulate(
        plummer.x, plummer.v, plummer.mass, dt_ring, num_steps=n_ring,
        save_every=save_ring, mesh=bodies, softening=0.05))
    counts13e = kernels.launch_counts()
    by13e = dict(kernels.nbody_accelerations_tiled.launches_by)
    launched_13e = counts13e["nbody_accelerations_tiled"]
    e0 = physics.total_energy(plummer, softening=0.05)
    drift13 = ((e13 - e0) / e0).abs().max().item()
    traj13 = physics.simulate(plummer, dt_ring, n_ring,
                              method="velocity_verlet",
                              save_every=save_ring, softening=0.05)
    x_err13 = (x13 - traj13.final.x).abs().max().item()
    tol13 = ((n_ring * dt_ring) ** 2 * kernels.nbody_bound(
        plummer.x, plummer.mass, g_const=1.0, softening=0.05).max().item()
        + 2 * n_ring * u32 * plummer.x.abs().max().item())
    if not (launched_13e == n_ring + 1
            and by13e["source_block"] == launched_13e
            and sum(counts13e.values()) == launched_13e
            and drift13 < 1e-3 and bool(torch.isfinite(x13).all())
            and x_err13 <= tol13):
        fail(f"phase 13e off: {counts13e} launches ({by13e}), energy drift "
             f"{drift13}, |x - simulate's x| {x_err13} (tolerance {tol13})")
    print(json.dumps({
        "phase": f"13e ring_simulate Plummer N=16384 dt=5e-4 eps=0.05 "
                 f"{n_ring} steps one-rank NCCL group",
        "launches": launched_13e, "launches_by": by13e,
        "max_rel_energy_drift": drift13,
        "max_abs_x_err_vs_simulate": x_err13, "x_tolerance": tol13,
        "steps_per_s": n_ring / sec13e, "steps_per_s_phase_6": steps_per_s_6,
        "card": card}))

    # ---- 14. this slice: kernel A's bf16 trajectory, every example model ---
    clock.start("14. this slice: kernel A's bf16 trajectory, every example model")
    # 14a: kernel A with trajectory_dtype=bfloat16, the TPU kernel's option
    # (pallas_kernels.py:900). Held against its plain version at the bench
    # shape and at a D off the 16-byte path: kernel and plain version round
    # the same operations of the chain once each and draw the same momenta,
    # so q' and g' of every walker whose decision agrees must be the plain
    # version's bits; the energies and the acceptance are held to
    # compare()'s tolerance (float32 sums in another order). Timed beside
    # the float32 launch on the same input. Then the driven path: the TPU
    # kernel's statistics test (tests/test_pallas.py, TPU-only there), 100
    # transitions at W=16384, D=32, L=16, step 0.6 from a standard normal
    # start, with its gates: mean |dE| < 2 and acceptance in (0.3, 1] over
    # the last 50, the mean 0 +- 0.02, the variance 1 +- 3%.
    gen14 = torch.Generator(device="cpu").manual_seed(SEED + 14)

    def randn14(*shape):
        return torch.randn(*shape, generator=gen14).to(dev)

    a_bf16 = check_a("A bf16 trajectory std_normal W=102400 D=32 L=16",
                     102400, 32, 16, 0.3, False, True,
                     trajectory_dtype=torch.bfloat16, q=randn14(102400, 32))
    a_bf16_errs = [a_bf16["max_abs_err"], check_a(
        "A bf16 trajectory random metric W=1000 D=33 L=16 (scalar path)",
        1000, 33, 16, 0.2, True, False, trajectory_dtype=torch.bfloat16,
        q=randn14(1000, 33))["max_abs_err"]]
    w14a, d14a, n14a = 16384, 32, 100
    one14 = torch.ones(d14a, device=dev)
    kw14a = dict(scalars=scalars(0.6), p_std=one14, inv_mass=one14,
                 k_diag=one14, mean=0.0 * one14, num_steps=16,
                 trajectory_dtype=torch.bfloat16)
    q14 = torch.randn(w14a, d14a, generator=seeded(14), device=dev)
    accs14, errs14 = [], []
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(n14a):
        q14, _, _, acc14, _, derr14 = kernels.fused_hmc_diag_quadratic(
            SEED + 14, t, q14, **kw14a)
        accs14.append(acc14.mean())
        errs14.append(derr14.abs().mean())
    torch.cuda.synchronize()
    sec14a = time.perf_counter() - t0
    counts14a = kernels.launch_counts()
    launched_a_bf16 = kernels.fused_hmc_diag_quadratic.launches_by[
        "bfloat16"]
    mean_de = torch.stack(errs14[50:]).mean().item()
    accept14a = torch.stack(accs14[50:]).mean().item()
    mean14a, var14a = q14.mean().item(), q14.var().item()
    var_dims14a = q14.var(0).mean().item()
    if not (launched_a_bf16 == n14a and sum(counts14a.values()) == n14a
            and mean_de < 2.0 and 0.3 < accept14a <= 1.0
            and abs(mean14a) < 0.02 and abs(var14a - 1.0) < 0.03
            and abs(var_dims14a - 1.0) < 0.03):
        fail(f"phase 14a off: {launched_a_bf16} bf16 launches ({counts14a}),"
             f" mean |dE| {mean_de} (< 2), accept {accept14a} ((0.3, 1]), "
             f"mean {mean14a} (0 +- 0.02), var {var14a} and per dim "
             f"{var_dims14a} (1 +- 3%)")
    print(json.dumps({
        "phase": f"14a kernel A trajectory_dtype=bfloat16 W={w14a} "
                 f"D={d14a} L=16 step 0.6, {n14a} transitions",
        "launches": launched_a_bf16, "mean_abs_energy_error": mean_de,
        "accept_rate": accept14a, "mean": mean14a, "var": var14a,
        "mean_var_per_dim": var_dims14a,
        "ms_per_transition": 1e3 * sec14a / n14a,
        "kernel_ms_bf16": a_bf16["ms"],
        "kernel_ms_float32_same_input": a_bf16["float32_ms"],
        "bound_ms": a_bf16["bound_ms"], "card": card}))

    # 14c: ChEES through the command-line driver's entry (main.run), on
    # every example model that phase 8 did not run, at the bench width:
    # both phases must run in kernel B (456 launches: 200 with the
    # proposal, 256 without). Moments against closed forms where they
    # exist (the coins' logit-Beta posteriors: mean digamma(a) -
    # digamma(b), variance trigamma(a) + trigamma(b); the decentred funnel:
    # v ~ N(0, 9), x_decentered ~ N(0, 1)) within six standard errors of a
    # 102400-walker mean as phase 7 (0.02 sd, 0.03); elsewhere against a
    # composed run within phase 8's four standard errors of its 8192
    # walkers (0.044 sd, 0.0625): linear regression against its own, the
    # centred eight schools under reparam="auto" against phase 8b's (the
    # non-centred model: the same potential of the same q). The centred
    # eight schools and the centred funnel are pathological for HMC: their
    # gates are finite moments, at most 30% divergent transitions (a
    # composed run at W=1024 on the CPU diverged in 13% and 2%; a faulty
    # form makes most transitions divergent or NaN) and the kernel-plain
    # checks of 14b; their moments are printed.
    x_lin, y_lin = models.linear_regression_data(256, 30)
    coin_raw = json.loads((ROOT / "examples" / "coin_toss.data.json")
                          .read_text())
    coin_np = {k: np.asarray(coin_raw[k], np.float32) for k in ("c1", "c2")}
    es_data = ROOT / "examples" / "eight_schools.data.json"
    mp_lin = models.make_model_potential(models.linear_regression,
                                         (x_lin, y_lin), {})
    cases14 = {
        # label: (model, data, reparam, init step, potential, reference)
        "linear_regression": ("linear_regression", "linear", "", 0.02,
                              mp_lin, "composed"),
        "eight_schools": ("eight_schools", es_data, "", 0.1,
                          models.make_model_potential(
                              models.eight_schools, (),
                              models.EIGHT_SCHOOLS_DATA),
                          "pathological"),
        "eight_schools reparam=auto": (
            "eight_schools", es_data, "auto", 0.22,
            models.make_model_potential(models.eight_schools, (),
                                        models.EIGHT_SCHOOLS_DATA,
                                        reparam="auto"), ref8b),
        "coin_toss": ("coin_toss", ROOT / "examples" / "coin_toss.data.json",
                      "", 0.5, models.make_model_potential(
                          models.coin_toss, (), coin_np), "closed"),
        "funnel": ("funnel", None, "", 0.1,
                   models.make_model_potential(models.funnel, (), {}),
                   "pathological"),
        "funnel reparam=auto": ("funnel", None, "auto", 0.5,
                                models.make_model_potential(
                                    models.funnel, (), {}, reparam="auto"),
                                "closed"),
    }

    # the forms that run one walker a thread: the two eight-schools forms and
    # the funnel model's (every launch of these must be in that layout)
    thread14 = ("eight_schools", "eight_schools reparam=auto", "funnel")

    def layout14(label, kernel):
        mp_ = cases14[label][4]
        chosen = kernels.form_layout(mp_.potential.device_form, mp_.num_dims,
                                     kernel)
        if (chosen == "thread") != (label in thread14):
            fail(f"phase 14: {label} takes the {chosen} layout in kernel "
                 f"{kernel}")
        return chosen

    def closed_form(label, nd):
        if label == "coin_toss":
            a = torch.tensor([coin_np[k].sum() + 1.0 for k in ("c1", "c2")],
                             dtype=torch.float64, device=dev)
            b = torch.tensor([(1.0 - coin_np[k]).sum() + 1.0
                              for k in ("c1", "c2")], dtype=torch.float64,
                             device=dev)
            return (torch.special.digamma(a) - torch.special.digamma(b),
                    torch.special.polygamma(1, a)
                    + torch.special.polygamma(1, b))
        var = torch.ones(nd, dtype=torch.float64, device=dev)
        var[0] = 9.0
        return torch.zeros(nd, dtype=torch.float64, device=dev), var

    summaries14, launched14 = {}, {}
    with tempfile.TemporaryDirectory(prefix="pbbi_models_") as tmp14:
        lin_json = Path(tmp14) / "linear.json"
        lin_json.write_text(json.dumps({"x": x_lin.tolist(),
                                        "y": y_lin.tolist()}))
        for label, (name, data, rep, init_step, mp14, ref) in \
                cases14.items():
            cfg = RunConfig(
                model=f"example:{name}", sampler="chees", num_walkers=w,
                num_warmup=n_warm8, num_samples=n_samp8,
                init_step_size=init_step, collect="moments", reparam=rep,
                seed=SEED + 14,
                data_path=(str(lin_json) if data == "linear"
                           else None if data is None else str(data)))
            kernels.reset_launch_counts()
            s14, _ = cli_run(cfg)
            counts = kernels.launch_counts()
            by = dict(kernels.fused_hmc_transition.launches_by)
            by_layout = dict(kernels.fused_hmc_transition.launches_by_layout)
            launched14[label] = counts["fused_hmc_transition"]
            mean = torch.tensor(s14["posterior_mean"], device=dev,
                                dtype=torch.float64)
            var = torch.tensor(s14["posterior_var"], device=dev,
                               dtype=torch.float64)
            gates = {}
            if ref == "composed":
                ref = run_chees_hmc(
                    SEED + 15, mp14.potential, mp14.init(SEED, 8192),
                    num_warmup=n_warm8, num_samples=n_samp8,
                    init_step_size=init_step, collect="moments",
                    kernel="composed")
                if ref.kernel_used != "composed":
                    fail(f"phase 14c {label}: the reference ran "
                         f"{ref.kernel_used}")
            if ref == "closed":
                want_mean, want_var = closed_form(label, mean.shape[0])
                limits = (0.02, 0.03)
            elif ref != "pathological":
                want_mean, want_var = ref.mean.double(), ref.var.double()
                limits = (0.044, 0.0625)
            else:
                want_mean = None
            accept, div = s14["accept_rate"], s14["divergence_rate"]
            ok = ((s14["kernel_used"], s14["warmup_kernel_used"])
                  == ("fused", "fused")
                  and launched14[label] == n_warm8 + n_samp8
                  and by["counted"] == n_samp8
                  and by["counted+proposal"] == n_warm8
                  and by_layout[layout14(label, "B")] == launched14[label]
                  and sum(counts.values()) == launched14[label]
                  and bool(torch.isfinite(mean).all())
                  and bool(torch.isfinite(var).all()))
            if want_mean is not None:
                gates["max_mean_err_sd"] = (
                    (mean - want_mean) / want_var.sqrt()).abs().max().item()
                gates["max_rel_var_err"] = (
                    var / want_var - 1.0).abs().max().item()
                ok = ok and (gates["max_mean_err_sd"] < limits[0]
                             and gates["max_rel_var_err"] < limits[1]
                             and 0.6 <= accept <= 0.99 and div <= 0.01)
            else:
                ok = ok and div <= 0.3 and 0.5 <= accept <= 0.99
            if not ok:
                fail(f"phase 14c {label} off: {s14['warmup_kernel_used']}/"
                     f"{s14['kernel_used']}, launches {counts} ({by}, "
                     f"{by_layout}), "
                     f"accept {accept}, divergence rate {div}, {gates}, "
                     f"mean {s14['posterior_mean']}")
            summaries14[label] = s14
            print(json.dumps({
                "phase": f"14c CLI chees example:{name}"
                         + (f" reparam={rep}" if rep else "")
                         + f" W={w} warmup={n_warm8} samples={n_samp8}",
                "form": mp14.potential.device_form[0],
                "kernel_used": s14["kernel_used"],
                "warmup_kernel_used": s14["warmup_kernel_used"],
                "launches": launched14[label], "launches_by": by,
                "launches_by_layout": by_layout,
                "against": ("closed form" if isinstance(ref, str)
                            and ref == "closed" else "none (pathological)"
                            if isinstance(ref, str) else "composed W=8192"),
                **gates, "accept_rate": accept, "divergence_rate": div,
                "step_size": s14["step_size"],
                "trajectory_time": s14["trajectory_time"],
                "mean_num_steps": s14["mean_num_steps"],
                "run_ms_per_transition": 1e3 * s14["wall_seconds"]
                / (n_warm8 + n_samp8),
                "posterior_mean": s14["posterior_mean"],
                "posterior_var": s14["posterior_var"],
                "wall_seconds_of_run": s14["wall_seconds"]}))

    # 14d: kernel D on each new form as a user reaches it,
    # run_hmc(integrator="pallas_leapfrog"), from states near the posterior
    # under their variance as the metric and half the 14c run's step: one
    # launch a transition, finite moments. The states: the non-centred
    # eight schools (the form of the centred model under "auto") phase
    # 8b's posterior state; the two centred models the last state of a
    # ChEES run of their own (200 + 64 transitions), since their chains
    # keep out of the neck that independent draws (and the exact
    # posterior) reach, where energies far above the chain's round past
    # compare()'s tolerance and two steps can overflow; the others draws
    # from their 14c moments, each clipped to 2 sd.
    q8b = res8b.state.ensemble.q

    def near_posterior(label, nd):
        s14 = summaries14[label]
        mean = torch.tensor(s14["posterior_mean"], device=dev)
        sd = torch.tensor(s14["posterior_var"], device=dev).sqrt()
        z = randn14(w, nd).clamp(-2.0, 2.0)
        if label == "eight_schools reparam=auto":
            q = q8b.clone()
        elif label in ("eight_schools", "funnel"):  # the chain's own states
            mp_ = cases14[label][4]
            q = run_chees_hmc(SEED + 17, mp_.potential, mp_.init(SEED, w),
                              num_warmup=n_warm8, num_samples=64,
                              init_step_size=cases14[label][3],
                              collect="none").state.ensemble.q
        else:
            q = mean + sd * z
        return q.contiguous(), q.var(0)

    new_forms14 = ("linear_regression", "eight_schools", "coin_toss",
                   "funnel", "funnel reparam=auto")
    states14, launched14d = {}, {}
    for label in new_forms14:
        mp14 = cases14[label][4]
        q14, var14 = near_posterior(label, mp14.num_dims)
        step14 = 0.5 * summaries14[label]["step_size"]
        states14[label] = (q14, var14, step14)
        kernels.reset_launch_counts()
        res14 = run_hmc(SEED + 16, mp14.potential, q14, num_warmup=20,
                        num_samples=20, num_steps=steps,
                        init_step_size=step14, collect="moments",
                        integrator="pallas_leapfrog")
        counts = kernels.launch_counts()
        launched14d[label] = counts["leapfrog_trajectory"]
        by_layout = dict(kernels.leapfrog_trajectory.launches_by_layout)
        if not (res14.kernel_used == "composed"
                and launched14d[label] == 40
                and by_layout[layout14(label, "D")] == 40
                and sum(counts.values()) == 40
                and bool(torch.isfinite(res14.mean).all())):
            fail(f"phase 14d {label} off: {res14.kernel_used}, launches "
                 f"{counts} ({by_layout}), mean {res14.mean}")
        print(json.dumps({
            "phase": f"14d run_hmc integrator=pallas_leapfrog {label} "
                     f"W={w} L={steps} 20 + 20 from 14c's posterior",
            "form": mp14.potential.device_form[0],
            "launches": launched14d[label], "launches_by_layout": by_layout,
            "accept_rate": res14.accept_rate.item(),
            "ms_per_transition": 1e3 * res14.sampling_seconds / 20}))

    # 14b: each new form in kernels B and D against its plain version at
    # the bench width, on the states of 14d under their metric (the mass
    # the inverse of the posterior variance) and half 14c's step, timed
    # with CUDA graphs at L=16; B also with the count on the device and the
    # proposal at W=8192 (n=40 clipped to 16). The linear form's outputs,
    # the coin's and the diagonal form's must be the plain version's bits,
    # as the logistic form's. The two centred models are compared over 2 steps (n=5
    # clipped to 2), timed at 16: in their necks a float32 trajectory
    # amplifies a last-bit difference between kernel and plain version
    # past compare()'s tolerance within 16 steps (the centred eight
    # schools' energy error by 7.3e-4 on an H100 80GB HBM3), which says
    # nothing of the form's arithmetic.
    x_lin_dev, y_lin_dev, c_lin = mp_lin.potential.device_form[1]

    def linear_library(q, steps_):
        """What one PyTorch call per product makes of the linear form's
        gradients over a transition: two torch.matmul and the elementwise
        residual terms for each of its steps + 1 gradients."""
        for _ in range(steps_ + 1):
            s_ = q[:, -1:]
            resid = q[:, :-2] @ x_lin_dev.T + q[:, -2:-1] - y_lin_dev
            e = resid * torch.exp(-2.0 * s_)
            grad = torch.cat([q[:, :-2] * c_lin[0] + e @ x_lin_dev,
                              q[:, -2:-1] * c_lin[0] + e.sum(1, keepdim=True),
                              torch.exp(2.0 * s_) - 1.0 + y_lin_dev.shape[0]
                              - torch.exp(-2.0 * s_)
                              * (resid * resid).sum(1, keepdim=True)], 1)
        return grad

    b14, d14, errs14b = {}, {}, {}
    for label in new_forms14 + ("eight_schools reparam=auto",):
        mp14 = cases14[label][4]
        form14 = mp14.potential.device_form
        nd = mp14.num_dims
        if label in states14:
            q14, var14, step14 = states14[label]
        else:
            q14, var14 = near_posterior(label, nd)
            step14 = 0.5 * summaries14[label]["step_size"]
        lin = form14[0] == "linear"
        # the linear, coin and diagonal forms: the plain version's bits
        exact = lin or form14[0] in ("coin", "diag_model")
        threads = {k: kernels.form_layout(form14, nd, k) == "thread"
                   for k in ("B", "D")}
        short = label in ("eight_schools", "funnel")
        tag = f"(tile {kernels.logistic_tile(w, 256, nd)})" if lin else ""
        tag += " (compared over 2 steps)" if short else ""
        b14[label] = check_b8(
            f"B {form14[0]} ({label}) W={w} D={nd} L=16 {tag}".strip(),
            form14, q14, 16, step14, True, mass=1.0 / var14, bits=exact,
            library=linear_library if lin else None,
            check_steps=2 if short else None, layouts=threads["B"],
            **(dict(plain_timing=slow) if lin else dict(plain_reps=2)))
        n_max = (5, 2) if short else (40, 16)
        errs14b[label] = [b14[label]["max_abs_err"], check_b8(
            f"B {form14[0]} ({label}) counted+proposal W=8192 D={nd} "
            f"n={n_max[0]} max={n_max[1]}", form14, q14[:8192].contiguous(),
            n_max[0], step14, False, counted=n_max[1], proposal=True,
            mass=1.0 / var14, bits=exact,
            layouts=threads["B"])["max_abs_err"]]
        if label in new_forms14:
            d14[label] = check_d(
                f"D {form14[0]} ({label}) W={w} D={nd} L=16 {tag}".strip(),
                form14, w, nd, 16, step14, var14.contiguous(),
                q=q14, p=randn14(w, nd) / var14.sqrt(),
                library=linear_library if lin else None, bits=exact,
                check_steps=2 if short else None, layouts=threads["D"],
                plain_timing=slow if lin else dict(reps=2, rounds=3))

    # ---- 15. every sampler over the walker group of phase 13 -----------------
    clock.start('15. every sampler over the walker group of phase 13')
    # The one-rank NCCL group of phase 13, at full width. A group of one
    # reduces in one order and a fused step at walker offset 0 draws the
    # whole launch's bits, so 15a-15c and 15e's runs must be the unsharded
    # phases' bits; 15d's dense step folds the rank into its seed, so it is
    # another draw, held to 12g's gates. Each sub-phase prints its ms a
    # transition beside the unsharded phase's (host clock around
    # synchronised runs), its collectives and host copies a transition
    # (from three short runs, whose differences are the transitions) and
    # its launches.
    def per_transition(run, short=((4, 2), (8, 2), (4, 6))):
        """Collectives and host copies a warmup and a sampling transition
        of ``run(num_warmup, num_samples)``, from three short runs."""
        got = {}
        for n_w, n_s in short:
            calls = profiled_with_copies(lambda: run(n_w, n_s))
            got[n_w, n_s] = (census(calls), calls["host_copies"],
                             collectives(calls))
        (a_w, a_s), (b_w, _), (_, c_s) = short
        out = {}
        for i, what in enumerate(("collectives", "host_copies")):
            out[f"{what}_per_warmup_transition"] = (
                got[b_w, a_s][i] - got[a_w, a_s][i]) / (b_w - a_w)
            out[f"{what}_per_sampling_transition"] = (
                got[a_w, c_s][i] - got[a_w, a_s][i]) / (c_s - a_s)
        out["collectives_by_name_short_run"] = got[short[0]][2]
        return out

    def same(a, b):
        return bool(torch.equal(a, b))

    # 15a: ChEES on 8a's logistic regression, both phases in kernel B
    kw15a = dict(num_warmup=n_warm8, num_samples=n_samp8,
                 max_steps=max_steps8, init_step_size=0.05,
                 collect="moments")
    q15a = 0.3 * torch.randn(w, 32, generator=seeded(0), device=dev)
    kernels.reset_launch_counts()
    res15a, wall15a = timed(lambda: run_chees_hmc(
        SEED + 8, mp_lr.potential, q15a, kernel="auto", mesh=mesh, **kw15a))
    launched_15a = kernels.launch_counts()["fused_hmc_transition"]
    by15a = dict(kernels.fused_hmc_transition.launches_by)
    layout15a = dict(kernels.fused_hmc_transition.launches_by_layout)
    bits15a = all(same(a, b) for a, b in (
        (res15a.state.ensemble.q, res8a.state.ensemble.q),
        (res15a.mean, res8a.mean), (res15a.var, res8a.var),
        (res15a.step_size, res8a.step_size),
        (res15a.trajectory_time, res8a.trajectory_time)))
    coll15a = per_transition(lambda n_w, n_s: run_chees_hmc(
        SEED + 8, mp_lr.potential, q15a, kernel="auto", mesh=mesh,
        **dict(kw15a, num_warmup=n_w, num_samples=n_s)))
    print(json.dumps({
        "phase": f"15a run_chees_hmc(mesh=) logistic regression N=256 W={w} "
                 f"D=32 warmup={n_warm8} samples={n_samp8} one-rank NCCL "
                 f"group",
        "kernel_used": [res15a.warmup_kernel_used, res15a.kernel_used],
        "launches": launched_15a, "launches_by": by15a,
        "launches_by_layout": layout15a, "same_bits_as_8a": bits15a,
        "sampling_ms": 1e3 * res15a.sampling_seconds / n_samp8,
        "sampling_ms_8a": 1e3 * res8a.sampling_seconds / n_samp8,
        "warmup_ms": 1e3 * res15a.warmup_seconds / n_warm8,
        "warmup_ms_8a": 1e3 * res8a.warmup_seconds / n_warm8,
        "wall_seconds": wall15a, **coll15a, "card": card}))
    if not (bits15a and launched_15a == n_warm8 + n_samp8
            and layout15a[kernels.form_layout(mp_lr.potential.device_form,
                                              32, "B")] == launched_15a
            and by15a["counted"] == n_samp8
            and by15a["counted+proposal"] == n_warm8
            and coll15a["collectives_per_warmup_transition"] == 2
            and coll15a["collectives_per_sampling_transition"] == 0
            and coll15a["host_copies_per_sampling_transition"] == 0):
        fail(f"phase 15a off: 8a's bits {bits15a}, launches {launched_15a} "
             f"({by15a}, {layout15a}), per transition {coll15a}")

    # 15b: parallel tempering on phase 10's mixture, a 1 x 1 replica mesh
    rm15 = par.make_replica_mesh(1)
    kw15b = dict(num_replicas=r10, beta_min=0.02, num_steps=10)
    kernels.reset_launch_counts()
    res15b, wall15b = timed(lambda: run_parallel_tempering(
        SEED + 14, bimodal, q10, num_warmup=n_warm10, num_samples=n_samp10,
        collect="samples", mesh=rm15, **kw15b))
    counts15b = kernels.launch_counts()
    launched_15b = counts15b["fused_hmc_transition"]
    layout15b = dict(kernels.fused_hmc_transition.launches_by_layout)
    right15 = (res15b.samples[:, :, 0] > 0).float().mean().item()
    bits15b = all(same(a, b) for a, b in (
        (res15b.samples, res10.samples), (res15b.q, res10.q),
        (res15b.accept_rate, res10.accept_rate),
        (res15b.swap_rate, res10.swap_rate),
        (res15b.step_sizes, res10.step_sizes)))
    coll15b = per_transition(lambda n_w, n_s: run_parallel_tempering(
        SEED + 14, bimodal, q10, num_warmup=n_w, num_samples=n_s,
        collect="moments", mesh=rm15, **kw15b))
    print(json.dumps({
        "phase": f"15b run_parallel_tempering(mesh=) 1 x 1 replica mesh, "
                 f"phase 10's mixture R={r10} W={w10}",
        "kernel_used": res15b.kernel_used, "launches": launched_15b,
        "launches_by_layout": layout15b,
        "same_bits_as_phase_10": bits15b, "right_mode_share": right15,
        "right_mode_share_10": right,
        "ms_per_transition": 1e3 * wall15b / (n_warm10 + n_samp10),
        "ms_per_transition_10": 1e3 * seconds10 / (n_warm10 + n_samp10),
        "sampling_ms": 1e3 * res15b.sampling_seconds / n_samp10,
        "sampling_ms_10": 1e3 * res10.sampling_seconds / n_samp10,
        **coll15b, "card": card}))
    if not (bits15b and launched_15b == n_warm10 + n_samp10
            and layout15b["thread"] == launched_15b
            and sum(counts15b.values()) == launched_15b
            and coll15b["collectives_per_warmup_transition"] == 1
            and coll15b["collectives_per_sampling_transition"] == 0
            and coll15b["host_copies_per_sampling_transition"] == 0):
        fail(f"phase 15b off: phase 10's bits {bits15b}, launches "
             f"{counts15b} ({layout15b}), right-mode share {right15}, per "
             f"transition "
             f"{coll15b}")

    # 15c: lockstep NUTS at phase 11's configuration
    kernels.reset_launch_counts()
    reads = nuts._host_read.reads
    res15c, wall15c = timed(lambda: run_nuts(
        SEED + 15, target11, q11, num_warmup=n_warm11,
        num_samples=n_samp11, max_depth=8, mesh=mesh))
    reads15c = (nuts._host_read.reads - reads) / (n_warm11 + n_samp11)
    bits15c = all(same(a, b) for a, b in (
        (res15c.samples, res11.samples), (res15c.step_size, res11.step_size),
        (res15c.accept_rate, res11.accept_rate),
        (res15c.mean_depth, res11.mean_depth)))
    coll15c = per_transition(lambda n_w, n_s: run_nuts(
        SEED + 15, target11, q11, num_warmup=n_w, num_samples=n_s,
        max_depth=8, collect="none", mesh=mesh),
        short=((2, 1), (4, 1), (2, 3)))
    print(json.dumps({
        "phase": f"15c run_nuts(mesh=) phase 11's Gaussian W={w11} "
                 f"max_depth=8 one-rank NCCL group",
        "launches": sum(kernels.launch_counts().values()),
        "same_bits_as_phase_11": bits15c,
        "host_reads_per_transition": reads15c,
        "host_reads_per_transition_11": reads11,
        "sampling_ms": 1e3 * res15c.sampling_seconds / n_samp11,
        "sampling_ms_11": 1e3 * res11.sampling_seconds / n_samp11,
        "ms_per_transition": 1e3 * wall15c / (n_warm11 + n_samp11),
        "ms_per_transition_11": 1e3 * seconds11 / (n_warm11 + n_samp11),
        **coll15c, "card": card}))
    if not (bits15c and sum(kernels.launch_counts().values()) == 0
            and reads15c == reads11
            and coll15c["collectives_per_warmup_transition"] == 1
            and coll15c["collectives_per_sampling_transition"] == 0):
        fail(f"phase 15c off: phase 11's bits {bits15c}, per transition "
             f"{coll15c}")

    # 15d: the dense metric at 12g's configuration (composed, no kernel;
    # the rank folded into the step's seed, so held to 12g's gates)
    q15d = torch.randn(w, d, generator=seeded(0), device=dev)
    kw15d = dict(num_steps=steps, collect="moments", metric="dense")
    kernels.reset_launch_counts()
    res15d, wall15d = timed(lambda: par.sharded_run_hmc(
        SEED + 3, pot.make_gaussian(mean7, cov=cov7), q15d, mesh=mesh,
        num_warmup=n_warm, num_samples=n_samp, **kw15d))
    mean_err = ((res15d.mean.cpu() - mean7) / sd7).abs().max().item()
    var_err = (res15d.var.cpu() / sd7**2 - 1.0).abs().max().item()
    cov_err = (torch.linalg.norm(res15d.metric_cov.cpu() - cov7)
               / torch.linalg.norm(cov7)).item()
    accept = res15d.accept_rate.item()
    coll15d = per_transition(lambda n_w, n_s: par.sharded_run_hmc(
        SEED + 3, pot.make_gaussian(mean7, cov=cov7), q15d, mesh=mesh,
        num_warmup=n_w, num_samples=n_s, **kw15d))
    print(json.dumps({
        "phase": f"15d sharded_run_hmc(metric=dense) 12g's Gaussian W={w} "
                 f"L={steps} one-rank NCCL group",
        "kernel_used": res15d.kernel_used,
        "launches": sum(kernels.launch_counts().values()),
        "max_mean_err_sd": mean_err, "max_rel_var_err": var_err,
        "metric_cov_rel_frobenius_err": cov_err, "accept_rate": accept,
        "sampling_ms": 1e3 * res15d.sampling_seconds / n_samp,
        "sampling_ms_12g": 1e3 * res12g.sampling_seconds / n_samp,
        "warmup_ms": 1e3 * (wall15d - res15d.sampling_seconds) / n_warm,
        **coll15d, "card": card}))
    if not (res15d.kernel_used == "dense"
            and sum(kernels.launch_counts().values()) == 0
            and mean_err < 0.02 and var_err < 0.03
            and cov_err < DENSE_COV_GATE and 0.6 <= accept <= 0.99
            and coll15d["collectives_per_warmup_transition"] == 1
            and coll15d["collectives_per_sampling_transition"] == 0):
        fail(f"phase 15d off: mean {mean_err} sd (limit 0.02), var "
             f"{var_err} (0.03), Sigma {cov_err} ({DENSE_COV_GATE}), accept "
             f"{accept}, per transition {coll15d}")

    # 15e: the CLI with sharded=True, in this process (main.run in the
    # group): SMC against 12d's summary, a checkpointed chees run stopped
    # after its first chunk and resumed against the uninterrupted run (and
    # 12c's unsharded one), stream mode against 12f's rows
    kernels.reset_launch_counts()
    s15_smc, _ = cli_run(RunConfig(
        model="builtin:std_normal_32d", sampler="smc", num_walkers=w,
        num_steps=10, smc_beta0=0.02, sharded=True))
    launched_15e_smc = kernels.launch_counts()["fused_hmc_diag_quadratic"]
    smc_ok = (s15_smc["log_evidence"] == s_d1["log_evidence"]
              and s15_smc["num_stages"] == s_d1["num_stages"]
              and launched_15e_smc == 3 * s_d1["num_stages"]
              and max(abs(a - b) for a, b in zip(
                  s15_smc["posterior_mean"], s_d1["posterior_mean"])) < 1e-5)
    with tempfile.TemporaryDirectory(prefix="pbbi_sharded_cli_") as tmp15:
        tmp15 = Path(tmp15)
        base = dict(model="example:eight_schools_noncentered",
                    data_path=str(ROOT / "examples" /
                                  "eight_schools.data.json"),
                    sampler="chees", num_walkers=w, num_warmup=n_warm8,
                    init_step_size=0.22, checkpoint_every=128, sharded=True)
        kernels.reset_launch_counts()
        (_, e15_first), sec15_first = timed(lambda: cli_run(RunConfig(
            num_samples=128, checkpoint_dir=str(tmp15 / "a"), **base)))
        s15_resumed, _ = cli_run(RunConfig(
            num_samples=n_samp8, checkpoint_dir=str(tmp15 / "a"), **base))
        launched_15e_es = kernels.launch_counts()["fused_hmc_transition"]
        s15_full, e15_full = cli_run(RunConfig(
            num_samples=n_samp8, checkpoint_dir=str(tmp15 / "b"), **base))
        files15 = sorted(p.name for p in (tmp15 / "b" / str(n_samp8)
                                          ).iterdir())
        ckpt_ok = (s15_resumed["resumed_from"] == 128
                   and all(s15_resumed[k] == s15_full[k] == s_cb[k]
                           for k in ("posterior_mean", "posterior_var",
                                     "step_size"))
                   and launched_15e_es == n_warm8 + n_samp8
                   and files15 == ["rank0-of1.pt"])
        out15 = tmp15 / "15e.pbbi"
        kernels.reset_launch_counts()
        s15_stream, _ = cli_run(RunConfig(
            model="builtin:std_normal_32d", num_walkers=8192, num_warmup=100,
            num_samples=64, num_steps=steps, thin=4, collect="stream",
            output_path=str(out15), sharded=True))
        launched_15e_stream = kernels.launch_counts()[
            "fused_hmc_diag_quadratic"]
        rows15 = np.asarray(native.read_samples(str(out15)))
        stream_ok = (np.array_equal(rows15, rows12f)
                     and launched_15e_stream == 100 + 64 * 4
                     and sorted(p.name for p in tmp15.iterdir()
                                if p.is_file()) == ["15e.pbbi"])
    saves15 = checkpoints(e15_full)
    # with two cards, 15a and 15e's SMC at K = 2 (chip_smoke.py
    # --sharded-rank-15 is a rank): SMC's log Z bit for bit K = 1's, the
    # adapted ChEES moments within 8a's gates of K = 1's
    k2_15 = None
    if torch.cuda.device_count() >= 2:
        with tempfile.TemporaryDirectory(prefix="pbbi_k2_") as tmp_k2:
            out_k2 = Path(tmp_k2) / "k2.pt"
            torchrun(2, ["chip_smoke.py", "--sharded-rank-15", str(out_k2)])
            k2 = torch.load(out_k2)
        mean_err = ((k2["mean"].to(dev) - res15a.mean)
                    / torch.sqrt(res15a.var)).abs().max().item()
        var_err = (k2["var"].to(dev) / res15a.var - 1.0).abs().max().item()
        k2_15 = {"smc_log_evidence_bitwise_K1":
                 k2["log_evidence"] == s15_smc["log_evidence"],
                 "chees_mean_err_sd_vs_K1": mean_err,
                 "chees_var_err_vs_K1": var_err,
                 "chees_sampling_ms": k2["sampling_ms"],
                 "chees_launches_rank_0": k2["launches"]}
        if not (k2_15["smc_log_evidence_bitwise_K1"] and mean_err < 0.044
                and var_err < 0.0625
                and k2["launches"] == n_warm8 + n_samp8):
            fail(f"phase 15 K=2 off: {k2_15}")
    print(json.dumps({
        "phase": f"15e CLI sharded=true in the one-rank NCCL group: smc "
                 f"std_normal_32d W={w} (12d), chees eight schools "
                 f"checkpointed every 128 resumed (12c), stream W=8192 (12f)",
        "smc_log_evidence_bitwise_12d": smc_ok,
        "smc_num_stages": s15_smc["num_stages"],
        "smc_launches": launched_15e_smc,
        "smc_ms_per_stage": 1e3 * s15_smc["wall_seconds"]
        / s15_smc["num_stages"],
        "chees_resumed_bitwise_uninterrupted_and_12c": ckpt_ok,
        "chees_launches_first_and_resumed": launched_15e_es,
        "chees_checkpoint_files": files15,
        "chees_first_chunk_seconds": sec15_first,
        "chees_save_ms": [c["save_ms"] for c in saves15],
        "chees_chunk_ms": [c["chunk_ms"] for c in saves15],
        "stream_rows_bitwise_12f": stream_ok,
        "stream_launches": launched_15e_stream,
        "stream_wall_seconds": s15_stream["wall_seconds"],
        "stream_wall_seconds_12f": s12f["wall_seconds"],
        "K2": k2_15 or "ran K=1 only: one CUDA device", "card": card}))
    if not (smc_ok and ckpt_ok and stream_ok):
        fail(f"phase 15e off: smc {smc_ok} ({s15_smc['log_evidence']} "
             f"against {s_d1['log_evidence']}, launches {launched_15e_smc}), "
             f"checkpointed chees {ckpt_ok}, stream {stream_ok}")

    # 15w: where a sharded warmup transition's host time goes: run_hmc and
    # sharded_run_hmc at the bench configuration, warmup only, at two
    # lengths (the difference is the transitions, the rest the set-up),
    # and the profiler's host table of the longer runs, by operator
    def warm_table(run):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            run()
            torch.cuda.synchronize()
        return {e.key: (e.count, e.self_cpu_time_total)
                for e in prof.key_averages()}

    std32w = pot.make_standard_normal(d)
    q15w = torch.randn(w, d, generator=seeded(0), device=dev)
    warm15 = {}
    for label, fn in (("run_hmc", lambda n: run_hmc(
            SEED, std32w, q15w, num_warmup=n, num_samples=0,
            num_steps=steps, collect="none")),
            ("sharded_run_hmc", lambda n: par.sharded_run_hmc(
                SEED, std32w, q15w, mesh=mesh, num_warmup=n, num_samples=0,
                num_steps=steps, collect="none"))):
        walls = {n: min(timed(lambda: fn(n))[1] for _ in range(3))
                 for n in (40, 200)}
        warm15[label] = {
            "ms_per_warmup_transition": 1e3 * (walls[200] - walls[40]) / 160,
            "setup_ms": 1e3 * (walls[40] - 40 * (walls[200] - walls[40])
                               / 160),
            "table": warm_table(lambda: fn(200))}
    diff = {}
    for key, (count, us) in warm15["sharded_run_hmc"]["table"].items():
        base_count, base_us = warm15["run_hmc"]["table"].get(key, (0, 0.0))
        diff[key] = (count - base_count, (us - base_us) / 200)
    top = sorted(diff.items(), key=lambda kv: -kv[1][1])[:12]
    print(json.dumps({
        "phase": f"15w warmup host time, sharded_run_hmc against run_hmc, "
                 f"bench configuration W={w}, 200 warmup transitions",
        **{label: {k: v for k, v in got.items() if k != "table"}
           for label, got in warm15.items()},
        "extra_host_us_per_transition_by_op": {
            k: {"calls": c, "self_cpu_us": round(us, 2)}
            for k, (c, us) in top},
        "card": card}))
    dist.destroy_process_group()

    def entry(name, source, replaces, launches, errs, main):
        # a form run one walker a thread is that file's kernel
        if main.get("layout") == "thread":
            source = f"{CSRC}/thread_layout.cu"
        return {"name": name, "case": main["case"], "route": "cuda",
                "source": source,
                "replaces": f"{TPU_KERNELS}:{replaces}",
                "launches": launches, "max_abs_err": max(errs),
                **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}}

    clock.start(None)
    print(json.dumps({"kernels": [
        entry("fused_hmc_diag_quadratic", SOURCE, 893, launched_a, a_errs,
              a_main),
        entry("fused_hmc_transition", SOURCE, 373, launched_b, b_errs,
              b_gauss10),
        # the funnel at W=8192, D=10 (one walker a thread), which no driven
        # path runs
        entry("fused_hmc_transition", f"{CSRC}/forms.cuh", 373, 0, b_errs,
              b_main),
        entry("fused_hmc_transition", SOURCE, 576, launched_c, c_errs,
              c_main),
        entry("leapfrog_trajectory", f"{CSRC}/leapfrog.cu", 140, launched_d,
              d_errs, d_main),
        # the diagonal form (form 5) in kernel B, which no driven path runs
        # (the funnel model's form 12 is 14b's row)
        entry("fused_hmc_transition", f"{CSRC}/forms.cuh", 373, 0,
              [diag_rows[k]["max_abs_err"] for k in ("B diag",
                                                     "B diag_model")],
              diag_rows["B diag"]),
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
        # the same at W=101376 (3 whole waves of the lane groups' blocks),
        # which no driven path runs
        entry("fused_hmc_transition", f"{CSRC}/forms.cuh", 576, 0, lr_errs,
              lr_tail),
        entry("fused_hmc_transition", f"{CSRC}/forms.cuh", 576, launched_es,
              es_errs, es_main),
        # the logistic form in kernel D (phase 8e), and the eight-schools
        # form, one walker a thread (8f)
        entry("leapfrog_trajectory", f"{CSRC}/forms.cuh", 140,
              launched_d_lr, [d_lr["max_abs_err"]], d_lr),
        entry("leapfrog_trajectory", f"{CSRC}/forms.cuh", 140,
              launched_d_es, [d_es["max_abs_err"]], d_es),
        # the tempered samplers: kernel A at SMC's stage beta (9a), kernel
        # B's N-body form at it (9b), and its mixture form at a tempering
        # rung's beta (10; the TPU ran the 2-D replicas walker-packed)
        entry("fused_hmc_diag_quadratic", SOURCE, 893, launched_9a,
              [a_scaled["max_abs_err"]], a_scaled),
        entry("fused_hmc_transition", f"{CSRC}/forms.cuh", 373, launched_9b,
              [b_nbody["max_abs_err"], b_nbody8k["max_abs_err"]], b_nbody),
        # the N-body form in kernel D (9c)
        entry("leapfrog_trajectory", f"{CSRC}/forms.cuh", 140, launched_9c,
              [d_nbody["max_abs_err"]], d_nbody),
        # the launch of one rung at a rung's beta, which no driven path
        # makes since PT's rungs are one launch, and phase 2's mixture in B
        # and D, which no driven path runs
        entry("fused_hmc_transition", f"{CSRC}/forms.cuh", 576, 0,
              [b_mixture["max_abs_err"]], b_mixture),
        entry("fused_hmc_transition", f"{CSRC}/forms.cuh", 576, 0,
              [c_mix["max_abs_err"]], c_mix),
        entry("leapfrog_trajectory", f"{CSRC}/forms.cuh", 140, 0,
              [d_mix["max_abs_err"]], d_mix),
        # PT's rungs in one launch: B's mixture form (10), A (10b), B one
        # walker a thread (10c)
        entry("fused_hmc_transition", SOURCE, 576, launched_10,
              [b_rungs["max_abs_err"]], b_rungs),
        entry("fused_hmc_diag_quadratic", SOURCE, 893, launched_10b,
              [a_rungs["max_abs_err"]], a_rungs),
        entry("fused_hmc_transition", SOURCE, 373, launched_10c,
              [b_thread_rungs["max_abs_err"]], b_thread_rungs),
        # the command-line driver: kernel A under its hmc (12a) and its SMC
        # mutations at the stage beta (12d), kernel B's model forms under
        # its chees (12c) and B's mixture form under its pt (12e)
        entry("fused_hmc_diag_quadratic", SOURCE, 893, launched_12a,
              [a_main["max_abs_err"]], a_main),
        entry("fused_hmc_diag_quadratic", SOURCE, 893, launched_12d,
              [a_scaled["max_abs_err"]], a_scaled),
        entry("fused_hmc_transition", f"{CSRC}/forms.cuh", 576,
              launched_12c["logistic_regression"], lr_errs, lr_main),
        entry("fused_hmc_transition", f"{CSRC}/forms.cuh", 576,
              launched_12c["eight_schools_noncentered"], es_errs, es_main),
        entry("fused_hmc_transition", SOURCE, 576, launched_12e,
              [b_rungs["max_abs_err"]], b_rungs),
        # the sharded paths: kernels A and B with a walker offset (13b's
        # runs, and 13d's for A), kernel E's source-block form (13e's ring)
        entry("fused_hmc_diag_quadratic", SOURCE, 893,
              launched_13b_a + launched_13d, [a_off["max_abs_err"]], a_off),
        entry("fused_hmc_transition", SOURCE, 373, launched_13b_b,
              [b_off["max_abs_err"]], b_off),
        entry("nbody_accelerations_tiled", f"{CSRC}/nbody.cu", 252,
              launched_13e, [e_src["max_abs_err"]], e_src),
        # this slice: kernel A's bf16 trajectory (14a's chain), each example
        # model's form in kernel B (14c's ChEES runs; the linear form is a
        # data-matmul potential, the TPU's kernel C route) and in kernel D
        # (14d)
        entry("fused_hmc_diag_quadratic", SOURCE, 900, launched_a_bf16,
              a_bf16_errs, a_bf16),
        *[entry("fused_hmc_transition", f"{CSRC}/forms.cuh",
                576 if label == "linear_regression" else 373,
                launched14[label], errs14b[label], b14[label])
          for label in b14],
        *[entry("leapfrog_trajectory", f"{CSRC}/forms.cuh", 140,
                launched14d[label], [d14[label]["max_abs_err"]], d14[label])
          for label in d14],
        # every sampler over the walker group (phase 15): kernel B's
        # logistic form under sharded ChEES (15a), its mixture form under
        # sharded PT (15b), and the sharded CLI's kernel A in SMC at the
        # stage beta and in stream mode, and B's eight-schools form in its
        # checkpointed chees (15e)
        entry("fused_hmc_transition", f"{CSRC}/forms.cuh", 576, launched_15a,
              lr_errs, lr_main),
        entry("fused_hmc_transition", SOURCE, 576, launched_15b,
              [b_rungs["max_abs_err"]], b_rungs),
        entry("fused_hmc_diag_quadratic", SOURCE, 893, launched_15e_smc,
              [a_scaled["max_abs_err"]], a_scaled),
        entry("fused_hmc_diag_quadratic", SOURCE, 893, launched_15e_stream,
              [a_main["max_abs_err"]], a_main),
        entry("fused_hmc_transition", f"{CSRC}/forms.cuh", 576,
              launched_15e_es, es_errs, es_main),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


def sharded_rank(out_path: str, step_size: float) -> None:
    """One rank of phase 13b at K = 2, started by torchrun from phase 13
    where the machine has two cards: the fixed-step run and the bench run
    of 13b, rank 0 saving the gathered positions and the moments to
    ``out_path``."""
    import torch.distributed as dist
    from physicsbasedbayesianinference_tpu_torch import parallel as par
    from physicsbasedbayesianinference_tpu_torch.ops import potentials as pot
    par.initialize_distributed()
    mesh = par.make_walker_mesh()
    w, d, steps = 102400, 32, 16
    q0 = torch.randn(w, d, device=mesh.device, generator=torch.Generator(
        device=mesh.device).manual_seed(0))
    fn = pot.make_standard_normal(d)
    fixed = par.sharded_run_hmc(SEED, fn, q0, mesh=mesh, num_warmup=0,
                                num_samples=32, num_steps=steps,
                                init_step_size=step_size, collect="none")
    q_fixed = par.gather_walkers(fixed.state.ensemble.q, mesh, dst=0)
    res = par.sharded_run_hmc(SEED, fn, q0, mesh=mesh, num_warmup=200,
                              num_samples=256, num_steps=steps,
                              collect="moments")
    if mesh.rank == 0:
        torch.save({"q_fixed": q_fixed.cpu(), "mean": res.mean.cpu(),
                    "var": res.var.cpu(), "step_size": res.step_size.cpu()},
                   out_path)
    dist.destroy_process_group()


def sharded_rank_15(out_path: str) -> None:
    """One rank of phase 15's K = 2 runs, started by torchrun where the
    machine has two cards: 15a's ChEES on logistic regression and 15e's
    SMC through the command-line driver, rank 0 saving what phase 15
    compares to ``out_path``."""
    import torch.distributed as dist
    from physicsbasedbayesianinference_tpu_torch import main as cli
    from physicsbasedbayesianinference_tpu_torch import models
    from physicsbasedbayesianinference_tpu_torch import parallel as par
    from physicsbasedbayesianinference_tpu_torch.chees import run_chees_hmc
    from physicsbasedbayesianinference_tpu_torch.config import RunConfig
    from physicsbasedbayesianinference_tpu_torch.ops import kernels
    par.initialize_distributed()
    mesh = par.make_walker_mesh()
    dev = mesh.device
    x_lr, y_lr = models.logistic_regression_data(256, 31)
    mp = models.make_model_potential(models.logistic_regression,
                                     (x_lr, y_lr), {})
    q0 = 0.3 * torch.randn(102400, 32, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    kernels.reset_launch_counts()
    res = run_chees_hmc(SEED + 8, mp.potential, q0, kernel="auto",
                        mesh=mesh, num_warmup=200, num_samples=256,
                        max_steps=256, init_step_size=0.05,
                        collect="moments")
    launches = kernels.launch_counts()["fused_hmc_transition"]
    with contextlib.redirect_stderr(io.StringIO()):
        summary = cli.run(RunConfig(
            model="builtin:std_normal_32d", sampler="smc",
            num_walkers=102400, num_steps=10, smc_beta0=0.02, sharded=True))
    if mesh.rank == 0:
        torch.save({"mean": res.mean.cpu(), "var": res.var.cpu(),
                    "sampling_ms": 1e3 * res.sampling_seconds / 256,
                    "launches": launches,
                    "log_evidence": summary["log_evidence"]}, out_path)
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sharded_rank(sys.argv[2], float(sys.argv[3]))
    elif sys.argv[1:2] == ["--sharded-rank-15"]:
        sharded_rank_15(sys.argv[2])
    else:
        main()
    sys.exit(0)
