#!/usr/bin/env python3
"""The measured sweeps behind the design constants of kernels E and A and
of the Gaussian and logistic forms' register tiles in kernels B and D.

    python3 tools/kernel_sweeps.py [--only e|a|gaussian|logistic|threads|diag|tail|registers|sass]
                                   [--source thread_layout.cu]
                                   [--forms mixture,nbody] [--other DIR]
                                   [--out DIR]

from the repository root, on a GPU (every sweep unless ``--only`` names one).

Builds the kernel library several times with other ``-D`` constants (each
build is hashed by its flags, ``ops/_build.py``) and times, as
``chip_smoke.median_ms`` does (CUDA-graph replays, CUDA events):

* kernel E (``csrc/nbody.cu``) at float32 N = 16384 and 4096, float64
  N = 1000 and float32 N = 100, for every split (lanes per target), with
  ``PBBI_E_UNROLL`` (partial sums per lane) and ``PBBI_E_THREADS``
  (threads per block, which sets the tile) varied, with and without
  softening (the r^2 = 0 select);
* kernel A (``csrc/fused_hmc.cu``) at W = 102400, D = 32 (16-byte
  accesses) and D = 33 (scalar accesses) for ``PBBI_A_BLOCK`` x
  ``PBBI_A_MIN_BLOCKS`` and, for the default build, over the number of
  leapfrog steps (the fixed cost and the cost per step);
* the launch floor: kernel E at N = 1 and kernel A at W = 1, D = 1, L = 0;
  and a plain ``copy_`` of the bytes kernel A must move at W = 102400;
* kernel E's error against its plain version at tiny N (2, 3, 4, 31) over
  many seeds, in units of u sqrt(N) S_i (the bound's C is 4);
* kernels B and D with the Gaussian form (``csrc/forms.cuh``) at W = 102400
  and W = 8192, D = 32 and D = 128, L = 16, for every walker tile (1, 2, 4)
  forced, in the default build and with ``PBBI_G_UNROLL`` (chunks of four
  rows of P a loop pass takes), ``PBBI_BLOCK`` (threads a block),
  ``PBBI_BD_MIN_BLOCKS`` (2, a cap of 128 registers, or 1, none),
  ``PBBI_G_SCALAR_P`` (4-byte loads of P in place of 16-byte ones),
  ``PBBI_G_NO_FMA`` (a multiply and an add in place of the fused
  multiply-add) and ``PBBI_G_TILE8`` (a walker tile of 8, which the
  chooser never takes) varied; kernel D with the
  diagonal form at W = 102400, D = 32; and, as context for the matvec
  alone, 17 calls of ``torch.matmul(q - mu, P)`` at W = 102400, D = 32 (the
  gradients of one 16-step transition; the port never calls it);
* kernels B and D with the logistic form (``csrc/forms.cuh``
  LogisticForm) on ``models.logistic_regression_data(256, 31)`` (N = 256,
  D = 32) at W = 102400 and W = 8192, L = 16, for every walker tile (1,
  2, 4) forced, in the default build (4 rows a lane) and with
  ``PBBI_L_ROWS`` = 2 and 8 (the row tile), ``PBBI_BD_MIN_BLOCKS=1`` (no
  cap of 128 registers, so no spill, 8 warps an SM) and
  ``PBBI_L_FAST_SIGMOID`` (the residual's exponential and division by the
  approximate intrinsics, which the plain version does not follow: the
  share of the sigmoid's instructions); and, as context, the two
  ``torch.matmul`` calls and the sigmoid of each of the 17 gradients of a
  transition (the port never calls them);
* kernels B and D in the thread layout (``csrc/thread_layout.cu``) at L =
  16 (B with the count fixed, and with the count on the device and the
  proposal outputs; D with the cached pair): the two eight-schools forms on
  ``models.EIGHT_SCHOOLS_DATA`` at W = 102400, D = 10, and on 14 schools
  from numpy seed 14 (D = 16, the layout's limit); the funnel at D = 10
  (W = 8192 and 102400) and D = 16, the funnel model (D = 16, W =
  102400), both about the funnel's own spread; the N-body form (unit
  masses, softening 0.3, positions 2 N(0, 1)) at 8 bodies in 3-D (D = 24,
  W = 102400 and 8192), 12 in 2-D (D = 24) and 5 in 3-D (D = 15); the
  Gaussian mixture (means 3 N(0, 1), sigma 1, positions 3 N(0, 1)) at
  the thread layout's K (``kernels.MIXTURE_THREAD_COMPONENTS``) and D = 2,
  8, 16, W = 102400, and at parallel tempering's sweep
  of phase 10 (the mixture at (+-6, 0), 6 rungs of 16384 walkers a launch,
  betas 1 down to 0.02, L = 10, kernel B with the count fixed). In the
  default build (each form's register policy, thread_min_blocks) and with
  ``PBBI_THREAD_MIN_BLOCKS`` (one register cap for every form: 1, 2, 4, 6,
  8, 10 blocks of 128 threads) and ``PBBI_THREAD_BLOCK`` (threads a block:
  64, 256) varied, beside the lane-group layout forced on the default
  build (``--forms`` names the forms to time: all unless given);
* kernels B and D with the diagonal forms in the lane groups (the funnel
  model under ``reparam="auto"``, form 12, D = 16, and form 5 at D = 32,
  W = 102400, L = 16; B with the count fixed, and on the device with the
  proposal outputs; D with the cached pair) over ``DIAG_VARIANTS``:
  ``PBBI_DIAG_MIN_BLOCKS`` (the form's register cap in both kernels)
  and ``PBBI_BLOCK``, each line
  with the kernels' registers (``cuobjdump -res-usage``), the launch's
  blocks and whether its outputs are the default build's bits;
* the launch's last wave: kernel B with the logistic form (N = 256, D =
  32, L = 16) in the lane groups at W = 101376 (792 blocks of tile 4, 3
  whole waves of 2 blocks an SM on 132 SMs) and W = 102400 (800 blocks,
  3.03 waves), timed twice each, with ``walkers_per_block`` the blocks'
  walkers and ``blocks`` their count;
* the registers, stack and spills of every instantiation of kernels B and D
  (``nvcc -Xptxas -v``, the library's flags without ``-split-compile``,
  whose parallel ptxas runs interleave their reports), one line each with
  the form, the walker tile and the variant, and the seconds each source
  took (``--source`` names one of the three sources);
* the SASS (``cuobjdump -sass``) of the functions whose instruction
  sequences ``chip_smoke.gradient_ops`` counts: ``expf``, ``logf``,
  ``log1pf``, the IEEE division and reciprocal and ``sqrtf``, and what
  every fused transition draws (a Philox4x32-10 block, ``sincosf`` of 2 pi
  u, a Box-Muller pair, the Metropolis draw with its ``logf``; the
  ``SASS_PHILOX``, ``SASS_SINCOSF`` and ``SASS_ACCEPT`` of
  ``chip_smoke.draw_ops``), each alone in
  a probe kernel built with the library's flags, beside a probe that only
  copies and one that adds (one line each: the instructions a thread
  executes on the path of finite, normal operands, ``sequence`` those
  over the copy's (the division: over the sum's, plus the addition it
  replaces), the MUFU instructions, the listing); and of every
  kernel of the built library (with ``--other DIR``, also of the
  checkout at DIR) whose name holds ``SASS_KERNELS`` (the mixture's, the
  coin's and the diagonal form's), written to ``--out`` (``_build/sass`` unless given) with
  one line each: its instructions, its MUFU, branch and call
  instructions and how many carry a predicate.

Prints the card, then one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import median_ms  # noqa: E402
from physicsbasedbayesianinference_tpu_torch.ops import _build  # noqa: E402
from physicsbasedbayesianinference_tpu_torch.ops import kernels  # noqa: E402
from physicsbasedbayesianinference_tpu_torch.ops import potentials as pot  # noqa: E402,E501
from physicsbasedbayesianinference_tpu_torch import models  # noqa: E402

SEED = 20261016
# (partial sums per lane, threads per block), the default first
E_VARIANTS = ((4, 512), (2, 512), (8, 512), (4, 256), (4, 128))
A_VARIANTS = ((256, 1), (256, 4), (256, 5), (256, 6), (128, 1), (128, 8),
              (128, 10), (512, 1), (512, 2), (512, 3))
# extra nvcc flags of the Gaussian sweep's builds, the default first
G_VARIANTS = ((), ("-DPBBI_BD_MIN_BLOCKS=1",), ("-DPBBI_G_UNROLL=1",),
              ("-DPBBI_G_UNROLL=2",), ("-DPBBI_G_UNROLL=8",),
              ("-DPBBI_BLOCK=128",),
              ("-DPBBI_BLOCK=512", "-DPBBI_BD_MIN_BLOCKS=1"),
              ("-DPBBI_G_SCALAR_P",), ("-DPBBI_G_NO_FMA",),
              ("-DPBBI_G_TILE8", "-DPBBI_BD_MIN_BLOCKS=1"),
              ("-DPBBI_G_TILE8", "-DPBBI_BLOCK=128",
               "-DPBBI_BD_MIN_BLOCKS=1"))
# extra nvcc flags of the logistic sweep's builds, the default first
L_VARIANTS = ((), ("-DPBBI_L_ROWS=2",), ("-DPBBI_L_ROWS=8",),
              ("-DPBBI_BD_MIN_BLOCKS=1",), ("-DPBBI_L_FAST_SIGMOID",))
# extra nvcc flags of the thread layout's sweep, the default first
# (every form at one register cap: 1 block of 128 threads a SM, none; 2,
# 255 registers; 4, 128; 6, 80; 8, 64; 10, 48)
T_VARIANTS = ((), ("-DPBBI_THREAD_MIN_BLOCKS=1",),
              ("-DPBBI_THREAD_MIN_BLOCKS=2",),
              ("-DPBBI_THREAD_MIN_BLOCKS=4",),
              ("-DPBBI_THREAD_MIN_BLOCKS=6",),
              ("-DPBBI_THREAD_MIN_BLOCKS=8",),
              ("-DPBBI_THREAD_MIN_BLOCKS=10",), ("-DPBBI_THREAD_BLOCK=64",),
              ("-DPBBI_THREAD_BLOCK=256",))


# extra nvcc flags of the diagonal form's sweep (kernels B and D in the
# lane groups), the default first (B at most 64 registers, D 40): the
# form's register cap in both kernels (blocks of 256 threads an SM: 8, at
# most 32 registers; 6, 40; 4, 64; 2, 128) and the block size (every
# form's)
DIAG_VARIANTS = ((), ("-DPBBI_DIAG_MIN_BLOCKS=8",),
                 ("-DPBBI_DIAG_MIN_BLOCKS=6",),
                 ("-DPBBI_DIAG_MIN_BLOCKS=4",),
                 ("-DPBBI_DIAG_MIN_BLOCKS=2",), ("-DPBBI_BLOCK=128",),
                 ("-DPBBI_BLOCK=512", "-DPBBI_BD_MIN_BLOCKS=1",
                  "-DPBBI_DIAG_MIN_BLOCKS=1"))
# the sources whose kernels sweep_registers reports
REGISTER_SOURCES = ["fused_hmc.cu", "leapfrog.cu", "thread_layout.cu"]
# the forms sweep_threads times (all unless --forms names some)
THREAD_SWEEP_FORMS = ["eight_schools_nc", "eight_schools", "funnel",
                      "funnel_model", "nbody", "mixture"]
# sweep_sass: each function alone in a probe kernel (x in, y out), and
# the library's kernels whose SASS it writes out
SASS_PROBES = {"copy": "y[i] = x[i];", "sum": "y[i] = x[i] + x[i + n];",
               "expf": "y[i] = expf(x[i]);",
               "logf": "y[i] = logf(x[i]);",
               "log1pf": "y[i] = log1pf(x[i]);",
               "division": "y[i] = x[i] / x[i + n];",
               "reciprocal": "y[i] = 1.0f / x[i];",
               "sqrtf": "y[i] = sqrtf(x[i]);",
               # a Philox4x32-10 block as the kernels draw one: three
               # counter words and both key words known at run time only
               "philox": "const unsigned a = __float_as_uint(x[i]), "
                         "b = __float_as_uint(x[i + n]); "
                         "const pbbi::Philox4 r = pbbi::philox4x32_10("
                         "a, i, b, 1u, b ^ 0x1234u, a + 7u); "
                         "y[i] = __uint_as_float(r.w0 ^ r.w1 ^ r.w2 ^ r.w3);",
               # Box-Muller's sine and cosine of 2 pi u, u in (0, 1]
               "sincosf": "float s, c; "
                          "sincosf(6.283185307179586f * x[i], &s, &c); "
                          "y[i] = s + c;",
               # the whole pair of normals and the Metropolis draw
               "box_muller": "float a, b; pbbi::box_muller("
                             "__float_as_uint(x[i]), "
                             "__float_as_uint(x[i + n]), &a, &b); "
                             "y[i] = a + b;",
               "accept": "y[i] = logf(pbbi::accept_uniform("
                         "__float_as_uint(x[i]), i, "
                         "__float_as_uint(x[i + n]), 7u));"}
# each probe's baseline and what to add to its path less the baseline's:
# the copy, or the sum (two loads, one addition) for the division, whose
# one addition it replaces, for Philox (its key's two instructions and the
# two xors of its words replace the addition: -3), the pair of normals (+0)
# and the Metropolis draw (+1); sincosf less the copy, its 2 pi product
# and the addition of its two results (-2)
SASS_BASELINES = {"division": ("sum", 1), "philox": ("sum", -3),
                  "sincosf": ("copy", -2), "box_muller": ("sum", 0),
                  "accept": ("sum", 1)}
SASS_KERNELS = re.compile(r"MixtureForm|MixtureThreadForm|CoinForm|"
                          r"DiagQuadraticForm")


def use(flags=()):
    """Route the wrappers to the library built with the extra ``flags``."""
    lib = _build.bind(_build.build((*_build.NVCC_FLAGS, *flags)))
    kernels.load_library = lambda: lib


def bodies(n, dtype, gen, dev):
    x = torch.randn(n, 3, generator=gen, dtype=dtype).to(dev)
    m = (0.5 + torch.rand(n, generator=gen, dtype=dtype)).to(dev)
    return x, m


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", choices=("e", "a", "gaussian", "logistic",
                                           "threads", "diag", "tail",
                                           "registers", "sass"))
    parser.add_argument("--source", choices=REGISTER_SOURCES)
    parser.add_argument("--forms", help="comma-separated forms of the "
                        "thread-layout sweep")
    parser.add_argument("--other", help="another checkout whose kernels' "
                        "SASS the sass sweep writes out too")
    parser.add_argument("--out", default=str(_build.BUILD_DIR / "sass"),
                        help="where the sass sweep writes the kernels' SASS")
    args = parser.parse_args()
    only = args.only
    if args.source:
        REGISTER_SOURCES[:] = [args.source]
    if args.forms:
        THREAD_SWEEP_FORMS[:] = args.forms.split(",")
    SASS_OPTIONS.update(other=args.other, out=Path(args.out))
    if not torch.cuda.is_available():
        raise SystemExit("tools/kernel_sweeps.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    for name, sweep in (("e", sweep_e), ("a", sweep_a),
                        ("gaussian", sweep_gaussian),
                        ("logistic", sweep_logistic),
                        ("threads", sweep_threads),
                        ("diag", sweep_diag),
                        ("tail", sweep_tail),
                        ("registers", sweep_registers),
                        ("sass", sweep_sass)):
        if only in (None, name):
            sweep(gen, dev)
    kernels.load_library = _build.load_library


def sweep_e(gen, dev) -> None:
    cases = [(n, dtype, *bodies(n, dtype, gen, dev)) for n, dtype in (
        (16384, torch.float32), (4096, torch.float32),
        (1000, torch.float64), (100, torch.float32))]
    for unroll, threads in E_VARIANTS:
        use((f"-DPBBI_E_UNROLL={unroll}", f"-DPBBI_E_THREADS={threads}"))
        for n, dtype, x, m in cases:
            for eps in (0.05, 0.0):
                if eps == 0.0 and n != 16384:
                    continue
                times = {}
                for split in (1, 2, 4, 8, 16, 32):
                    if n * split < 16384 and split < 32:
                        continue  # far from filling the card
                    times[split] = median_ms(
                        lambda: kernels.nbody_accelerations_tiled(
                            x, m, g_const=1.0, softening=eps, split=split))
                print(json.dumps({
                    "kernel": "E", "unroll": unroll, "threads": threads,
                    "n": n, "dtype": str(dtype),
                    "softening": eps, "ms_by_split": times}))
    use()
    x, m = bodies(1, torch.float32, gen, dev)
    print(json.dumps({"kernel": "E", "n": 1, "launch_floor_ms": median_ms(
        lambda: kernels.nbody_accelerations_tiled(x, m, g_const=1.0,
                                                  softening=0.05))}))
    for n in (2, 3, 4, 31):
        worst = {}
        for dtype in (torch.float32, torch.float64):
            u = torch.finfo(dtype).eps / 2
            ratios = []
            for _ in range(200):
                x, m = bodies(n, dtype, gen, dev)
                kw = dict(g_const=1.0, softening=0.0)
                diff = (kernels.nbody_accelerations_tiled(x, m, **kw)
                        - kernels.nbody_accelerations_tiled_plain(x, m, **kw))
                scale = u * n**0.5 * kernels.nbody_abs_sum(x, m, **kw)
                ratios.append((diff.abs().double() / scale[:, None]).max())
            worst[str(dtype)] = torch.stack(ratios).max().item()
        print(json.dumps({"kernel": "E", "n": n, "seeds": 200,
                          "worst_ratio_to_u_sqrtN_S": worst}))


def sweep_a(gen, dev) -> None:
    w, d = 102400, 32

    def inputs(d):
        one = torch.ones(d, device=dev)
        return torch.randn(w, d, generator=gen).to(dev), dict(
            scalars=torch.tensor([0.3, 1.0, 1.0], device=dev), p_std=one,
            inv_mass=one, k_diag=one, mean=torch.zeros(d, device=dev))

    (q, kw), (q33, kw33) = inputs(d), inputs(33)

    def time_a(steps, q=q, kw=kw):
        return median_ms(lambda: kernels.fused_hmc_diag_quadratic(
            SEED, 7, q, num_steps=steps, **kw))

    for block, min_blocks in A_VARIANTS:
        use((f"-DPBBI_A_BLOCK={block}", f"-DPBBI_A_MIN_BLOCKS={min_blocks}"))
        print(json.dumps({"kernel": "A", "block": block,
                          "min_blocks": min_blocks, "W": w, "L": 16,
                          "ms_D32": [time_a(16), time_a(16)],
                          "ms_D33": time_a(16, q33, kw33)}))
    use()
    print(json.dumps({"kernel": "A", "W": w, "D": d, "ms_by_steps": {
        steps: time_a(steps) for steps in (0, 1, 4, 16, 64)}}))
    # a plain copy that moves the bytes kernel A must move (q in, q', g' out)
    src = torch.randn(3 * w * d // 2, generator=gen).to(dev)
    dst = torch.empty_like(src)
    print(json.dumps({"yardstick": "torch copy", "bytes_moved": 8 * src.numel(),
                      "ms": median_ms(lambda: dst.copy_(src))}))
    one = torch.ones(1, device=dev)
    print(json.dumps({"kernel": "A", "W": 1, "D": 1, "L": 0,
                      "launch_floor_ms": time_a(0, one[None], dict(
                          scalars=kw["scalars"], p_std=one, inv_mass=one,
                          k_diag=one, mean=0.0 * one))}))


def sweep_gaussian(gen, dev) -> None:
    steps = 16

    def case(w, d):
        a = torch.randn(d, d, generator=gen) / d**0.5
        form = ("gaussian", (
            torch.randn(d, generator=gen).to(dev),
            torch.linalg.inv(a @ a.T + 0.5 * torch.eye(d)).contiguous().to(
                dev)))
        q = torch.randn(w, d, generator=gen).to(dev)
        p = torch.randn(w, d, generator=gen).to(dev)
        u, g = (torch.randn(w, generator=gen).to(dev),
                torch.randn(w, d, generator=gen).to(dev))
        return form, q, p, u, g, torch.ones(d, device=dev)

    cases = {(w, d): case(w, d) for w in (102400, 8192) for d in (32, 128)}
    scalars = torch.tensor([0.05, 1.0, 1.0], device=dev)
    step = torch.tensor([0.05], device=dev)

    def time_b(key, tile):
        form, q, _, u, g, one = cases[key]
        return median_ms(lambda: kernels.fused_hmc_transition(
            form, SEED, 7, q, u, g, scalars=scalars, p_std=one, inv_mass=one,
            num_steps=steps, tile=tile))

    def time_d(key, tile, form=None):
        gauss, q, p, u, g, one = cases[key]
        return median_ms(lambda: kernels.leapfrog_trajectory(
            form or gauss, q, p, step_size=step, num_steps=steps,
            inv_mass=one, grad=g, potential_energy=u, tile=tile))

    tiles = kernels.WALKER_TILES
    chosen = {key: kernels.walker_tile(*key) for key in cases}
    for flags in G_VARIANTS:
        use(flags)
        # a build with the tile of 8 is asked for it, past the wrappers' check
        kernels.WALKER_TILES = (*tiles, 8) if "-DPBBI_G_TILE8" in flags \
            else tiles
        for (w, d) in cases:
            print(json.dumps({
                "kernel": "B and D, gaussian form", "flags": list(flags),
                "W": w, "D": d, "L": steps,
                "chosen_tile": chosen[(w, d)],
                "B_ms_by_tile": {t: time_b((w, d), t)
                                 for t in kernels.WALKER_TILES},
                "D_ms_by_tile": {t: time_d((w, d), t)
                                 for t in kernels.WALKER_TILES}}))
    kernels.WALKER_TILES = tiles
    use()
    one = torch.ones(32, device=dev)
    print(json.dumps({
        "kernel": "D, diag form", "W": 102400, "D": 32, "L": steps,
        "ms": time_d((102400, 32), None, ("diag", (one, 0.0 * one)))}))
    form, q, *_ = cases[(102400, 32)]
    mean, prec = form[1]

    def matvecs():
        for _ in range(steps + 1):
            torch.matmul(q - mean, prec)

    print(json.dumps({
        "yardstick": "torch.matmul(q - mu, P) x 17 (the gradients of one "
                     "L=16 transition, nothing else of it)",
        "W": 102400, "D": 32, "allow_tf32": False, "ms": median_ms(matvecs)}))


def sweep_logistic(gen, dev) -> None:
    steps = 16
    x, y = models.logistic_regression_data(256, 31)
    form = ("logistic", (torch.as_tensor(x).to(dev),
                         torch.as_tensor(y).to(dev)))
    xd, yd = form[1]
    d = 32
    cases = {}
    for w in (102400, 8192):
        q = 0.3 * torch.randn(w, d, generator=gen).to(dev)
        u, g = kernels.device_value_and_grad(form)(q)
        cases[w] = (q, torch.randn(w, d, generator=gen).to(dev), u, g)
    scalars = torch.tensor([0.05, 1.0, 1.0], device=dev)
    step = torch.tensor([0.05], device=dev)
    one = torch.ones(d, device=dev)
    rows = kernels.LOGISTIC_ROWS

    def time_b(w, tile):
        q, _, u, g = cases[w]
        return median_ms(lambda: kernels.fused_hmc_transition(
            form, SEED, 7, q, u, g, scalars=scalars, p_std=one, inv_mass=one,
            num_steps=steps, tile=tile))

    def time_d(w, tile):
        q, p, u, g = cases[w]
        return median_ms(lambda: kernels.leapfrog_trajectory(
            form, q, p, step_size=step, num_steps=steps, inv_mass=one,
            grad=g, potential_energy=u, tile=tile))

    for flags in L_VARIANTS:
        use(flags)
        # the wrappers' shared-memory check follows the build's row tile
        kernels.LOGISTIC_ROWS = next(
            (int(f.split("=")[1]) for f in flags
             if f.startswith("-DPBBI_L_ROWS=")), rows)
        for w in cases:
            print(json.dumps({
                "kernel": "B and D, logistic form", "flags": list(flags),
                "W": w, "D": d, "N": 256, "L": steps,
                "chosen_tile": kernels.logistic_tile(w, 256, d),
                "B_ms_by_tile": {t: time_b(w, t)
                                 for t in kernels.WALKER_TILES},
                "D_ms_by_tile": {t: time_d(w, t)
                                 for t in kernels.WALKER_TILES}}))
    kernels.LOGISTIC_ROWS = rows
    use()
    for w, (q, *_) in cases.items():
        def library():
            for _ in range(steps + 1):
                r = torch.sigmoid(q[:, :-1] @ xd.T + q[:, -1:]) - yd
                torch.cat([q[:, :-1] + r @ xd,
                           q[:, -1:] + r.sum(1, keepdim=True)], 1)
        print(json.dumps({
            "yardstick": "two torch.matmul and a sigmoid x 17 (the "
                         "gradients of one L=16 transition, nothing else)",
            "W": w, "D": d, "N": 256, "allow_tf32": False,
            "ms": median_ms(library)}))


def sweep_threads(gen, dev) -> None:
    steps = 16

    def schools(name, j):
        data = models.EIGHT_SCHOOLS_DATA
        if j != 8:
            rng = np.random.default_rng(j)
            data = {"J": j, "y": (10.0 * rng.normal(size=j)).astype(
                np.float32), "sigma": rng.uniform(5.0, 20.0, j).astype(
                    np.float32)}
        model = {"eight_schools_nc": models.eight_schools_noncentered,
                 "eight_schools": models.eight_schools}[name]
        form = models.make_model_potential(model, (), data,
                                           device=dev).potential.device_form
        z = torch.randn(102400, j + 2, generator=gen)
        # mu, log tau and theta about the posterior of the Rubin data
        theta = z[:, 2:] if name == "eight_schools_nc" else 4.0 + 3.0 * z[
            :, 2:]
        return form, torch.cat([4.0 + 3.0 * z[:, :1],
                                1.0 + 0.5 * z[:, 1:2], theta], 1)

    def funnel(name, w, d):
        form = (pot.make_funnel(d, device=dev).device_form
                if name == "funnel" else models.make_model_potential(
                    models.funnel, (), {"dim": d - 1},
                    device=dev).potential.device_form)
        z = torch.randn(w, d, generator=gen)
        # v ~ N(0, 1.5^2), x | v ~ N(0, e^v): the funnel's own spread
        return form, torch.cat([1.5 * z[:, :1],
                                torch.exp(0.75 * z[:, :1]) * z[:, 1:]], 1)

    def nbody(w, n, s):
        form = pot.make_nbody_potential(torch.ones(n), n, s, softening=0.3,
                                        device=dev).device_form
        return form, 2.0 * torch.randn(w, n * s, generator=gen)

    def mixture(w, k, d):
        form = pot.make_gaussian_mixture(
            3.0 * torch.randn(k, d, generator=gen), device=dev).device_form
        return form, 3.0 * torch.randn(w, d, generator=gen)

    # (form, W, D, label) -> (form, q on the card)
    cases = {}
    for name in ("eight_schools_nc", "eight_schools"):
        for j in (8, 14):  # D = 10 and 16, the layout's limit
            cases[name, 102400, j + 2, ""] = schools(name, j)
    for w, d in ((8192, 10), (102400, 10), (102400, 16)):
        cases["funnel", w, d, ""] = funnel("funnel", w, d)
    cases["funnel_model", 102400, 16, ""] = funnel("funnel_model", 102400, 16)
    for w, n, s in ((102400, 8, 3), (8192, 8, 3), (102400, 12, 2),
                    (102400, 5, 3)):
        cases["nbody", w, n * s, f"N={n} S={s}"] = nbody(w, n, s)
    for k in (kernels.MIXTURE_THREAD_COMPONENTS,):
        for d in (2, 8, 16):
            cases["mixture", 102400, d, f"K={k}"] = mixture(102400, k, d)
    cases = {key: v for key, v in cases.items()
             if key[0] in THREAD_SWEEP_FORMS}
    scalars = torch.tensor([0.05, 1.0, 1.0], device=dev)
    step = torch.tensor([0.05], device=dev)
    state = {}
    for key, (form, q) in cases.items():
        q = q.to(dev)
        u, g = kernels.device_value_and_grad(form)(q)
        state[key] = (form, q, torch.randn(q.shape, generator=gen).to(dev),
                      u, g)
    # parallel tempering's sweep of phase 10: 6 rungs in one launch
    rung_case = None
    if "mixture" in THREAD_SWEEP_FORMS:
        r, w = 6, 16384
        betas = torch.logspace(0.0, math.log10(0.02), r).to(dev)
        form = pot.make_gaussian_mixture(
            torch.tensor([[-6.0, 0.0], [6.0, 0.0]]), device=dev).device_form
        q = (6.0 * torch.randn(r, w, 2, generator=gen)).to(dev)
        vg = kernels.device_value_and_grad(form)
        u, g = (torch.stack(x) for x in zip(*(vg(x) for x in q)))
        rung_case = (form, q, u, g, dict(
            scalars=torch.stack((0.5 / betas.sqrt(), betas,
                                 torch.ones_like(betas)), 1),
            p_std=torch.sqrt(1.0 / betas)[:, None].expand(r, 2).contiguous(),
            inv_mass=torch.ones(2, device=dev), num_steps=10),
            [SEED + i for i in range(r)])

    def rung_ms(forced=None):
        form, q, u, g, kw, seeds = rung_case
        return median_ms(lambda: kernels.fused_hmc_transition(
            form, seeds, 7, q, u, g, _layout=forced, **kw))

    def times(key, forced=None):
        form, q, p, u, g = state[key]
        one = torch.ones(q.shape[1], device=dev)
        count = torch.tensor([steps], dtype=torch.int32, device=dev)
        b = dict(scalars=scalars, p_std=one, inv_mass=one, _layout=forced)
        return {
            "B_fixed_ms": median_ms(lambda: kernels.fused_hmc_transition(
                form, SEED, 7, q, u, g, num_steps=steps, **b)),
            "B_counted_proposal_ms": median_ms(
                lambda: kernels.fused_hmc_transition(
                    form, SEED, 7, q, u, g, num_steps=count,
                    max_steps=steps, emit_proposal=True, **b)),
            "D_ms": median_ms(lambda: kernels.leapfrog_trajectory(
                form, q, p, step_size=step, num_steps=steps, inv_mass=one,
                grad=g, potential_energy=u, _layout=forced))}

    for flags in T_VARIANTS:
        use(flags)
        for key in state:
            form, w, d, label = key
            line = {"kernel": "B and D, thread layout",
                    "flags": list(flags), "form": form, "W": w, "D": d,
                    "shape": label, "L": steps,
                    "layouts": {k: kernels.form_layout(state[key][0], d, k)
                                for k in ("B", "D")},
                    "chosen": times(key)}
            if not flags:
                line["group"] = times(key, "group")
            print(json.dumps(line))
        if rung_case is not None:
            line = {"kernel": "B, thread layout, parallel tempering's sweep",
                    "flags": list(flags), "form": "mixture", "R": 6,
                    "W": 16384, "D": 2, "shape": "K=2", "L": 10,
                    "chosen_ms": rung_ms()}
            if not flags:
                line["group_ms"] = rung_ms("group")
            print(json.dumps(line))
    use()


def _flag(flags, name, default):
    """The value of ``-Dname=value`` in ``flags``, else ``default``."""
    for f in flags:
        if f.startswith(f"-D{name}="):
            return int(f.split("=", 1)[1])
    return default


def _registers(lib: Path, pattern: str) -> dict:
    """Registers of each kernel of the built library whose demangled name
    holds ``pattern`` (``cuobjdump -res-usage``), by demangled name."""
    bin_dir = Path(_build.nvcc_path()).parent
    text = subprocess.run([str(bin_dir / "cuobjdump"), "-res-usage",
                           str(lib)], capture_output=True, text=True,
                          check=True).stdout
    found = re.findall(r"Function (\S+):\s*\n?\s*REG:(\d+)", text)
    names = subprocess.run([str(bin_dir / "cu++filt")], input="\n".join(
        m for m, _ in found), capture_output=True, text=True,
        check=True).stdout.splitlines()
    out = {}
    for name, (_, regs) in zip(names, found):
        if pattern in name:  # kernel<Form, R, kVec, ...>: by kernel and flags
            m = re.match(r"(?:void )?(?:<unnamed>::|\(anonymous "
                         r"namespace\)::)?(\w+)<[^,]*, ([^>]*)>", name)
            out[f"{m.group(1)}<{m.group(2)}>" if m else name] = int(regs)
    return out


def sweep_diag(gen, dev) -> None:
    """Kernels B and D with the diagonal forms in the lane groups: the
    funnel model under reparam="auto" (form 12, W = 102400, D = 16, L =
    16: phase 14c's shape) and form 5 (W = 102400, D = 32), over
    ``DIAG_VARIANTS``, each line with the kernels' registers, the blocks
    of a launch and whether its outputs are the default build's bits."""
    steps, w = 16, 102400
    model = models.make_model_potential(models.funnel, (), {},
                                        reparam="auto", device=dev)
    d16 = model.num_dims
    form16 = model.potential.device_form
    form32 = ("diag", ((0.5 + 1.5 * torch.rand(32, generator=gen)).to(dev),
                       torch.randn(32, generator=gen).to(dev)))
    cases = {}
    for label, form, d in (("diag_model (funnel reparam=auto)", form16, d16),
                           ("diag", form32, 32)):
        q = torch.randn(w, d, generator=gen).to(dev)
        u, g = kernels.device_value_and_grad(form)(q)
        im = (0.5 + 1.5 * torch.rand(d, generator=gen)).to(dev)
        cases[label] = (form, d, q, torch.randn(w, d, generator=gen).to(dev),
                        u, g, im)
    count = torch.tensor([steps], dtype=torch.int32, device=dev)
    scalars = torch.tensor([0.2, 1.0, 1.0], device=dev)
    step = torch.tensor([0.2], device=dev)
    default = {}
    for flags in DIAG_VARIANTS:
        use(flags)
        lib = _build.build((*_build.NVCC_FLAGS, *flags))
        regs = _registers(lib, "DiagQuadraticForm")
        block = _flag(flags, "PBBI_BLOCK", 256)
        for label, (form, d, q, p, u, g, im) in cases.items():
            b = dict(scalars=scalars, p_std=torch.sqrt(1.0 / im),
                     inv_mass=im)
            calls = {
                "B_fixed": lambda: kernels.fused_hmc_transition(
                    form, SEED, 7, q, u, g, num_steps=steps, **b),
                "B_counted_proposal": lambda: kernels.fused_hmc_transition(
                    form, SEED, 7, q, u, g, num_steps=count,
                    max_steps=steps, emit_proposal=True, **b),
                "D": lambda: kernels.leapfrog_trajectory(
                    form, q, p, step_size=step, num_steps=steps,
                    inv_mass=im, grad=g, potential_energy=u)}
            outs = {k: fn() for k, fn in calls.items()}
            torch.cuda.synchronize()
            if not flags:
                default[label] = outs
            same = all(torch.equal(a, b_) for k in outs
                       for a, b_ in zip(outs[k], default[label][k]))
            walkers = block // kernels.threads_per_walker(d)
            print(json.dumps({
                "kernel": "B and D, diagonal form, lane groups",
                "flags": list(flags), "form": label, "W": w, "D": d,
                "L": steps, "threads_per_block": block,
                "walkers_per_block": walkers, "blocks": -(-w // walkers),
                "same_bits_as_default": same,
                **{f"{k}_ms": median_ms(fn) for k, fn in calls.items()},
                "registers": regs}))
    use()


def sweep_tail(gen, dev) -> None:
    x, y = models.logistic_regression_data(256, 31)
    form = ("logistic", (torch.as_tensor(x).to(dev),
                         torch.as_tensor(y).to(dev)))
    d, steps = 32, 16
    one = torch.ones(d, device=dev)
    scalars = torch.tensor([0.05, 1.0, 1.0], device=dev)
    q = 0.3 * torch.randn(102400, d, generator=gen).to(dev)
    u, g = kernels.device_value_and_grad(form)(q)
    for w in (101376, 102400):
        qw, uw, gw = q[:w].contiguous(), u[:w].contiguous(), \
            g[:w].contiguous()
        per_block = (kernels._BLOCK_THREADS // kernels.threads_per_walker(d)
                     * kernels.logistic_tile(w, 256, d))
        print(json.dumps({
            "kernel": "B, logistic form, the last wave", "layout": "group",
            "W": w, "D": d, "N": 256, "L": steps,
            "walkers_per_block": per_block, "blocks": -(-w // per_block),
            "ms": [median_ms(lambda: kernels.fused_hmc_transition(
                form, SEED, 7, qw, uw, gw, scalars=scalars, p_std=one,
                inv_mass=one, num_steps=steps))
                for _ in range(2)]}))


def _ptxas_report(text: str):
    """(mangled entry, registers, stack, spill stores, spill loads) of each
    kernel in nvcc -Xptxas -v output."""
    entry, props, out = None, {}, []
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry:
            props[entry] = tuple(map(int, m.groups()))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.append((entry, int(m.group(1)), *props.get(entry, (0, 0, 0))))
            entry = None
    return out


def sweep_registers(gen, dev) -> None:
    del gen, dev
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-split-compile", "0")]
    nvcc = _build.nvcc_path()
    demangle = shutil.which("cu++filt") or str(
        Path(nvcc).parent / "cu++filt")
    out_dir = _build.BUILD_DIR / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    for src in REGISTER_SOURCES:
        t0 = time.perf_counter()
        done = subprocess.run(
            [nvcc, *flags, "-Xptxas", "-v", "-c", "-o",
             str(out_dir / f"{src}.o"), str(_build.CSRC / src)],
            capture_output=True, text=True, check=True)
        seconds = time.perf_counter() - t0
        report = _ptxas_report(done.stdout + done.stderr)
        names = subprocess.run([demangle], input="\n".join(
            r[0] for r in report), capture_output=True, text=True,
            check=True).stdout.splitlines()
        print(json.dumps({"source": src, "seconds_without_split_compile":
                          seconds, "kernels": len(report)}))
        for (_, regs, stack, st, ld), name in zip(report, names):
            print(json.dumps({"source": src, "kernel": name,
                              "registers": regs, "stack_bytes": stack,
                              "spill_store_bytes": st,
                              "spill_load_bytes": ld}))
    shutil.rmtree(out_dir)


# sweep_sass's options (main sets them from the command line)
SASS_OPTIONS = {"other": None, "out": _build.BUILD_DIR / "sass"}
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def _sass(binary: Path) -> dict:
    """``cuobjdump -sass`` of ``binary``: each function's instructions (no
    NOPs) as (address, text), by mangled name."""
    cuobjdump = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(binary)],
                          capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = _SASS_LINE.search(line)
        if m and name and not m.group(2).startswith("NOP"):
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    return funcs


def _fast_path(body, taken=True) -> int:
    """Instructions a thread executes from the start to the unpredicated
    EXIT when every forward conditional branch is taken: the path of
    finite, normal operands, on which the division, reciprocal and root
    branch past the call of their slow path and log1pf past its special
    cases (a predicated EXIT falls through). With ``taken`` false every
    conditional branch falls through instead (sincosf's reduction of a
    small argument, ahead of the branch to its large-argument path; the
    listing says which path is which)."""
    at = {a: i for i, (a, _) in enumerate(body)}
    i = n = 0
    while True:
        addr, ins = body[i]
        n += 1
        op = _opcode(ins)
        if op == "EXIT" and not ins.startswith("@"):
            return n
        if op == "BRA":
            target = int(re.findall(r"0x[0-9a-f]+", ins)[-1], 16)
            if not ins.startswith("@") or (taken and target > addr):
                i = at[target]
                continue
        i += 1


def _opcode(ins: str) -> str:
    return ins.split()[1] if ins.startswith("@") else ins.split()[0]


def _sass_stats(body) -> dict:
    text = [ins for _, ins in body]
    ops = [_opcode(i) for i in text]
    return {"instructions": len(body),
            "mufu": {o: ops.count(o) for o in sorted(set(ops))
                     if o.startswith("MUFU")},
            "branches": sum(o == "BRA" for o in ops),
            "calls": sum(o.startswith("CALL") for o in ops),
            "predicated": sum(i.startswith("@") for i in text)}


def sweep_sass(gen, dev) -> None:
    del gen, dev
    out = SASS_OPTIONS["out"]
    out.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-split-compile", "0")]
    src = out / "probes.cu"
    src.write_text(f'#include "{_build.CSRC / "philox.cuh"}"\n' + "".join(
        f'extern "C" __global__ void probe_{name}(const float* __restrict__ '
        f"x, float* __restrict__ y, int n) {{\n"
        f"  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
        f"  if (i < n) {{ {body} }}\n}}\n"
        for name, body in SASS_PROBES.items()))
    cubin = out / "probes.cubin"
    subprocess.run([_build.nvcc_path(), *flags, "-cubin", "-o", str(cubin),
                    str(src)], check=True)
    funcs = _sass(cubin)
    path = {name: _fast_path(funcs[f"probe_{name}"]) for name in SASS_PROBES}
    through = {name: _fast_path(funcs[f"probe_{name}"], taken=False)
               for name in SASS_PROBES}
    for name in SASS_PROBES:
        body = funcs[f"probe_{name}"]
        base, extra = SASS_BASELINES.get(name, ("copy", 0))
        print(json.dumps({"probe": name, "fast_path": path[name],
                          "baseline": base,
                          "sequence": path[name] - path[base] + extra,
                          "falling_through": through[name],
                          "sequence_falling_through":
                              through[name] - through[base] + extra,
                          **_sass_stats(body),
                          "listing": [ins for _, ins in body]}))
    libs = {"this": _build.build()}
    if SASS_OPTIONS["other"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        from compare_builds import load_other
        load_other(Path(SASS_OPTIONS["other"]).resolve())
        import other_pbbi.ops._build as other_build
        libs["other"] = other_build.build()
    demangle = shutil.which("cu++filt") or str(
        Path(_build.nvcc_path()).parent / "cu++filt")
    for tag, lib in libs.items():
        funcs = _sass(lib)
        mangled = list(funcs)
        names = subprocess.run([demangle], input="\n".join(mangled),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        (out / tag).mkdir(exist_ok=True)
        for i, (m, name) in enumerate(zip(mangled, names)):
            if not SASS_KERNELS.search(name):
                continue
            path = out / tag / f"{i:03d}.sass"
            path.write_text(name + "\n" + "".join(
                f"/*{a:04x}*/ {ins}\n" for a, ins in funcs[m]))
            print(json.dumps({"library": tag, "kernel": name,
                              "file": str(path), **_sass_stats(funcs[m])}))


if __name__ == "__main__":
    main()
