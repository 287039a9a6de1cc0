#!/usr/bin/env python3
"""The measured sweeps behind the design constants of kernels E and A.

    python3 tools/kernel_sweeps.py        # from the repository root, on a GPU

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
  many seeds, in units of u sqrt(N) S_i (the bound's C is 4).

Prints the card, then one JSON line per measurement.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import median_ms  # noqa: E402
from physicsbasedbayesianinference_tpu_torch.ops import _build  # noqa: E402
from physicsbasedbayesianinference_tpu_torch.ops import kernels  # noqa: E402

SEED = 20261016
# (partial sums per lane, threads per block), the default first
E_VARIANTS = ((4, 512), (2, 512), (8, 512), (4, 256), (4, 128))
A_VARIANTS = ((256, 1), (256, 4), (256, 5), (256, 6), (128, 1), (128, 8),
              (128, 10), (512, 1), (512, 2), (512, 3))


def use(flags=()):
    """Route the wrappers to the library built with the extra ``flags``."""
    lib = _build.bind(_build.build((*_build.NVCC_FLAGS, *flags)))
    kernels.load_library = lambda: lib


def bodies(n, dtype, gen, dev):
    x = torch.randn(n, 3, generator=gen, dtype=dtype).to(dev)
    m = (0.5 + torch.rand(n, generator=gen, dtype=dtype)).to(dev)
    return x, m


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tools/kernel_sweeps.py needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)

    # ---- kernel E ----------------------------------------------------------
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

    # ---- kernel A ----------------------------------------------------------
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
    kernels.load_library = _build.load_library


if __name__ == "__main__":
    main()
