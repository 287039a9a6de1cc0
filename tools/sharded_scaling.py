#!/usr/bin/env python3
"""The sharded samplers over K cards, against the unsharded runs.

    python3 tools/sharded_scaling.py [--sizes 1 2 4]

from the repository root, on a machine with as many cards as the largest
size. For each K it builds the kernels once, then starts K rank processes
with ``torch.distributed.run`` (NCCL), twice: the first run drives, at
full width,

1. at a fixed step size, the one-process run's bits: ChEES on phase 8a's
   logistic regression (W=102400, kernel B), parallel tempering on phase
   10's mixture (R=6, W=16384 a rung) over a replica x walker group with
   K_r = 2 where K is even (the edge rungs exchanged point to point
   between cards), and NUTS on phase 11's Gaussian (W=65536); rank 0
   reruns each unsharded on its card and compares;
2. the adapted runs of phases 8a, 10 and 11 (ms a warmup and a sampling
   transition, host clock around synchronised runs; their moments);
3. a checkpointed chees run of the CLI (eight schools, W=102400, every 128
   transitions) stopped after its first chunk, and the uninterrupted one;

and the second, a fresh group, resumes the first chunk's checkpoints,
whose moments must be the uninterrupted run's bit for bit. Prints the
cards, then one JSON line a size; exits non-zero where a run is not
bitwise.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEED = 20261016


def _timed(run):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _cli(cfg):
    from physicsbasedbayesianinference_tpu_torch import main as cli
    with contextlib.redirect_stderr(io.StringIO()):
        return cli.run(cfg)


def rank_run(out_path: str, directory: str, phase: str) -> None:
    """One rank of a K-rank group (started by torchrun)."""
    import torch.distributed as dist

    from physicsbasedbayesianinference_tpu_torch import (
        models, run_chees_hmc, run_nuts, run_parallel_tempering)
    from physicsbasedbayesianinference_tpu_torch import parallel as par
    from physicsbasedbayesianinference_tpu_torch.config import RunConfig
    from physicsbasedbayesianinference_tpu_torch.ops import potentials as pot

    par.initialize_distributed()
    if not dist.is_initialized():  # torchrun with one process
        dist.init_process_group(
            "nccl" if torch.cuda.is_available() else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    mesh = par.make_walker_mesh()
    dev, k, lead = mesh.device, mesh.size, mesh.rank == 0
    ckpt = dict(model="example:eight_schools_noncentered",
                data_path=str(ROOT / "examples" / "eight_schools.data.json"),
                sampler="chees", num_walkers=102400, num_warmup=200,
                init_step_size=0.22, checkpoint_every=128, sharded=True)
    out = {"K": k}
    if phase == "resume":
        s = _cli(RunConfig(num_samples=256, checkpoint_dir=f"{directory}/a",
                           **ckpt))
        out["resumed"] = s
        if lead:
            Path(out_path).write_text(json.dumps(out))
        dist.destroy_process_group()
        return

    def seeded(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    x_lr, y_lr = models.logistic_regression_data(256, 31)
    lr = models.make_model_potential(models.logistic_regression,
                                     (x_lr, y_lr), {}).potential
    q8 = 0.3 * torch.randn(102400, 32, generator=seeded(0), device=dev)
    bimodal = pot.make_gaussian_mixture(
        torch.tensor([[-6.0, 0.0], [6.0, 0.0]]), device=dev)
    q10 = torch.tensor([-6.0, 0.0], device=dev) + 0.3 * torch.randn(
        16384, 2, generator=seeded(11), device=dev)
    sd11 = torch.logspace(0.0, 1.0, 16, device=dev)
    g11 = pot.make_gaussian(torch.zeros(16), cov=torch.diag(
        sd11.cpu() ** 2), device=dev)
    q11 = torch.randn(65536, 16, generator=seeded(12), device=dev) * sd11
    rm = par.make_replica_mesh(2 if k % 2 == 0 else 1)
    fixed = {
        "chees": (lambda m: run_chees_hmc(
            SEED + 8, lr, q8, num_warmup=0, num_samples=32,
            init_step_size=0.5, init_tau=2.0, max_steps=256,
            collect="none", mesh=m), lambda r: r.state.ensemble.q),
        "pt": (lambda m: run_parallel_tempering(
            SEED + 14, bimodal, q10, num_replicas=6, beta_min=0.02,
            num_warmup=0, num_samples=50, num_steps=10, init_step_size=0.3,
            collect="none", mesh=m), lambda r: r.q),
        "nuts": (lambda m: run_nuts(
            SEED + 15, g11, q11, num_warmup=0, num_samples=10,
            init_step_size=0.5, max_depth=8, collect="none", mesh=m),
            lambda r: r.state.ensemble.q),
    }
    blocks = {}
    for name, (run, state) in fixed.items():
        got = state(run(rm if name == "pt" else mesh)).contiguous()
        # every rank's block, in group order (equal shapes)
        parts = [torch.empty_like(got) for _ in range(k)]
        dist.all_gather(parts, got)
        blocks[name] = parts
    adapted = {
        "chees_8a": (lambda: run_chees_hmc(
            SEED + 8, lr, q8, num_warmup=200, num_samples=256,
            max_steps=256, init_step_size=0.05, collect="moments",
            mesh=mesh), 200, 256),
        "pt_10": (lambda: run_parallel_tempering(
            SEED + 14, bimodal, q10, num_replicas=6, beta_min=0.02,
            num_warmup=200, num_samples=400, num_steps=10,
            collect="moments", mesh=rm), 200, 400),
        "nuts_11": (lambda: run_nuts(
            SEED + 15, g11, q11, num_warmup=100, num_samples=100,
            max_depth=8, collect="none", mesh=mesh), 100, 100),
    }
    for name, (run, n_w, n_s) in adapted.items():
        res, wall = _timed(run)
        out[name] = {
            "sampling_ms": 1e3 * res.sampling_seconds / n_s,
            "warmup_ms": 1e3 * (wall - res.sampling_seconds) / n_w,
            "accept_rate": torch.as_tensor(res.accept_rate).tolist()}
        if getattr(res, "mean", None) is not None:
            out[name]["mean"] = res.mean.tolist()
            out[name]["var"] = res.var.tolist()
    _cli(RunConfig(num_samples=128, checkpoint_dir=f"{directory}/a", **ckpt))
    out["uninterrupted"] = _cli(RunConfig(
        num_samples=256, checkpoint_dir=f"{directory}/b", **ckpt))
    if lead:  # the one-process runs, on this card, against the joined blocks
        for name, (run, state) in fixed.items():
            want = state(run(None))
            if name == "pt":
                k_w = rm.walkers.size
                got = torch.cat([torch.cat(blocks[name][i * k_w:(i + 1) * k_w],
                                           dim=1)
                                 for i in range(rm.replicas.size)])
            else:
                got = torch.cat(blocks[name])
            out[f"{name}_fixed_bitwise"] = bool(torch.equal(got, want))
        out["pt_mesh"] = [rm.replicas.size, rm.walkers.size]
        Path(out_path).write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--sizes", type=int, nargs="+", default=[1, 2, 4])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this measurement runs on the card")
    from physicsbasedbayesianinference_tpu_torch.ops import _build
    _build.build()  # once, before the ranks load it
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()
    print(json.dumps({"cards": card}))
    lines = []
    for k in args.sizes:
        if k > torch.cuda.device_count():
            continue
        with tempfile.TemporaryDirectory(prefix="pbbi_scaling_") as tmp:
            got = {}
            for phase in ("run", "resume"):
                out = Path(tmp) / f"{phase}.json"
                t0 = time.perf_counter()
                proc = subprocess.run(
                    [sys.executable, "-m", "torch.distributed.run",
                     "--standalone", f"--nproc_per_node={k}", __file__,
                     "--rank-run", str(out), tmp, phase], cwd=ROOT,
                    capture_output=True, text=True, timeout=900)
                if proc.returncode != 0:
                    sys.exit(f"K={k} {phase} exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
                got[phase] = json.loads(out.read_text())
                got[phase]["process_seconds"] = time.perf_counter() - t0
        full, resumed = got["run"]["uninterrupted"], got["resume"]["resumed"]
        line = {k_: v for k_, v in got["run"].items() if k_ != "uninterrupted"}
        line["checkpoint_resumed_bitwise"] = (
            resumed["resumed_from"] == 128
            and all(resumed[x] == full[x] for x in (
                "posterior_mean", "posterior_var", "step_size")))
        line["resume_process_seconds"] = got["resume"]["process_seconds"]
        line["card"] = card[0] if card else None
        print(json.dumps(line))
        lines.append(line)
    bad = [ln["K"] for ln in lines if not (
        ln["checkpoint_resumed_bitwise"] and ln["chees_fixed_bitwise"]
        and ln["pt_fixed_bitwise"] and ln["nuts_fixed_bitwise"])]
    if bad:
        sys.exit(f"not bitwise at K={bad}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-run"]:
        rank_run(*sys.argv[2:5])
    else:
        main()
