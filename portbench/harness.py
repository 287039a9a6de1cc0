"""One run of one cell: set-up, the measured window of sampler jobs, the
check of what the jobs returned against the plain reference, and the
result line.

Everything that belongs to a cell, a configuration, a traffic mix, a
metric or a count is a file found by its name in ``BENCHMARK.json``:

    portbench/workloads/<cell>.json     the cell's why, check sample, limits
    <config's "file">                   sizes, sampler, engine, count, model
    portbench/configs/<model>.py        the model's plain reference and inputs
    portbench/ports/<model>.py          the program's potential of the model
    portbench/entries/<sampler>.py      the program's sampler call
    portbench/traffic/<traffic>.json    walkers and transitions of a job
    portbench/metrics/<metric>.py       read(run) -> number or None
    portbench/counts/<count>.py         a transition's least time

A job is one call of the program's sampler entry, 500 + 500 transitions
by default. The window runs jobs back to back (one client, closed loop)
until their summed wall times reach ``--seconds``; between jobs, outside
the timed intervals, it computes the job's ESS and keeps what the check
reads. With ``--trace 1`` the job that starts after half the window runs
under ``torch.profiler``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import socket
import subprocess
import sys
import time
import traceback
from pathlib import Path

from portbench import ess

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "physicsbasedbayesianinference_tpu")
SUBSET = 16384  # walkers the ESS averages over
MASK62 = (1 << 62) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def derive(seed: int, *words: int) -> int:
    """A 62-bit seed from ``seed`` and ``words`` (a job's index, a use)."""
    x = _splitmix64(seed & 0xFFFFFFFFFFFFFFFF)
    for w in words:
        x = _splitmix64(x ^ (w & 0xFFFFFFFFFFFFFFFF))
    return x & MASK62


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic, cell file and the metrics it reports."""
    bench = read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = dict(cells[name])
    configs = {c["name"]: c for c in bench["configs"]}
    cell["cfg"] = read_json(ROOT / configs[cell["config"]]["file"])
    cell["traffic_mix"] = read_json(HERE / "traffic"
                                    / f"{cell['traffic']}.json")
    cell["file"] = read_json(HERE / "workloads" / f"{name}.json")

    def applies(m):
        return "workloads" not in m or name in m["workloads"]
    cell["end_to_end"] = [m for m in bench["end_to_end"] if applies(m)]
    cell["per_layer"] = [m for m in bench["per_layer"] if applies(m)]
    return cell


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


class Job:
    """What the window keeps of one job."""

    def __init__(self, index: int, seed: int):
        self.index, self.seed = index, seed
        self.failed, self.profiled = False, False
        self.wall_s = self.sampling_s = 0.0
        self.min_ess = 0.0
        self.steps_per_sampling_transition = 0.0
        self.step_size = self.tau = None
        self.mass = None
        self.engines = {}
        self.counts = []
        self.sampling_bound_s = 0.0
        self.draws = []  # (transition, walkers, q before, q after)
        self.moments = None  # [2, D] sums of the draws and their squares
        self.num_draws = 0


class Run:
    """One process's part of a run (rank ``rank`` of ``world``)."""

    def __init__(self, cell: dict, args, rank: int, world: int,
                 device=None):
        import torch
        self.torch = torch
        self.cell, self.args = cell, args
        self.cfg, self.traffic = cell["cfg"], cell["traffic_mix"]
        self.rank, self.world = rank, world
        # the card; only the tests drive a run on the CPU
        self.device = device or torch.device("cuda",
                                             torch.cuda.current_device())
        self.walkers = self.traffic["walkers"]
        self.local = self.walkers // world
        self.offset = rank * self.local
        self.mesh = None
        self.entry = load_module("entries", self.cfg["sampler"])
        self.model = load_module("configs", self.cfg["model"])
        self.port_model = load_module("ports", self.cfg["model"])
        self.count = load_module("counts", self.cfg["count"])
        self.jobs: list = []
        self.stages: dict = {}  # set-up's stages: host clock at each end
        self.trace = None
        self.setup_s = 0.0
        self.window_s = 0.0

    def peak_gb(self) -> float:
        if self.device.type != "cuda":
            return 0.0
        return self.torch.cuda.max_memory_allocated(self.device) / 1e9

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    # ---- collectives (outside every timed interval) --------------------
    def reduce(self, x, op="sum"):
        if self.world == 1:
            return x
        import torch.distributed as dist
        x = x.clone()
        dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op])
        return x

    def agree(self, value: float) -> float:
        """Rank 0's number, on every rank."""
        if self.world == 1:
            return value
        import torch.distributed as dist
        t = self.torch.tensor([value], dtype=self.torch.float64,
                              device=self.device)
        dist.broadcast(t, 0)
        return float(t[0])

    # ---- set-up ---------------------------------------------------------
    def setup(self, warm: bool = True) -> None:
        torch = self.torch
        if self.world > 1:
            from physicsbasedbayesianinference_tpu_torch.parallel import (
                initialize_distributed, make_walker_mesh)
            initialize_distributed(device=self.device.type)
            self.mesh = make_walker_mesh()
        self.data = self.model.make_data(self.cfg, derive(self.args.seed, 1),
                                         self.device)
        self.potential = self.port_model.potential(self.data, self.cfg,
                                                   self.device)
        gen = torch.Generator(device="cpu").manual_seed(
            derive(self.args.seed, 2))
        subset = torch.randperm(self.walkers, generator=gen)[:SUBSET]
        self.subset_total = int(subset.numel())
        mine = subset[(subset >= self.offset)
                      & (subset < self.offset + self.local)]
        self.subset = (mine - self.offset).sort().values.to(self.device)
        check = self.cell["file"]["check"]
        self.check_walkers = (torch.randperm(self.local, generator=gen)[
            :check["walkers"] // self.world].sort().values.to(self.device))
        # a short job at the cell's shapes: every kernel, the allocator's
        # blocks for the draws, the ESS's transforms
        self.stages["inputs"] = time.perf_counter()
        if warm:
            short = dict(self.traffic,
                         warmup=self.cell["file"]["setup_warmup"])
            self.run_job(-1, derive(self.args.seed, 3), short, keep=False)
            self.stages["short_job"] = time.perf_counter()

    # ---- one job ----------------------------------------------------------
    def init_q(self, seed: int):
        torch = self.torch
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self.model.init_q(self.cfg, self.walkers, gen)

    def run_job(self, index: int, seed: int, traffic: dict, keep=True,
                profile=False) -> Job:
        torch = self.torch
        job = Job(index, seed)
        q0 = self.init_q(derive(seed, 4))
        prof = None
        if profile:
            from torch.profiler import ProfilerActivity, profile as tprof
            prof = tprof(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])
            prof.__enter__()
        self.sync()
        t0 = time.perf_counter()
        try:
            with (torch.profiler.record_function("portbench.job")
                  if prof is not None else contextlib.nullcontext()):
                out = self.entry.call(seed, self.potential, q0, cfg=self.cfg,
                                      traffic=traffic, mesh=self.mesh,
                                      kernel=self.cfg["kernel"])
            self.sync()
        except Exception:  # a job that raises has failed
            print(f"job {index} failed:", file=sys.stderr)
            traceback.print_exc()
            job.failed, out = True, None
        job.wall_s = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        # where a rank's job failed, every rank leaves it here, before the
        # collectives of keep() and of the trace
        failed = self.torch.tensor([float(out is None)],
                                   dtype=self.torch.float64,
                                   device=self.device)
        if float(self.reduce(failed, "max")[0]) > 0:
            job.failed, out = True, None
        if out is None:
            return job
        job.sampling_s = float(out["sampling_seconds"])
        self.keep(job, out, traffic, keep)
        if self.rank == 0:
            print(f"job {index} wall_s {job.wall_s:.4f} sampling_s "
                  f"{job.sampling_s:.4f} min_ess {job.min_ess:.1f} steps "
                  f"{job.steps_per_sampling_transition:.3f} step_size "
                  f"{job.step_size:.5g} tau {job.tau} peak_gb "
                  f"{self.peak_gb():.2f}", file=sys.stderr)
        if prof is not None:
            from portbench import trace
            self.trace = trace.reduce(prof, job, self)
            busy = self.torch.tensor([self.trace["busy_s"]],
                                     dtype=self.torch.float64,
                                     device=self.device)
            self.trace["busy_s"] = float(self.reduce(busy)[0]) / self.world
            job.profiled = True
        return job

    def keep(self, job: Job, out: dict, traffic: dict, keep: bool) -> None:
        """Between jobs: the ESS, the finite check, what the check reads;
        then the draws are freed."""
        torch = self.torch
        samples = out.pop("samples")
        # draw by draw: isfinite over the whole [S, W, D] at once holds
        # temporaries of twice its size
        finite = torch.stack([torch.isfinite(x).all() for x in samples]
                             ).all().to(torch.float64).reshape(1)
        job.failed = bool(self.reduce(1.0 - finite)[0] > 0)
        job.min_ess = ess.min_ess(
            samples, self.subset, self.walkers, self.subset_total,
            self.reduce if self.world > 1 else None)
        job.step_size = float(out["step_size"])
        job.tau = None if out["tau"] is None else float(out["tau"])
        job.mass = out["mass"].detach().to(torch.float64).cpu()
        job.steps_per_sampling_transition = float(out["mean_num_steps"])
        job.engines = out["engines"]
        if "mass_gap" in self.cell["file"]["limits"]:
            # the draws' sums over every walker, for the metric's check
            job.moments = torch.zeros(2, samples.shape[2],
                                      dtype=torch.float64,
                                      device=samples.device)
            for x in samples:
                x = x.to(torch.float64)
                job.moments[0] += torch.sum(x, dim=0)
                job.moments[1] += torch.sum(x * x, dim=0)
            job.num_draws = samples.shape[0] * samples.shape[1]
        job.counts = self.entry.sampling_counts(self.cfg, traffic,
                                                job.step_size, job.tau)
        bound = {}
        for c in job.counts:
            n = c[0]
            if n not in bound:
                bound[n] = self.count.transition_bound_s(
                    self.local, samples.shape[2], n, self.cfg)
            job.sampling_bound_s += bound[n]
        if keep:
            gen = torch.Generator(device="cpu").manual_seed(
                derive(job.seed, 5))
            s = samples.shape[0]
            picks = torch.randperm(s - 1, generator=gen)[
                :self.cell["file"]["check"]["transitions"]] + 1
            w = self.check_walkers
            for t in picks.tolist():
                job.draws.append((t, w, samples[t - 1, w].clone(),
                                  samples[t, w].clone()))
        del samples, out

    # ---- the window --------------------------------------------------------
    def window(self) -> None:
        seconds = self.args.seconds
        j = 0
        profiled = False
        while True:
            start_s = self.agree(sum(x.wall_s for x in self.jobs))
            if self.jobs and start_s >= seconds:
                break
            profile = bool(self.args.trace and not profiled
                           and start_s >= seconds / 2)
            job = self.run_job(j, derive(self.args.seed, 100, j),
                               self.traffic, profile=profile)
            profiled = profiled or profile
            self.jobs.append(job)
            j += 1
            if self.agree(float(job.failed)):
                break  # the run is not correct; measure no further
        if self.args.trace and not profiled and not self.jobs[-1].failed:
            # a window shorter than two jobs: profile one more, which the
            # end-to-end metrics of a traced run leave out
            job = self.run_job(j, derive(self.args.seed, 100, j),
                               self.traffic, profile=True)
            self.jobs.append(job)
        self.window_s = sum(x.wall_s for x in self.jobs)

    # ---- the check ----------------------------------------------------------
    def group_settings(self, job: Job) -> None:
        """Rank 0's adapted step size, tau and metric on every rank: the
        sampler's are the group's, and a rank that adapted apart from the
        group draws apart from what the replay expects."""
        if self.world == 1:
            return
        torch = self.torch
        import torch.distributed as dist
        v = torch.cat((torch.tensor([job.step_size, job.tau or 0.0],
                                    dtype=torch.float64),
                       job.mass)).to(self.device)
        dist.broadcast(v, 0)
        v = v.cpu()
        job.step_size, job.mass = float(v[0]), v[2:]
        if job.tau is not None:
            job.tau = float(v[1])
        job.counts = self.entry.sampling_counts(self.cfg, self.traffic,
                                                job.step_size, job.tau)

    def check(self, jobs=None) -> dict:
        """The numbers compared with the plain reference (float64), those
        the cell file's ``limits`` name, each with its limit; the largest
        over the jobs and the ranks.

        ``draw_gap``: every kept draw's sampling transition replayed from
        the draw before it at the group's adapted step size, tau and
        metric, and the largest gap between a draw and the reference's,
        over the transition's scale (``reference.hmc.replay``).
        ``step_size_gap``: |log| of the adapted step size over the nearest
        one at which the kept transitions accept at the target rate.
        ``tau_gap``: |the ChEES criterion's slope| at the adapted tau.
        ``mass_gap``: the largest |log(mass var)| over the dims, var the
        draws' variance over every walker. ``engine_mismatch``: 1 where a
        phase ran another engine than the configuration states."""
        from portbench.reference import hmc as ref
        torch = self.torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        prec = ref.PRECISIONS["float64"]
        dt = prec.dtype
        vg = self.model.value_and_grad(self.data, prec)
        limits = dict(self.cell["file"]["limits"], engine_mismatch=0.0)
        warmup = self.traffic["warmup"]
        hal = ref.halton(warmup + self.traffic["samples"])
        target = self.cfg["sampler_kwargs"]["target_accept"]
        jobs = [j for j in (self.jobs if jobs is None else jobs)
                if not j.failed]
        worst = dict.fromkeys(("draw_gap", "step_size_gap", "tau_gap",
                               "mass_gap"), 0.0)

        def most(name, value):
            worst[name] = max(worst[name], value)
        for job in jobs:
            self.group_settings(job)
            mass = job.mass.to(self.device, dt)
            inv_mass = 1.0 / mass
            kept = []
            for t, w, before, after in job.draws:
                g = ref.replay(vg, job.seed, warmup + t, w + self.offset,
                               before, after, torch.tensor(job.step_size),
                               mass, job.counts[t], prec)
                most("draw_gap", float(torch.amax(g)))
                q = before.to(dt)
                kept.append(ref.Kept(
                    warmup + t, w + self.offset, q, *vg(q),
                    float(hal[warmup + t]),
                    ref.noise(job.seed, warmup + t, w + self.offset,
                              q.shape[1], dt)))
            count = self.entry.reference_count(self.cfg, job.tau)
            if "step_size_gap" in limits and kept:
                eps = ref.target_step_size(vg, job.seed, kept, job.step_size,
                                           inv_mass, count, target, prec)
                most("step_size_gap", abs(math.log(job.step_size / eps)))
            if "tau_gap" in limits and kept:
                most("tau_gap", abs(ref.chees_slope(
                    vg, job.seed, kept, job.step_size, inv_mass, count,
                    prec)))
            if "mass_gap" in limits:
                most("mass_gap", ref.metric_gap(
                    mass, self.reduce(job.moments.to(self.device)),
                    job.num_draws * self.world))
        names = [k for k in worst if k in limits]
        got = self.reduce(torch.tensor([worst[k] for k in names],
                                       dtype=torch.float64,
                                       device=self.device), "max")
        numbers = dict(zip(names, got.tolist()))
        numbers["engine_mismatch"] = float(not all(
            j.engines.get(k) == v for j in jobs
            for k, v in self.cfg["engine"].items()))
        return {k: {"value": v, "limit": limits[k]}
                for k, v in numbers.items()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(args, world: int) -> list:
    """Ranks 1 .. world - 1 as processes of their own, one card each; this
    process is rank 0. They meet at a port of this host chosen now."""
    port = _free_port()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK="0", LOCAL_RANK="0")
    procs = []
    for r in range(1, world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, str(HERE / "run.py"), "--workload",
             args.workload, "--seed", str(args.seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace), "--rank",
             str(r)], env=env, stdout=subprocess.DEVNULL))
    return procs


def _stop_ranks(procs: list, failed: bool) -> bool:
    """Wait for every rank; end them where this one failed. True where all
    ended with code 0."""
    ok = True
    for p in procs:
        try:
            if failed:
                p.terminate()
            p.wait(timeout=120 if not failed else 30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        ok = ok and p.returncode == 0
    return ok


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def result_line(run: Run, checks: dict, trace: bool) -> dict:
    torch = run.torch
    metrics = {}
    for m in (run.cell["per_layer"] if trace else run.cell["end_to_end"]):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(j.failed for j in run.jobs)
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    cuda = run.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": (torch.cuda.get_device_name(run.device) if cuda
                       else "cpu"),
              "count": run.world, "memory_peak_bytes": run.peak,
              "power_limit": power_limit() if cuda else ""}
    line = {"correct": correct, "attempted": len(run.jobs),
            "failed": failed, "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        line["breakdown"] = run.trace["breakdown"]
    line["checks"] = checks
    return line


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = load_cell(args.workload)
    world = int(cell["chips"])
    import torch
    t_torch = time.perf_counter()
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < world:
        print(f"portbench: the cell wants {world} CUDA device(s), found "
              f"{found}: no result", file=sys.stderr)
        return 2
    procs = _start_ranks(args, world) if world > 1 and args.rank == 0 else []
    torch.cuda.set_device(args.rank)
    line = None
    try:
        run = Run(cell, args, args.rank, world)
        run.setup()
        run.setup_s = time.perf_counter() - t_start
        if args.rank == 0:
            stages = dict(torch_imported=t_torch, **run.stages)
            print("setup_s %.3f stages %s" % (run.setup_s, json.dumps(
                {k: round(v - t_start, 3) for k, v in stages.items()})),
                file=sys.stderr)
        run.window()
        peak = torch.tensor([float(torch.cuda.max_memory_allocated())],
                            dtype=torch.float64, device=run.device)
        run.peak = int(run.reduce(peak, "max")[0])
        run.potential = None
        torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = run.check()
        if args.rank == 0:
            print(f"check_s {time.perf_counter() - t_check:.3f}",
                  file=sys.stderr)
        # every rank looks, once the window has closed
        bad = forbidden_modules()
        if bad:
            print(f"portbench: rank {args.rank} loaded {bad}: a run loads "
                  f"neither JAX nor the JAX package", file=sys.stderr)
        flag = torch.tensor([float(bool(bad))], dtype=torch.float64,
                            device=run.device)
        any_bad = float(run.reduce(flag, "max")[0]) > 0
        line = (result_line(run, checks, bool(args.trace))
                if args.rank == 0 else {})
    finally:
        if line is not None:  # every rank leaves the group together
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()
        ranks_ok = _stop_ranks(procs, failed=line is None)
    if args.rank != 0:
        return 0
    if not ranks_ok:
        print("portbench: a rank failed: no result", file=sys.stderr)
        return 3
    if any_bad:
        print("portbench: a rank loaded JAX or the JAX package: no result",
              file=sys.stderr)
        return 4
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
