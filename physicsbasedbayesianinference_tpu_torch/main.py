"""CLI driver: config -> model -> sampler -> metrics + saved samples (port
of the JAX package's ``main.py``). Usage:

    python -m physicsbasedbayesianinference_tpu_torch.main --config run.json
    python -m physicsbasedbayesianinference_tpu_torch.main \
        --model example:eight_schools_noncentered \
        --data-path examples/eight_schools.data.json --sampler chees \
        --num-walkers 102400

Every tensor of a run lives on ``--device`` (``cuda`` by default; without a
card the run raises unless ``--device cpu`` is given). The JSON summary
goes to standard output; progress lines starting with ``#`` go to standard
error, among them ``# launches {...}``: the fused kernels' launches in the
run (``ops.kernels.launch_counts``).

Model references:
  builtin:<name>   analytic target from ops.potentials.builtin_potentials
  example:<name>   model of the DSL from models.examples, with --data-path
                   JSON (the reference's data-file convention); every
                   example model runs inside the fused kernels on CUDA, and
                   so do the centred eight schools and the funnel under
                   --reparam auto (models/device_forms.py)

``numpyro:`` references are the JAX package's only: NumPyro is JAX.

``sharded=True`` runs one process per device, each on its block of the
walkers, for every sampler (hmc with either metric, chees, nuts, smc, and
pt with its walkers sharded and every rung on every rank), checkpointed
(one file a rank and step) and in stream mode (rank 0 writes the sample
file):

    python -m torch.distributed.run --nproc_per_node=K \
        -m physicsbasedbayesianinference_tpu_torch.main --config run.json

Every rank draws the same global initial positions and keeps its block;
the summary, the ``#`` lines and the ``.npz`` come from rank 0 (its
samples gathered from every rank). Started without a launcher it runs as
a group of one process. Each rank runs the fused kernels on its block
where the engine rule finds one (the JAX package's sharded runs other
than hmc go through GSPMD with its composed engine).

Randomness: the run draws its initial positions from a seed derived from
``seed`` and runs the sampler with key ``seed``; transition ``t`` (warmup
first) uses ``(seed, t)`` in every path, so a checkpointed run and a
stream run step through the transitions of the uninterrupted ``run_*``
call with the same seed and initial positions, and end in its state bit
for bit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import json
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import diagnostics
from .config import RunConfig
from .constants import NATURAL, SI, Constants
from .hmc import _splitmix64, _synchronize, resolve_engine
from .ops import kernels
from .parallel.mesh import gather_rows, gather_walkers

# Version of the checkpoint payload's structure; restore rejects another.
CHECKPOINT_SCHEMA = 1


def _run_device(cfg: RunConfig) -> torch.device:
    """``cfg.device``, refusing a CUDA device where torch finds none."""
    device = torch.device(cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise ValueError(
            f"device={cfg.device!r}, but torch finds no CUDA device; pass "
            f"--device cpu (RunConfig(device='cpu')) to run on the CPU")
    return device


def _load_data(path: Optional[str], device) -> dict:
    """A data JSON: lists become float32 tensors on ``device``, other
    values (integer metadata such as eight schools' J) stay Python."""
    if path is None:
        return {}
    with open(path) as f:
        raw = json.load(f)
    return {k: (torch.as_tensor(np.asarray(v, dtype=np.float32),
                                device=device) if isinstance(v, list) else v)
            for k, v in raw.items()}


def _reparam_config(cfg: RunConfig):
    """RunConfig.reparam string -> make_model_potential's reparam argument:
    "" -> None (off), "auto" -> automatic non-centering, else a
    comma-separated site-name list."""
    if not cfg.reparam:
        return None
    if cfg.reparam == "auto":
        return "auto"
    return [s.strip() for s in cfg.reparam.split(",") if s.strip()]


def build_potential(cfg: RunConfig):
    """The config's model reference -> ``(potential_fn, init_fn, constrain_fn
    or None)``, its parameters and data on ``cfg.device``; ``init_fn(seed,
    num_walkers)`` gives initial positions there."""
    device = _run_device(cfg)
    kind, _, name = cfg.model.partition(":")
    if kind == "builtin":
        from .ops.potentials import builtin_potentials
        registry = builtin_potentials(device)
        if name not in registry:
            raise ValueError(
                f"unknown builtin {name!r}; have {sorted(registry)}")
        fn = registry[name]()
        num_dims = {"std_normal_2d": 2, "std_normal_32d": 32, "banana": 2,
                    "funnel_10d": 10}.get(name, 2)

        def init(seed: int, w: int) -> torch.Tensor:
            gen = torch.Generator(device=device).manual_seed(seed)
            return torch.randn(w, num_dims, generator=gen, device=device)
        return fn, init, None
    if kind == "example":
        from .models import make_model_potential
        from .models.examples import EXAMPLE_MODELS
        if name not in EXAMPLE_MODELS:
            raise ValueError(
                f"unknown example {name!r}; have {sorted(EXAMPLE_MODELS)}")
        # data files may carry keys the model does not take (the
        # reference's coin-toss data records the true biases): pass only
        # what the model's signature accepts
        params = inspect.signature(EXAMPLE_MODELS[name]).parameters
        data = {k: v for k, v in _load_data(cfg.data_path, device).items()
                if k in params}
        mp = make_model_potential(EXAMPLE_MODELS[name], (), data,
                                  reparam=_reparam_config(cfg),
                                  device=device)
        return mp.potential, mp.init, mp.constrain_samples
    if kind == "numpyro":
        raise ValueError(
            "numpyro: models run in the JAX package only (NumPyro is JAX); "
            "write the model in the DSL (models/) and use example:")
    raise ValueError(f"bad model reference {cfg.model!r} "
                     f"(want builtin:/example:)")


@dataclasses.dataclass
class RunInputs:
    """What a run starts from: the potential, the initial positions on the
    run's device, the sampler's seed, the constrain map and the
    constants."""

    potential: Callable
    init_q: torch.Tensor
    seed: int
    constrain: Optional[Callable]
    constants: Constants


def prepare(cfg: RunConfig) -> RunInputs:
    """The potential and initial positions of ``cfg``'s run, as
    :func:`run` draws them."""
    cfg.check()
    constants = {"natural": NATURAL, "si": SI}[cfg.constants]
    potential_fn, init_fn, constrain = build_potential(cfg)
    init_q = init_fn(_splitmix64(cfg.seed ^ 0x1D1A5EED) >> 1, cfg.num_walkers)
    return RunInputs(potential_fn, init_q, cfg.seed, constrain, constants)


def _list(x) -> list:
    return torch.as_tensor(x).detach().cpu().tolist()


def _launches() -> dict:
    return dict(kernels.launch_counts(),
                fused_hmc_transition_by=dict(
                    kernels.fused_hmc_transition.launches_by),
                fused_hmc_transition_by_layout=dict(
                    kernels.fused_hmc_transition.launches_by_layout))


def _walker_mesh(cfg: RunConfig):
    """The walker group of a sharded run: the launcher's
    (``parallel.initialize_distributed``), the caller's if it made one, or
    else a group of this one process."""
    import torch.distributed as dist
    from .parallel import initialize_distributed, make_walker_mesh
    device = _run_device(cfg)
    initialize_distributed(device=device.type)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    mesh = make_walker_mesh()
    if mesh.device.type != device.type:
        raise ValueError(f"device={cfg.device!r}, but the process group's "
                         f"backend serves {mesh.device.type} tensors")
    return mesh


def run(cfg: RunConfig) -> dict:
    """Execute the configured run; returns the result summary dict. With
    ``sharded=True`` this process is one rank (module docstring): rank 0's
    summary holds the posterior summary, and only rank 0 writes."""
    cfg.check()
    mesh = _walker_mesh(cfg) if cfg.sharded else None
    lead = mesh is None or mesh.rank == 0
    inputs = prepare(cfg)
    q0 = inputs.init_q
    if lead:
        print(f"# model={cfg.model} sampler={cfg.sampler} "
              f"walkers={cfg.num_walkers} dims={q0.shape[-1]} "
              f"device={q0.device} devices={1 if mesh is None else mesh.size}",
              file=sys.stderr)
    before = _launches()
    t0 = time.perf_counter()
    summary: dict = {"config": dataclasses.asdict(cfg)}
    if cfg.collect == "stream":
        summary.update(_stream_run(cfg, inputs, mesh))
    elif cfg.sampler == "smc" and cfg.checkpoint_dir:
        summary.update(_checkpointed_smc_run(cfg, inputs, mesh))
    elif cfg.sampler in ("hmc", "nuts", "chees", "pt") and cfg.checkpoint_dir:
        summary.update(_checkpointed_run(cfg, inputs, mesh))
    else:
        samples = _sample(cfg, inputs, summary, mesh)
        summary["wall_seconds"] = round(time.perf_counter() - t0, 3)
        if samples is not None and mesh is not None:
            whole = gather_walkers(samples.transpose(0, 1), mesh, dst=0)
            samples = (None if whole is None
                       else whole.transpose(0, 1).contiguous())
        if samples is not None:
            _summarize(samples, inputs.constrain, summary)
        if cfg.output_path and lead:
            arrays = {"summary": json.dumps(summary)}
            if samples is not None:
                arrays["samples"] = samples.cpu().numpy()
            np.savez_compressed(cfg.output_path, **arrays)
            print(f"# wrote {cfg.output_path}", file=sys.stderr)
    summary.setdefault("wall_seconds", round(time.perf_counter() - t0, 3))
    after = _launches()
    if lead:  # the counts and the counts by variant and layout, this run's
        print("# launches " + json.dumps({
            k: ({c: n - before[k][c] for c, n in v.items()}
                if isinstance(v, dict) else v - before[k])
            for k, v in after.items()}), file=sys.stderr)
    return summary


def _sample(cfg: RunConfig, inputs: RunInputs, summary: dict, mesh=None):
    """One uninterrupted ``run_*`` call; fills ``summary``, returns the
    samples ``[S, W, D]`` (with ``mesh``, this rank's ``[S, W / K, D]``) or
    None."""
    pot, q0, seed = inputs.potential, inputs.init_q, inputs.seed
    common = dict(temperature=cfg.temperature, constants=inputs.constants)
    if cfg.sampler == "hmc":
        kw = dict(num_warmup=cfg.num_warmup, num_samples=cfg.num_samples,
                  num_steps=cfg.num_steps, init_step_size=cfg.init_step_size,
                  target_accept=cfg.target_accept, adapt_mass=cfg.adapt_mass,
                  collect=cfg.collect, thin=cfg.thin, kernel=cfg.kernel,
                  **common)
        if mesh is not None:
            from .parallel.sharded import sharded_run_hmc
            res = sharded_run_hmc(seed, pot, q0, mesh=mesh,
                                  metric=cfg.metric, **kw)
        else:
            from .hmc import run_hmc
            res = run_hmc(seed, pot, q0, metric=cfg.metric, **kw)
        summary.update(
            accept_rate=float(res.accept_rate),
            divergence_rate=float(res.divergence_rate),
            step_size=float(res.step_size),
            num_grad_evals=res.num_grad_evals,
            kernel_used=res.kernel_used,
            kernel_variant=res.kernel_variant,
            sampling_seconds=round(res.sampling_seconds, 3))
    elif cfg.sampler == "nuts":
        from .nuts import run_nuts
        res = run_nuts(
            seed, pot, q0, num_warmup=cfg.num_warmup,
            num_samples=cfg.num_samples, max_depth=cfg.max_depth,
            init_step_size=cfg.init_step_size,
            target_accept=cfg.target_accept, adapt_mass=cfg.adapt_mass,
            # NUTS streams no moments: the JAX run_nuts keeps no samples
            collect="samples" if cfg.collect == "samples" else "none",
            mesh=mesh, **common)
        summary.update(
            accept_rate=float(res.accept_rate),
            divergence_rate=float(res.divergence_rate),
            mean_tree_depth=float(res.mean_depth),
            step_size=float(res.step_size))
    elif cfg.sampler == "chees":
        from .chees import run_chees_hmc
        res = run_chees_hmc(
            seed, pot, q0, num_warmup=cfg.num_warmup,
            num_samples=cfg.num_samples, init_step_size=cfg.init_step_size,
            target_accept=cfg.target_accept, kernel=cfg.kernel,
            collect=cfg.collect, mesh=mesh, **common)
        summary.update(
            accept_rate=float(res.accept_rate),
            divergence_rate=float(res.divergence_rate),
            step_size=float(res.step_size),
            trajectory_time=float(res.trajectory_time),
            mean_num_steps=float(res.mean_num_steps),
            kernel_used=res.kernel_used,
            warmup_kernel_used=res.warmup_kernel_used)
    elif cfg.sampler == "pt":
        from .tempering import run_parallel_tempering
        res = run_parallel_tempering(
            seed, pot, q0, num_replicas=cfg.pt_replicas,
            beta_min=cfg.pt_beta_min, num_warmup=cfg.num_warmup,
            num_samples=cfg.num_samples, num_steps=cfg.num_steps,
            init_step_size=cfg.init_step_size,
            target_accept=cfg.target_accept, kernel=cfg.kernel,
            collect=cfg.collect, mesh=mesh, **common)
        summary.update(
            accept_rates=_list(res.accept_rate),
            swap_rates=_list(res.swap_rate),
            step_sizes=_list(res.step_sizes),
            betas=_list(res.betas),
            kernel_used=res.kernel_used)
    elif cfg.sampler == "smc":
        from .smc import run_smc
        res = run_smc(
            seed, pot, q0, num_mutation_steps=3,
            num_leapfrog_steps=cfg.num_steps,
            init_step_size=cfg.init_step_size, beta0=cfg.smc_beta0,
            max_stages=cfg.smc_max_stages, kernel=cfg.kernel, mesh=mesh,
            **common)
        summary.update(
            log_evidence=float(res.log_evidence),
            num_stages=int(res.num_stages),
            final_step_size=float(res.final_step_size))
        return res.q[None]
    else:
        raise ValueError(f"unknown sampler {cfg.sampler!r}")
    if getattr(res, "mean", None) is not None:
        summary["posterior_mean"] = _list(res.mean)
        summary["posterior_var"] = _list(res.var)
    return res.samples


def _summarize(samples: torch.Tensor, constrain, summary: dict) -> None:
    """The posterior summary of ``samples`` ``[T, W, D]`` into ``summary``.
    ESS and split-R-hat need two draws a walker: SMC's one final ensemble
    gets None for both (the JAX package's ``split_rhat`` divides by zero
    there)."""
    diag = diagnostics.summary(samples) if samples.shape[0] >= 2 else {
        "mean": torch.mean(samples, dim=(0, 1)),
        "sd": torch.std(samples.reshape(-1, samples.shape[-1]), dim=0,
                        correction=0)}
    summary["posterior_mean"] = _list(diag["mean"])
    summary["posterior_sd"] = _list(diag["sd"])
    summary["min_ess"] = (float(torch.min(diag["ess"])) if "ess" in diag
                          else None)
    summary["max_rhat"] = (float(torch.max(diag["rhat"])) if "rhat" in diag
                           else None)
    if constrain is not None:
        summary["constrained_means"] = {
            k: _list(torch.mean(v, dim=(0, 1)))
            for k, v in constrain(samples).items()}


# ---------------------------------------------------------------------------
# Checkpointed runs
# ---------------------------------------------------------------------------


def _schema_error(cfg: RunConfig, step, cause: Exception) -> RuntimeError:
    return RuntimeError(
        f"checkpoint at step {step} in {cfg.checkpoint_dir} does not match "
        f"the current payload schema (v{CHECKPOINT_SCHEMA}) or run config: "
        f"{cause}. Delete the directory or point checkpoint_dir elsewhere "
        f"to start fresh.")


def _restore(cfg: RunConfig, mgr, template: dict, latest: int) -> dict:
    try:
        payload = mgr.restore(template, latest)
    except ValueError as e:
        raise _schema_error(cfg, latest, e) from e
    if payload["schema"] != CHECKPOINT_SCHEMA:
        raise RuntimeError(
            f"checkpoint schema v{payload['schema']} in {cfg.checkpoint_dir}"
            f" != current v{CHECKPOINT_SCHEMA}; delete the directory to "
            f"start fresh")
    if _leads(mgr.mesh):
        print(f"# resumed from checkpoint step {latest} in "
              f"{cfg.checkpoint_dir}", file=sys.stderr)
    return payload


def _leads(mesh) -> bool:
    """Whether this process prints and writes: rank 0 of a sharded run."""
    return mesh is None or mesh.rank == 0


def _save(mgr, step: int, payload: dict, chunk_ms: float) -> None:
    """Save ``payload`` as ``step`` and print its size and times (a
    sharded run: rank 0's file)."""
    t0 = time.perf_counter()
    with diagnostics.trace_annotation("checkpoint_save"):
        mgr.save(step, payload, force=True)
    save_ms = 1e3 * (time.perf_counter() - t0)
    if _leads(mgr.mesh):
        print("# checkpoint " + json.dumps({
            "step": step, "bytes": os.path.getsize(mgr.file(step)),
            "save_ms": save_ms, "chunk_ms": chunk_ms}), file=sys.stderr)


def _sampler_pieces(cfg: RunConfig, inputs: RunInputs, mesh=None):
    """For hmc, nuts, chees and pt: ``(warm, tstep, template, get_q)``.
    ``warm()`` runs the warmup of the sampler's ``run_*`` (``num_samples=
    0``) and returns ``(state, step size, tau)``; ``tstep(i, state,
    step_size, tau)`` is sampling transition ``i`` as that ``run_*`` takes
    it (key ``(seed, num_warmup + i)``) and returns ``(state, mean accept
    probability)``; ``template`` is a state of the right shapes;
    ``get_q(state)`` the positions whose moments are streamed. With
    ``mesh`` the states are this rank's block, and the steps draw as the
    rank's part of the whole ensemble, as the sharded ``run_*`` does."""
    pot, q0, seed = inputs.potential, inputs.init_q, inputs.seed
    num_dims, dtype, device = q0.shape[-1], q0.dtype, q0.device
    common = dict(temperature=cfg.temperature, constants=inputs.constants)
    warm_kw = dict(num_warmup=cfg.num_warmup, num_samples=0,
                   init_step_size=cfg.init_step_size,
                   target_accept=cfg.target_accept, collect="none", **common)
    zero = torch.zeros((), dtype=dtype, device=device)
    t0 = cfg.num_warmup
    block = q0 if mesh is None else q0[mesh.block(q0.shape[0])].contiguous()

    def get_q(st):
        return st.ensemble.q

    if cfg.sampler == "hmc":
        from .hmc import build_fused_hmc_kernel, build_hmc_kernel, run_hmc
        if cfg.metric != "diag":
            raise ValueError("metric='dense' has no checkpointed path; run "
                             "it without checkpoint_dir")
        build = (build_fused_hmc_kernel
                 if resolve_engine(cfg.kernel, pot, q0) == "fused"
                 else build_hmc_kernel)
        kern = build(pot, num_steps=cfg.num_steps, **common)
        if mesh is not None:
            from .parallel.sharded import shard_map_kernel
            kern = shard_map_kernel(kern, mesh)

        def warm():
            w = run_hmc(seed, pot, block, num_steps=cfg.num_steps,
                        adapt_mass=cfg.adapt_mass, kernel=kern, **warm_kw)
            return w.state, w.step_size, zero

        def tstep(i, st, eps, tau):
            st, info = kern.step((seed, t0 + i), st, eps)
            return st, torch.mean(info.accept_prob)
        return warm, tstep, kern.init(block), get_q
    if cfg.sampler == "nuts":
        from .nuts import build_nuts_kernel, run_nuts
        kern = build_nuts_kernel(pot, max_depth=cfg.max_depth, mesh=mesh,
                                 **common)

        def warm():
            w = run_nuts(seed, pot, q0, max_depth=cfg.max_depth,
                         adapt_mass=cfg.adapt_mass, mesh=mesh, **warm_kw)
            return w.state, w.step_size, zero

        def tstep(i, st, eps, tau):
            st, info = kern.step((seed, t0 + i), st, eps)
            return st, torch.mean(info.accept_prob)
        return warm, tstep, kern.init(block), get_q
    if cfg.sampler == "chees":
        from .chees import (DEFAULT_MAX_STEPS, build_fused_jittered_step,
                            build_jittered_hmc_kernel, halton_sequence,
                            run_chees_hmc, steps_for)
        max_steps = DEFAULT_MAX_STEPS  # run_chees_hmc's, in both phases
        init_fn, step_fn = build_jittered_hmc_kernel(
            pot, max_steps=max_steps, **common)
        fused = (build_fused_jittered_step(
            pot, num_dims=num_dims, max_steps=max_steps, **common)
            if resolve_engine(cfg.kernel, pot, q0) == "fused" else None)
        # the Halton draws run_chees_hmc would take for the whole run
        halton = torch.as_tensor(halton_sequence(
            cfg.num_warmup + cfg.num_samples)).to(device=device, dtype=dtype)
        offset, composed_seed = 0, seed
        if mesh is not None:
            from .parallel.sharded import fold_rank
            offset = mesh.rank * block.shape[0]
            composed_seed = fold_rank(seed, mesh.rank)

        def warm():
            w = run_chees_hmc(seed, pot, q0, max_steps=max_steps,
                              kernel=cfg.kernel, mesh=mesh, **warm_kw)
            return w.state, w.step_size, w.trajectory_time

        def tstep(i, st, eps, tau):
            n = steps_for(tau, halton[t0 + i], eps, max_steps)
            if fused is not None:
                st, info = fused((seed, t0 + i), st, eps, n,
                                 walker_offset=offset)
            else:
                st, info, _ = step_fn((composed_seed, t0 + i), st, eps, n)
            return st, torch.mean(info.accept_prob)
        return warm, tstep, init_fn(block), get_q
    # pt: the replicas' (q, u, g); per-replica step sizes; with a mesh its
    # walkers are sharded and every rung is on every rank
    from .tempering import (build_pt_transition, geometric_ladder,
                            run_parallel_tempering)
    betas = geometric_ladder(cfg.pt_replicas, cfg.pt_beta_min, dtype, device)
    transition, _, _ = build_pt_transition(
        pot, betas=betas, num_dims=num_dims, num_steps=cfg.num_steps,
        kernel=cfg.kernel, dtype=dtype, device=device, mesh=mesh, **common)

    def warm():
        w = run_parallel_tempering(
            seed, pot, q0, betas=betas, num_steps=cfg.num_steps,
            kernel=cfg.kernel, mesh=mesh, **warm_kw)
        return {"q": w.q, "u": w.u, "g": w.g}, w.step_sizes, zero

    def tstep(i, st, eps, tau):
        q, u, g, acc, _ = transition((seed, t0 + i), st["q"], st["u"],
                                     st["g"], eps, i)
        return {"q": q, "u": u, "g": g}, torch.mean(acc)

    r, w_b = betas.shape[0], block.shape[0]
    template = {"q": torch.zeros((r, w_b, num_dims), dtype=dtype,
                                 device=device),
                "u": torch.zeros((r, w_b), dtype=dtype, device=device),
                "g": torch.zeros((r, w_b, num_dims), dtype=dtype,
                                 device=device)}
    return warm, tstep, template, lambda st: st["q"][0]


def _checkpointed_run(cfg: RunConfig, inputs: RunInputs, mesh=None) -> dict:
    """Fault-tolerant sampling for hmc, nuts, chees and pt: warmup once,
    then sample in chunks of ``checkpoint_every`` transitions (the last
    chunk shorter where the count does not divide), saving {schema, state,
    step size, tau, streamed mean, m2, n} after each chunk. Re-running the
    same config against the same ``checkpoint_dir`` resumes from the
    latest checkpoint; ``num_samples`` may grow between runs. Collection
    is streaming moments. Nothing inside a chunk reads the device: the
    device is waited for after the chunk, and the save copies the state
    to the host.

    With ``mesh`` each rank saves its block (``CheckpointManager(mesh=)``)
    and the streamed moments are the group's: a transition all-reduces the
    ranks' batch means and variances (and acceptances), which every rank
    merges in rank order, so the saved moments are alike on every rank and
    a fresh group of the same size resumes them bit for bit."""
    from .checkpoint import CheckpointManager

    q0 = inputs.init_q
    num_dims, dtype, device = q0.shape[-1], q0.dtype, q0.device
    every = (cfg.checkpoint_every if cfg.checkpoint_every > 0
             else cfg.num_samples)
    warm, tstep, template, get_q = _sampler_pieces(cfg, inputs, mesh)

    def canonical(state):
        # restore templates need one mass shape: always per-dim [D]
        if isinstance(state, dict):
            return state
        mass = torch.broadcast_to(state.ensemble.mass.to(dtype), (num_dims,))
        return state.replace(ensemble=state.ensemble.replace(
            mass=mass.contiguous()))

    def merge(mean, m2, n, batch_var, batch_mean, w):
        n_new = n + w
        delta = batch_mean - mean
        mean = mean + delta * (w / n_new)
        m2 = m2 + batch_var * w + delta**2 * (n * w / n_new)
        return mean, m2, n_new

    zeros = torch.zeros((num_dims,), dtype=dtype, device=device)
    mgr = CheckpointManager(cfg.checkpoint_dir, mesh=mesh)
    latest = mgr.latest_step()
    if latest is None:
        state, step_size, tau = warm()
        payload = {"schema": CHECKPOINT_SCHEMA, "state": canonical(state),
                   "step_size": step_size, "tau": tau, "mean": zeros,
                   "m2": zeros, "n": 0}
        done, resumed_from = 0, None
    else:
        ss = (torch.zeros((cfg.pt_replicas,), dtype=dtype, device=device)
              if cfg.sampler == "pt" else torch.zeros((), dtype=dtype,
                                                      device=device))
        payload = _restore(cfg, mgr, {
            "schema": 0, "state": canonical(template), "step_size": ss,
            "tau": ss.new_zeros(()), "mean": zeros, "m2": zeros, "n": 0},
            latest)
        done = resumed_from = latest

    state, step_size, tau = (payload["state"], payload["step_size"],
                             payload["tau"])
    mean, m2, n = payload["mean"], payload["m2"], payload["n"]
    accs = []
    saves = 0
    while done < cfg.num_samples:
        count = min(every, cfg.num_samples - done)
        t0 = time.perf_counter()
        with diagnostics.trace_annotation("checkpoint_chunk"):
            for i in range(done, done + count):
                state, acc = tstep(i, state, step_size, tau)
                q = get_q(state)
                batch_var, batch_mean = torch.var_mean(q, dim=0,
                                                       correction=0)
                rows = gather_rows(torch.cat((acc.reshape(1), batch_var,
                                              batch_mean)), mesh)
                accs.append(torch.sum(rows[:, 0]) / rows.shape[0])
                for row in rows:  # rank by rank
                    mean, m2, n = merge(mean, m2, n, row[1:1 + num_dims],
                                        row[1 + num_dims:], q.shape[0])
        _synchronize(device)
        chunk_ms = 1e3 * (time.perf_counter() - t0)
        done += count
        payload = {"schema": CHECKPOINT_SCHEMA, "state": canonical(state),
                   "step_size": step_size, "tau": tau, "mean": mean,
                   "m2": m2, "n": n}
        _save(mgr, done, payload, chunk_ms)
        saves += 1
    mgr.close()

    var = m2 / max(n - 1.0, 1.0)
    return {
        "accept_rate": (float(torch.mean(torch.stack(accs))) if accs
                        else None),
        "step_size": (float(step_size) if step_size.ndim == 0
                      else _list(step_size)),
        "posterior_mean": _list(mean),
        "posterior_var": _list(var),
        "samples_done": int(done),
        "resumed_from": resumed_from,
        "checkpoints_written": saves,
    }


def _checkpointed_smc_run(cfg: RunConfig, inputs: RunInputs,
                          mesh=None) -> dict:
    """Fault-tolerant SMC: the stage is the recovery grain (the tempering
    ladder is adaptive). ``smc.build_smc_machinery``'s carry is saved
    after every stage; its randomness is keyed by ``(seed, stage)``, so a
    run resumed from any stage reproduces the uninterrupted run's
    remaining stages bit for bit. With ``mesh`` the carry's walker-leading
    fields are the rank's block, one file a rank, and the posterior
    summary is taken on rank 0 of the ranks' final blocks gathered
    there."""
    from .checkpoint import CheckpointManager
    from .smc import build_smc_machinery

    q0 = inputs.init_q
    m = build_smc_machinery(
        inputs.potential, q0.shape[0], q0.dtype, num_dims=q0.shape[1],
        num_mutation_steps=3, num_leapfrog_steps=cfg.num_steps,
        init_step_size=cfg.init_step_size, beta0=cfg.smc_beta0,
        max_stages=cfg.smc_max_stages, temperature=cfg.temperature,
        constants=inputs.constants, kernel=cfg.kernel, device=q0.device,
        mesh=mesh)
    mgr = CheckpointManager(cfg.checkpoint_dir, mesh=mesh)
    carry = m["init_carry"](inputs.seed, q0)
    latest = mgr.latest_step()
    resumed_from = None
    if latest is not None:
        carry = _restore(cfg, mgr, {"schema": 0, "carry": carry},
                         latest)["carry"]
        resumed_from = latest
    saves = 0
    while m["cond"](carry):
        t0 = time.perf_counter()
        with diagnostics.trace_annotation("checkpoint_chunk"):
            carry = m["body"](carry)
        _synchronize(q0.device)
        _save(mgr, carry.stage, {"schema": CHECKPOINT_SCHEMA, "carry": carry},
              1e3 * (time.perf_counter() - t0))
        saves += 1
    res = m["finalize"](carry)
    mgr.close()
    q = res.q
    if mesh is not None:
        q = gather_walkers(q, mesh, dst=0)
    return {
        "log_evidence": float(res.log_evidence),
        "num_stages": int(res.num_stages),
        "final_step_size": float(res.final_step_size),
        "posterior_mean": None if q is None else _list(q.mean(0)),
        "posterior_var": None if q is None else _list(q.var(0, correction=1)),
        "resumed_from": resumed_from,
        "checkpoints_written": saves,
    }


def _stream_run(cfg: RunConfig, inputs: RunInputs, mesh=None) -> dict:
    """HMC warmup, then every ``thin``-th sampling transition's positions
    appended to a :class:`~.native.SampleSink` at ``output_path``: one
    device-to-host copy per recorded draw. The engine is ``cfg.kernel``'s
    (``hmc.resolve_engine``), in warmup and sampling alike. With ``mesh``
    each recorded draw goes to rank 0 in one gather, and rank 0 alone
    opens and writes the file: its rows are the whole ensemble's in
    walker order, as one process writes them."""
    from .hmc import build_fused_hmc_kernel, build_hmc_kernel, run_hmc
    from .native import SampleSink, read_samples

    if not cfg.output_path:
        raise ValueError("collect='stream' requires output_path")
    if cfg.sampler != "hmc" or cfg.metric != "diag":
        raise ValueError(
            f"collect='stream' runs sampler='hmc' with metric='diag'; got "
            f"sampler={cfg.sampler!r}, metric={cfg.metric!r}")
    pot, q0, seed = inputs.potential, inputs.init_q, inputs.seed
    common = dict(temperature=cfg.temperature, constants=inputs.constants)
    build = (build_fused_hmc_kernel
             if resolve_engine(cfg.kernel, pot, q0) == "fused"
             else build_hmc_kernel)
    kern = build(pot, num_steps=cfg.num_steps, **common)
    block = q0
    if mesh is not None:
        from .parallel.sharded import shard_map_kernel
        kern = shard_map_kernel(kern, mesh)
        block = q0[mesh.block(q0.shape[0])].contiguous()
    warm = run_hmc(
        seed, pot, block, num_warmup=cfg.num_warmup, num_samples=0,
        num_steps=cfg.num_steps, init_step_size=cfg.init_step_size,
        target_accept=cfg.target_accept, adapt_mass=cfg.adapt_mass,
        collect="none", kernel=kern, **common)
    state, step_size = warm.state, warm.step_size
    thin = max(cfg.thin, 1)
    t = cfg.num_warmup
    accs = []
    w, d = q0.shape
    lead = _leads(mesh)
    with (SampleSink(cfg.output_path, w, d) if lead
          else contextlib.nullcontext()) as sink:
        for _ in range(cfg.num_samples):
            for _ in range(thin):
                state, info = kern.step((seed, t), state, step_size)
                t += 1
                accs.append(torch.mean(info.accept_prob))
            q = state.ensemble.q
            if mesh is not None:
                q = gather_walkers(q, mesh, dst=0)
            if lead:
                sink.append(q)
    accept = None
    if accs:  # the group's (this process's alone without a mesh)
        rows = gather_rows(torch.mean(torch.stack(accs)).reshape(1), mesh)
        accept = torch.sum(rows) / rows.shape[0]
    data = np.asarray(read_samples(cfg.output_path)) if lead else None
    return {
        "accept_rate": None if accept is None else float(accept),
        "step_size": float(step_size),
        "streamed_rows": None if data is None else int(data.shape[0]),
        "posterior_mean": None if data is None else data.mean(0).tolist(),
        "posterior_sd": None if data is None else data.std(0).tolist(),
    }


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="physicsbasedbayesianinference_tpu_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", help="JSON RunConfig file")
    for f in dataclasses.fields(RunConfig):
        flag = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            p.add_argument(flag, type=lambda s: s.lower() in ("1", "true"),
                           default=None)
        elif f.name in ("data_path", "checkpoint_dir", "output_path"):
            p.add_argument(flag, type=str, default=None)
        elif isinstance(f.default, int):
            p.add_argument(flag, type=int, default=None)
        elif isinstance(f.default, float):
            p.add_argument(flag, type=float, default=None)
        else:
            p.add_argument(flag, type=str, default=None)
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    cfg = RunConfig.from_file(args.config) if args.config else RunConfig()
    cfg = dataclasses.replace(cfg, **{
        f.name: getattr(args, f.name) for f in dataclasses.fields(RunConfig)
        if getattr(args, f.name, None) is not None})
    summary = run(cfg)
    if cfg.sharded:
        import torch.distributed as dist
        rank = dist.get_rank()
        dist.destroy_process_group()
        if rank != 0:
            return 0
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
