"""Every sampler of the port over a walker group on the CPU: K = 2 and
K = 4 rank processes under gloo (this file run as a script is the rank
process), each K run by one module-scoped fixture as two spawns: the first
computes every case and writes the first half of the checkpointed runs,
the second is a fresh group that resumes them.

Exact where the port is exact. A fused step (the kernels' plain versions
on CPU tensors, ``resolve_engine`` patched to ``"fused"`` as
``test_torch_parallel.py`` does) draws by global walker index, NUTS takes
its walkers' rows of the whole ensemble's draws, and parallel tempering
draws each rung at its global index and the swap uniforms as the one
process does, so at a fixed step size (no warmup) a K-rank run ends in the
one-process state bit for bit: the CLI's SMC, ChEES, PT on K_r x K_w =
2 x 2 and 4 x 1 (K = 4), 2 x 1 and 1 x 2 (K = 2), and NUTS. The moments
and rates, merged rank by rank, are held to float32 rounding (1e-6). A
group of one repeats each adapted run bit for bit. Adapted K-rank runs sum
their ensemble means rank by rank, which dual averaging grows into
another draw of the same law (``test_torch_parallel.py``), so they are
held to Monte-Carlo tolerances, and sharded PT also to the JAX package's
replica-sharded run of ``tests/test_tempering.py``.
"""

from __future__ import annotations

import contextlib
import io
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import physicsbasedbayesianinference_tpu_torch as pt  # noqa: E402
from physicsbasedbayesianinference_tpu_torch import chees as tchees  # noqa
from physicsbasedbayesianinference_tpu_torch import main as tmain  # noqa
from physicsbasedbayesianinference_tpu_torch import parallel as par  # noqa
from physicsbasedbayesianinference_tpu_torch import smc as tsmc  # noqa
from physicsbasedbayesianinference_tpu_torch import tempering as ttemp  # noqa
from physicsbasedbayesianinference_tpu_torch.adaptation import (  # noqa
    covariance_batch, covariance_init, covariance_merge, covariance_update)
from physicsbasedbayesianinference_tpu_torch.checkpoint import (  # noqa
    CheckpointManager)
from physicsbasedbayesianinference_tpu_torch.config import RunConfig  # noqa
from physicsbasedbayesianinference_tpu_torch.ops import (  # noqa: E402
    potentials as tpot)
from test_torch_parallel import leave_group, spawn_ranks  # noqa: E402
from _torch_cpu import cpu_requested  # noqa: E402,F401  (the CPU, asked for)

W, D = 64, 3      # the exact cases
W_MC = 1024       # the Monte-Carlo cases
R_PT = 4

FIXED_CHEES = dict(num_warmup=0, num_samples=6, init_step_size=0.3,
                   init_tau=1.2, collect="moments")
ADAPT_CHEES = dict(num_warmup=80, num_samples=40, init_step_size=0.3,
                   collect="moments")
FIXED_PT = dict(num_replicas=R_PT, num_warmup=0, num_samples=5, num_steps=4,
                init_step_size=0.4, beta_min=0.1, collect="moments")
ADAPT_PT = dict(num_replicas=R_PT, num_warmup=30, num_samples=10,
                num_steps=4, init_step_size=0.4, beta_min=0.1,
                collect="moments")
# tests/test_tempering.py::test_pt_replicas_sharded_over_mesh
JAX_PT = dict(num_replicas=4, num_warmup=100, num_samples=200, num_steps=8,
              collect="moments")
FIXED_NUTS = dict(num_warmup=0, num_samples=4, max_depth=5,
                  init_step_size=0.4)
ADAPT_NUTS = dict(num_warmup=60, num_samples=30, max_depth=5,
                  init_step_size=0.3, collect="none")
ADAPT_DENSE = dict(num_warmup=100, num_samples=40, num_steps=6,
                   init_step_size=0.3, collect="moments", metric="dense")
PT_MESHES = {2: ((2, "2x1"), (1, "1x2")), 4: ((2, "2x2"), (4, "4x1"))}
CLI_SMC = dict(model="builtin:std_normal_32d", sampler="smc", num_walkers=W,
               num_steps=4, smc_beta0=0.1, smc_max_stages=12, seed=3,
               device="cpu")
STREAM = dict(model="builtin:std_normal_2d", num_walkers=W, num_warmup=0,
              num_samples=5, num_steps=4, thin=2, init_step_size=0.4,
              collect="stream", seed=4, device="cpu")
CHECKPOINTED = {
    "hmc": dict(model="builtin:std_normal_2d", num_steps=4),
    "chees": dict(model="builtin:std_normal_2d"),
    "nuts": dict(model="builtin:std_normal_2d", max_depth=4),
    "pt": dict(model="builtin:bimodal_2d", pt_replicas=3, num_steps=4),
}
CKPT = dict(num_walkers=W, num_warmup=20, checkpoint_every=8, seed=5,
            device="cpu")
FIRST, LONGER = 8, 20   # the first chunk, and the resumed run's samples
CKPT_SMC = dict(model="builtin:std_normal_32d", sampler="smc",
                num_walkers=128, num_steps=4, smc_beta0=0.02,
                smc_max_stages=25, seed=3, device="cpu")
CLI_SAMPLERS = {"hmc": {}, "hmc dense": dict(metric="dense"),
                "chees": dict(sampler="chees"), "nuts": dict(sampler="nuts"),
                "pt": dict(sampler="pt", pt_replicas=3),
                "smc": dict(sampler="smc", smc_max_stages=4)}


def _q(w, d, seed=0, scale=1.0):
    return torch.from_numpy(
        scale * np.random.default_rng(seed).standard_normal((w, d))
        .astype(np.float32))


def _gaussian():
    cov = torch.tensor([[1.0, 0.5, 0.0], [0.5, 2.0, 0.3], [0.0, 0.3, 0.7]])
    return tpot.make_gaussian(torch.tensor([1.0, -1.0, 0.5]), cov=cov,
                              device="cpu")


def _mixture(at=2.0):
    return tpot.make_gaussian_mixture(
        torch.tensor([[-at, 0.0], [at, 0.0]]), device="cpu")


def _jax_pt_init():
    return np.broadcast_to(
        3.0 * np.random.default_rng(5).standard_normal((512, 2))
        .astype(np.float32), (4, 512, 2)).copy()


@contextlib.contextmanager
def fused_plain(*modules):
    """``resolve_engine`` of each module answering ``"fused"``: on CPU
    tensors the fused kernels' plain versions run."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in modules:
            mp.setattr(mod, "resolve_engine", lambda *a, **kw: "fused")
        yield


def _quiet(fn, *args):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = fn(*args)
    return out, err.getvalue()


def _cfg(directory, name, sampler, num_samples, mesh_run=True):
    return RunConfig(sampler=sampler, num_samples=num_samples,
                     checkpoint_dir=str(Path(directory) / name),
                     sharded=mesh_run, **CKPT, **CHECKPOINTED[sampler])


def _checkpoint_state(directory, name, sampler, mesh):
    """The final state of this rank's newest checkpoint."""
    inputs = tmain.prepare(RunConfig(sampler=sampler, **CKPT,
                                     **CHECKPOINTED[sampler]))
    _, _, template, _ = tmain._sampler_pieces(
        RunConfig(sampler=sampler, **CKPT, **CHECKPOINTED[sampler]),
        inputs, mesh)
    z = torch.zeros(2)
    if sampler != "pt":  # saved with its mass per dim, as main saves it
        template = template.replace(ensemble=template.ensemble.replace(
            mass=torch.ones(2)))
    st = CheckpointManager(str(Path(directory) / name), mesh=mesh).restore({
        "schema": 0, "state": template, "step_size": torch.zeros(
            (3,) if sampler == "pt" else ()), "tau": torch.zeros(()),
        "mean": z, "m2": z, "n": 0})["state"]
    return st["q"] if sampler == "pt" else st.ensemble.q


def _phase_one(rank, k, directory, mesh, out):
    """Every case of the first spawn (module docstring)."""
    import torch.distributed as dist
    q = _q(W, D)
    # ---- the CLI's sharded SMC, fused: the one-process summary ----------
    with fused_plain(tsmc):
        out["cli_smc"], _ = _quiet(tmain.run, RunConfig(sharded=True,
                                                        **CLI_SMC))
    # ---- ChEES at a fixed step size and tau ------------------------------
    with fused_plain(tchees):
        for name, fn in (("std_normal", tpot.make_standard_normal(D)),
                         ("gaussian", _gaussian())):
            res = pt.run_chees_hmc(5, fn, q, mesh=mesh, **FIXED_CHEES)
            out[f"chees_fixed/{name}"] = (
                par.gather_walkers(res.state.ensemble.q, mesh), res.mean,
                res.var, res.accept_rate, res.kernel_used)
    res = pt.run_chees_hmc(7, _gaussian(), _q(W_MC, D, seed=1), mesh=mesh,
                           **ADAPT_CHEES)
    out["chees_adapt"] = (res.mean, res.var, res.step_size,
                          res.trajectory_time, res.accept_rate)
    # ---- parallel tempering without warmup, two mesh shapes --------------
    for k_r, shape in PT_MESHES[k]:
        rm = par.make_replica_mesh(k_r)
        with fused_plain(ttemp):
            res = pt.run_parallel_tempering(9, _mixture(), _q(W, 2, seed=2),
                                            mesh=rm, **FIXED_PT)
        out[f"pt_fixed/{shape}"] = (
            rm.replicas.rank, rm.walkers.rank, res.q, res.u, res.g,
            res.mean, res.var, res.accept_rate, res.swap_rate,
            res.step_sizes, res.kernel_used)
    # the JAX test's configuration on the K_r x K_w mesh of this K
    rm = par.make_replica_mesh(2)
    res = pt.run_parallel_tempering(1, _mixture(3.0), _jax_pt_init(),
                                    mesh=rm, **JAX_PT)
    out["pt_jax_config"] = (res.mean, res.var, res.q.shape)
    # ---- NUTS -------------------------------------------------------------
    fn = tpot.make_standard_normal(D)
    res = pt.run_nuts(11, fn, q, mesh=mesh, **FIXED_NUTS)
    out["nuts_fixed"] = (par.gather_walkers(
        res.samples.transpose(0, 1), mesh).transpose(0, 1),
        res.accept_rate, res.mean_depth)
    res = pt.run_nuts(11, fn, _q(W_MC, D, seed=3), mesh=mesh, **ADAPT_NUTS)
    out["nuts_adapt"] = (par.gather_walkers(res.state.ensemble.q, mesh),
                         res.step_size, res.accept_rate, res.mass)
    # ---- the dense metric -------------------------------------------------
    res = par.sharded_run_hmc(13, _gaussian(), _q(W_MC, D, seed=4),
                              mesh=mesh, **ADAPT_DENSE)
    out["dense_adapt"] = (res.mean, res.var, res.metric_cov, res.kernel_used,
                          res.accept_rate)
    # ---- a group of one repeats each adapted run bit for bit --------------
    ones = [dist.new_group([r]) for r in range(k)]
    if rank == 0:
        solo = par.make_walker_mesh(ones[0])
        with fused_plain(tchees):
            res = pt.run_chees_hmc(7, _gaussian(), q, mesh=solo,
                                   **ADAPT_CHEES)
        out["solo/chees"] = (res.state.ensemble.q, res.mean, res.var,
                             res.step_size, res.trajectory_time)
        with fused_plain(ttemp):
            res = pt.run_parallel_tempering(
                9, _mixture(), _q(W, 2, seed=2), mesh=solo, **ADAPT_PT)
        out["solo/pt"] = (res.q, res.mean, res.var, res.step_sizes,
                          res.accept_rate, res.swap_rate)
        res = pt.run_nuts(11, fn, q, mesh=solo, **ADAPT_NUTS)
        out["solo/nuts"] = (res.state.ensemble.q, res.step_size, res.mass,
                            res.accept_rate)
        res = par.sharded_run_hmc(13, _gaussian(), q, mesh=solo,
                                  **ADAPT_DENSE)
        out["solo/dense"] = (res.state.ensemble.q, res.mean, res.var,
                             res.metric_cov, res.step_size)
    # ---- sharded stream mode: rank 0 writes the one file -----------------
    stream_dir = Path(directory) / "stream"
    if rank == 0:
        stream_dir.mkdir()
    dist.barrier()
    with fused_plain(tmain):
        out["stream"], _ = _quiet(tmain.run, RunConfig(
            sharded=True, output_path=str(stream_dir / "s.pbbi"), **STREAM))
    dist.barrier()
    out["stream_files"] = sorted(p.name for p in stream_dir.iterdir())
    # ---- every sampler through the CLI ------------------------------------
    for name, extra in CLI_SAMPLERS.items():
        out[f"cli/{name}"], out[f"cli_err/{name}"] = _quiet(
            tmain.run, RunConfig(model="builtin:std_normal_2d",
                                 num_walkers=W, num_warmup=20,
                                 num_samples=10, num_steps=4, seed=6,
                                 sharded=True, device="cpu", **extra))
    # ---- checkpointed runs: the first chunk, and the uninterrupted run ----
    for sampler in CHECKPOINTED:
        _quiet(tmain.run, _cfg(directory, f"{sampler}_a", sampler, FIRST))
        out[f"ckpt_full/{sampler}"], _ = _quiet(
            tmain.run, _cfg(directory, f"{sampler}_b", sampler, LONGER))
        out[f"ckpt_full_q/{sampler}"] = _checkpoint_state(
            directory, f"{sampler}_b", sampler, mesh)
    out["ckpt_smc_full"], _ = _quiet(tmain.run, RunConfig(
        sharded=True, checkpoint_dir=str(Path(directory) / "smc_a"),
        **CKPT_SMC))


def _phase_two(rank, k, directory, mesh, out):
    """The fresh group: every checkpointed run resumed."""
    import torch.distributed as dist
    for sampler in CHECKPOINTED:
        out[f"ckpt_resumed/{sampler}"], out[f"ckpt_err/{sampler}"] = _quiet(
            tmain.run, _cfg(directory, f"{sampler}_a", sampler, LONGER))
        out[f"ckpt_resumed_q/{sampler}"] = _checkpoint_state(
            directory, f"{sampler}_a", sampler, mesh)
    out["ckpt_smc_resumed"], _ = _quiet(tmain.run, RunConfig(
        sharded=True, checkpoint_dir=str(Path(directory) / "smc_c"),
        **CKPT_SMC))
    # a group of another size: a rank alone, and one process unsharded
    solo = par.make_walker_mesh(dist.new_group([rank]))
    for who, mgr_mesh in (("solo", solo), ("unsharded", None)):
        try:
            CheckpointManager(str(Path(directory) / "hmc_a"),
                              mesh=mgr_mesh).latest_step()
            out[f"other_size/{who}"] = None
        except ValueError as e:
            out[f"other_size/{who}"] = str(e)


def _worker(rank: int, k: int, directory: str, phase: str) -> None:
    torch.set_num_threads(1)
    par.initialize_distributed(f"file://{directory}/rendezvous-{phase}", k,
                               rank, device="cpu")
    mesh = par.make_walker_mesh()
    out = {}
    (_phase_one if phase == "one" else _phase_two)(rank, k, directory,
                                                   mesh, out)
    torch.save(out, Path(directory) / f"{phase}_rank{rank}.pt")
    if rank == 0:
        torch.save(out, Path(directory) / "rank0.pt")


@pytest.fixture(scope="module", params=[2, 4], ids=["K2", "K4"])
def ranks(request, tmp_path_factory):
    """``(k, [rank outputs of the first spawn], [of the second])``."""
    k = request.param
    tmp = tmp_path_factory.mktemp(f"sharded_k{k}")
    spawn_ranks(__file__, k, tmp, argv=["one"])
    # the uninterrupted SMC's earliest kept stage, alone in a new directory
    smc_a, smc_c = tmp / "smc_a", tmp / "smc_c"
    first_stage = min(int(p.name) for p in smc_a.iterdir()
                      if p.name.isdigit())
    shutil.copytree(smc_a / str(first_stage), smc_c / str(first_stage))
    spawn_ranks(__file__, k, tmp, argv=["two"])
    load = [[torch.load(tmp / f"{phase}_rank{r}.pt", weights_only=False)
             for r in range(k)] for phase in ("one", "two")]
    return k, load[0], load[1], first_stage


@pytest.fixture(scope="module")
def one_process():
    """The one-process runs the sharded ones are held against."""
    out = {}
    q = _q(W, D)
    with fused_plain(tsmc):
        out["cli_smc"], _ = _quiet(tmain.run, RunConfig(**CLI_SMC))
    with fused_plain(tchees):
        for name, fn in (("std_normal", tpot.make_standard_normal(D)),
                         ("gaussian", _gaussian())):
            out[f"chees_fixed/{name}"] = pt.run_chees_hmc(5, fn, q,
                                                          **FIXED_CHEES)
        out["solo/chees"] = pt.run_chees_hmc(7, _gaussian(), q,
                                             **ADAPT_CHEES)
    out["chees_adapt"] = pt.run_chees_hmc(7, _gaussian(), _q(W_MC, D, seed=1),
                                          **ADAPT_CHEES)
    with fused_plain(ttemp):
        out["pt_fixed"] = pt.run_parallel_tempering(
            9, _mixture(), _q(W, 2, seed=2), **FIXED_PT)
        out["solo/pt"] = pt.run_parallel_tempering(
            9, _mixture(), _q(W, 2, seed=2), **ADAPT_PT)
    fn = tpot.make_standard_normal(D)
    out["nuts_fixed"] = pt.run_nuts(11, fn, q, **FIXED_NUTS)
    out["nuts_adapt"] = pt.run_nuts(11, fn, _q(W_MC, D, seed=3), **ADAPT_NUTS)
    out["solo/nuts"] = pt.run_nuts(11, fn, q, **ADAPT_NUTS)
    out["dense_adapt"] = pt.run_hmc(13, _gaussian(), _q(W_MC, D, seed=4),
                                    **ADAPT_DENSE)
    # the dense step folds the rank into its seed
    out["solo/dense"] = pt.run_hmc(par.fold_rank(13, 0), _gaussian(), q,
                                   **ADAPT_DENSE)
    return out


# ---------------------------------------------------------------------------
# Fixed-step runs: the one-process run bit for bit
# ---------------------------------------------------------------------------


def test_cli_sharded_smc_is_the_one_process_summary(ranks, one_process):
    """``main.run`` with ``sharded=True`` and sampler smc passes the group
    to ``run_smc`` and gathers the final ensemble to rank 0: in fused form
    rank 0's summary is the one-process run's, log Z and the stage count
    bit for bit, and the posterior summary of the same gathered bits."""
    _, one, _, _ = ranks
    got, want = one[0]["cli_smc"], one_process["cli_smc"]
    assert got["num_stages"] >= 2
    for key in ("log_evidence", "num_stages", "final_step_size",
                "posterior_mean", "posterior_sd"):
        assert got[key] == want[key], key
    assert got["min_ess"] is None and got["max_rhat"] is None


@pytest.mark.parametrize("name", ["std_normal", "gaussian"])
def test_chees_fixed_tau_is_the_one_process_run(ranks, one_process, name):
    """Kernel A (the standard normal) and kernel B (the Gaussian form) at
    each rank's walker offset: the final positions bit for bit, the
    moments and the acceptance to 1e-6."""
    _, one, _, _ = ranks
    q, mean, var, acc, used = one[0][f"chees_fixed/{name}"]
    ref = one_process[f"chees_fixed/{name}"]
    assert used == "fused"
    assert torch.equal(q, ref.state.ensemble.q)
    torch.testing.assert_close(mean, ref.mean, rtol=0, atol=1e-6)
    torch.testing.assert_close(var, ref.var, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(acc, ref.accept_rate, rtol=0, atol=1e-6)


def _assemble(rows, k_r, k_w, field):
    """A ``[R, W, ...]`` field joined from the ranks' blocks."""
    by = {(r[0], r[1]): r[field] for r in rows}
    return torch.cat([torch.cat([by[i, j] for j in range(k_w)], dim=1)
                      for i in range(k_r)])


def test_pt_without_warmup_is_the_one_process_run(ranks, one_process):
    """Both mesh shapes of each K: the replicas' q, u and g joined from
    the ranks' blocks are the one-process run's bit for bit (the fused
    sweeps at each rung's global index and walker offset, the swaps on the
    one-process uniforms, the pairs across a replica shard's edge
    exchanged point to point); rates and cold moments to 1e-6, and every
    rank holds the same group values."""
    k, one, _, _ = ranks
    ref = one_process["pt_fixed"]
    for k_r, shape in PT_MESHES[k]:
        rows = [o[f"pt_fixed/{shape}"] for o in one]
        for field, want in ((2, ref.q), (3, ref.u), (4, ref.g)):
            assert torch.equal(_assemble(rows, k_r, k // k_r, field),
                               want), (shape, field)
        for row in rows:
            mean, var, acc, swaps, steps, used = row[5:]
            assert used == "fused"
            torch.testing.assert_close(mean, ref.mean, rtol=0, atol=1e-6)
            torch.testing.assert_close(var, ref.var, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(acc, ref.accept_rate, rtol=0,
                                       atol=1e-6)
            torch.testing.assert_close(swaps, ref.swap_rate, rtol=0,
                                       atol=1e-6)
            assert torch.equal(steps, ref.step_sizes)
        assert float(ref.swap_rate.max()) > 0


def test_nuts_fixed_step_is_the_one_process_run(ranks, one_process):
    """Each rank builds the trees of its own walkers, with no collective
    inside a transition: it keys the momentum and doubling generators as
    one process does and takes its walkers' rows of each draw, so the
    samples joined from the ranks are the one-process samples bit for
    bit."""
    _, one, _, _ = ranks
    samples, acc, depth = one[0]["nuts_fixed"]
    ref = one_process["nuts_fixed"]
    assert torch.equal(samples, ref.samples)
    torch.testing.assert_close(acc, ref.accept_rate, rtol=0, atol=1e-6)
    torch.testing.assert_close(depth, ref.mean_depth, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Adapted runs: a group of one bit for bit, K ranks in distribution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampler", ["chees", "pt", "nuts", "dense"])
def test_group_of_one_repeats_the_adapted_run(ranks, one_process, sampler):
    """A one-rank group reduces in one order: ChEES (fused, the gradient's
    sums, the variance merged from one row), PT (fused), NUTS and the
    dense metric (composed: the rank's seed is ``fold_rank(seed, 0)``, the
    covariance merged from one row) end in the one-process run's bits."""
    _, one, _, _ = ranks
    got = one[0][f"solo/{sampler}"]
    ref = one_process[f"solo/{sampler}"]
    want = {
        "chees": lambda r: (r.state.ensemble.q, r.mean, r.var, r.step_size,
                            r.trajectory_time),
        "pt": lambda r: (r.q, r.mean, r.var, r.step_sizes, r.accept_rate,
                         r.swap_rate),
        "nuts": lambda r: (r.state.ensemble.q, r.step_size, r.mass,
                           r.accept_rate),
        "dense": lambda r: (r.state.ensemble.q, r.mean, r.var, r.metric_cov,
                            r.step_size),
    }[sampler](ref)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_adapted_chees_nuts_and_dense_match_in_distribution(
        ranks, one_process):
    """W = 1024: ChEES's moments within 0.06 sd (mean) and 12% (variance)
    of the one-process run, its step size and tau within 30%; NUTS's step
    size within 25% and its final ensemble's moments within 0.1 / 15%;
    the dense metric's moments within 0.06 sd / 12% and its adapted
    covariance within 12% (Frobenius) of the one-process run's. Some six
    standard errors of a 1024-walker mean over the draws, as
    ``test_torch_parallel.py`` sets them."""
    _, one, _, _ = ranks
    mean, var, step, tau, acc = one[0]["chees_adapt"]
    ref = one_process["chees_adapt"]
    assert ((mean - ref.mean) / torch.sqrt(ref.var)).abs().max() < 0.06
    assert ((var / ref.var) - 1).abs().max() < 0.12
    assert abs(step / ref.step_size - 1) < 0.3
    assert abs(tau / ref.trajectory_time - 1) < 0.3
    assert 0.6 <= float(acc) <= 0.99
    q, step, acc, mass = one[0]["nuts_adapt"]
    ref = one_process["nuts_adapt"]
    assert abs(step / ref.step_size - 1) < 0.25
    assert (q.mean(0) - ref.state.ensemble.q.mean(0)).abs().max() < 0.1
    assert (q.var(0) / ref.state.ensemble.q.var(0) - 1).abs().max() < 0.15
    assert 0.6 <= float(acc) <= 0.99
    mean, var, cov, used, acc = one[0]["dense_adapt"]
    ref = one_process["dense_adapt"]
    assert used == "dense"
    assert ((mean - ref.mean) / torch.sqrt(ref.var)).abs().max() < 0.06
    assert ((var / ref.var) - 1).abs().max() < 0.12
    assert (torch.linalg.norm(cov - ref.metric_cov)
            / torch.linalg.norm(ref.metric_cov)) < 0.12
    assert 0.6 <= float(acc) <= 0.99


@pytest.fixture(scope="module")
def jax_pt():
    """The JAX package's run of the JAX test's configuration on its 4 x 2
    replica mesh of the 8-device host, from the numpy start."""
    import jax
    from physicsbasedbayesianinference_tpu.ops import potentials as jpot
    from physicsbasedbayesianinference_tpu.parallel.mesh import (
        make_replica_mesh, replica_sharding)
    from physicsbasedbayesianinference_tpu.tempering import (
        run_parallel_tempering)
    target = jpot.make_gaussian_mixture(
        jax.numpy.asarray([[-3.0, 0.0], [3.0, 0.0]]))
    init = jax.device_put(jax.numpy.asarray(_jax_pt_init()),
                          replica_sharding(make_replica_mesh(4)))
    return run_parallel_tempering(jax.random.key(1), target, init, **JAX_PT)


def test_sharded_pt_matches_the_jax_replica_sharded_run(ranks, jax_pt):
    """The JAX test's configuration (``tests/test_tempering.py::
    test_pt_replicas_sharded_over_mesh``: the mixture at (+-3, 0), R = 4,
    W = 512, 100 + 200 transitions) on a 2 x K/2 replica mesh against the
    JAX package's run on its 4 x 2 replica mesh of the 8-device host, from
    the same numpy start: cold-chain means within 0.5, variances within
    1.0, and both modes reached (var[0] > 4), the JAX test's gates."""
    k, one, _, _ = ranks
    mean, var, shape = one[0]["pt_jax_config"]
    assert tuple(shape) == (2, 512 // (k // 2), 2)
    res = jax_pt
    np.testing.assert_allclose(mean.numpy(), np.asarray(res.mean), atol=0.5)
    np.testing.assert_allclose(var.numpy(), np.asarray(res.var), atol=1.0)
    assert float(var[0]) > 4.0 and float(res.var[0]) > 4.0


# ---------------------------------------------------------------------------
# Checkpoints, stream mode and the command line
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sampler", sorted(CHECKPOINTED))
def test_checkpointed_run_resumed_by_a_fresh_group_is_bitwise(ranks,
                                                              sampler):
    """A K-rank checkpointed run stopped after its first chunk, resumed by
    a fresh K-rank group with a larger ``num_samples``: the group's
    streamed moments and every rank's final block are those of the
    uninterrupted K-rank run bit for bit."""
    k, one, two, _ = ranks
    resumed, full = two[0][f"ckpt_resumed/{sampler}"], one[0][
        f"ckpt_full/{sampler}"]
    assert resumed["resumed_from"] == FIRST
    assert "resumed from checkpoint step" in two[0][f"ckpt_err/{sampler}"]
    assert resumed["samples_done"] == full["samples_done"] == LONGER
    for key in ("posterior_mean", "posterior_var", "step_size"):
        assert resumed[key] == full[key], key
    for r in range(k):
        assert torch.equal(two[r][f"ckpt_resumed_q/{sampler}"],
                           one[r][f"ckpt_full_q/{sampler}"])
        # the group's moments, alike on every rank
        assert two[r][f"ckpt_resumed/{sampler}"]["posterior_mean"] == \
            resumed["posterior_mean"]


def test_checkpointed_smc_resumed_from_a_stage_by_a_fresh_group(ranks):
    """The uninterrupted sharded SMC's earliest kept stage, copied alone
    (every rank's file) into a new directory and resumed by a fresh group:
    the same log Z, stages and posterior summary bit for bit."""
    _, one, two, first_stage = ranks
    full, resumed = one[0]["ckpt_smc_full"], two[0]["ckpt_smc_resumed"]
    assert full["num_stages"] >= 3 and first_stage < full["num_stages"]
    assert resumed["resumed_from"] == first_stage
    for key in ("log_evidence", "num_stages", "final_step_size",
                "posterior_mean", "posterior_var"):
        assert resumed[key] == full[key], key


def test_restoring_into_a_group_of_another_size_raises(ranks):
    k, _, two, _ = ranks
    for who, size in (("solo", 1), ("unsharded", 1)):
        msg = two[0][f"other_size/{who}"]
        assert msg is not None and f"group of {k} ranks" in msg \
            and f"this group has {size}" in msg, msg


def test_sharded_stream_mode_writes_one_file_on_rank_0(ranks, tmp_path):
    """Every recorded draw gathered to rank 0, which alone opens the
    sample file: one file, whose rows are the one-process stream's bit
    for bit (fused, no warmup); the other ranks' summaries hold no
    rows."""
    k, one, _, _ = ranks
    assert one[0]["stream_files"] == ["s.pbbi"]
    assert one[0]["stream"]["streamed_rows"] == 5 * W
    assert all(o["stream"]["streamed_rows"] is None for o in one[1:])
    path = str(tmp_path / "s.pbbi")
    with fused_plain(tmain):
        want, _ = _quiet(tmain.run, RunConfig(output_path=path, **STREAM))
    got = one[0]["stream"]
    assert got["posterior_mean"] == want["posterior_mean"]
    assert got["posterior_sd"] == want["posterior_sd"]
    assert got["accept_rate"] == pytest.approx(want["accept_rate"], abs=1e-6)


@pytest.mark.parametrize("name", sorted(CLI_SAMPLERS))
def test_every_sampler_runs_sharded_through_the_cli(ranks, name):
    """``main.run`` with ``sharded=True`` for each sampler (composed on the
    CPU): rank 0's summary has the unsharded run's keys and finite
    posterior means; the other ranks print no progress line."""
    k, one, _, _ = ranks
    extra = CLI_SAMPLERS[name]
    want, _ = _quiet(tmain.run, RunConfig(
        model="builtin:std_normal_2d", num_walkers=W, num_warmup=20,
        num_samples=10, num_steps=4, seed=6, device="cpu", **extra))
    got = one[0][f"cli/{name}"]
    assert set(got) == set(want)
    assert got["config"] == dict(want["config"], sharded=True)
    assert np.all(np.isfinite(got["posterior_mean"]))
    assert f"devices={k}" in one[0][f"cli_err/{name}"]
    assert all(o[f"cli_err/{name}"] == "" for o in one[1:])


def test_covariance_merge_of_blocks_is_the_whole_update():
    """The dense metric's batch terms of K blocks merged in rank order
    equal ``covariance_update`` on the whole ensemble to float32
    tolerance, planted non-finite rows excluded alike."""
    q = _q(256, 4, seed=8, scale=2.0) + torch.tensor([3.0, -1.0, 0.0, 5.0])
    q[7, 2] = float("nan")
    q[100] = 1e9
    whole = covariance_update(covariance_init(4), q)
    for k in (2, 4, 8):
        est = covariance_init(4)
        for block in q.chunk(k):
            est = covariance_merge(est, *covariance_batch(block))
        assert float(est.count) == float(whole.count) == 254
        torch.testing.assert_close(est.mean, whole.mean, rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(est.m2, whole.m2, rtol=1e-5, atol=1e-4)


def test_replica_mesh_blocks_and_refusals():
    """The blocks of a replica x walker group without communicating (the
    sub-meshes built by hand), and the refusals naming both numbers."""
    dev = torch.device("cpu")
    rm = par.ReplicaMesh(
        group=None, rank=5, size=8, device=dev,
        walkers=par.WalkerMesh(group=None, rank=1, size=4, device=dev),
        replicas=par.WalkerMesh(group=None, rank=1, size=2, device=dev,
                                axis_name=par.REPLICA_AXIS))
    x = torch.arange(6 * 16 * 2.0).reshape(6, 16, 2)
    assert torch.equal(par.shard_replicas(x, rm), x[3:6, 4:8])
    with pytest.raises(ValueError, match="num_replicas=5 .* 2"):
        rm.blocks(5, 16)
    with pytest.raises(ValueError, match="num_walkers=10 .* 4"):
        rm.blocks(6, 10)
    walker = par.WalkerMesh(group=None, rank=1, size=2, device=dev)
    assert torch.equal(par.shard_replicas(x, walker), x[:, 8:])
    if not torch.distributed.is_initialized():
        with pytest.raises(RuntimeError, match="no process group"):
            par.make_replica_mesh(2)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    leave_group()
