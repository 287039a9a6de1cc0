"""The port's ``parallel/`` on the CPU: K = 2 and K = 4 rank processes under
gloo, each run once by a module-scoped fixture that computes every case
(this file run as a script is the rank process), held against the
one-process port and the JAX package's sharded runs on the 8-device host
mesh of ``tests/test_parallel.py``.

Exact where the port is exact: the fused step (the kernels' plain versions
on CPU tensors) draws by global walker index, so a K-rank run at a fixed
step size ends in the one-process state bit for bit, and a group of one
repeats ``run_hmc`` bit for bit with its adaptation. With adaptation over
K > 1 ranks the ensemble means are summed in another order; the warmup's
feedback (dual averaging on the acceptance, whose walkers' decisions flip
on last-bit changes) grows that into another draw of the same law within
some 20 transitions, so those runs are held to Monte-Carlo tolerances.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import physicsbasedbayesianinference_tpu_torch as pt  # noqa: E402
from physicsbasedbayesianinference_tpu_torch import parallel as par  # noqa
from physicsbasedbayesianinference_tpu_torch import smc as tsmc  # noqa
from physicsbasedbayesianinference_tpu_torch.ops import (  # noqa: E402
    potentials as tpot)

W, D = 64, 3          # the exact cases
W_MC = 1024           # the Monte-Carlo cases (divisible by 8 for JAX)


def spawn_ranks(script: str, k: int, tmp_path: Path, timeout: float = 240,
                argv=()):
    """Run ``script`` as ``k`` rank processes (argv: rank, k, directory,
    then ``argv``),
    joined by a gloo group through a file in ``tmp_path`` (no port), and
    return rank 0's results (``torch.load`` of ``rank0.pt``) and every
    rank's standard output.

    Each rank writes its standard output and error to files in
    ``tmp_path``, not to pipes, so that no rank can stall on a full pipe
    while the others wait for it in a collective; all ranks are waited on
    together, against one deadline. A failed spawn reports every rank's
    return code and the tail of its standard error."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        env.pop(name, None)
    logs = [(tmp_path / f"rank{rank}.out", tmp_path / f"rank{rank}.err")
            for rank in range(k)]
    procs = []
    try:
        for rank, (out, err) in enumerate(logs):
            with open(out, "w") as fo, open(err, "w") as fe:
                procs.append(subprocess.Popen(
                    [sys.executable, script, str(rank), str(k),
                     str(tmp_path), *argv], cwd=ROOT, env=env, stdout=fo,
                    stderr=fe, stdin=subprocess.DEVNULL))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        report = [f"rank {rank}: return code {code}"
                  + (" (killed at the {timeout} s limit)"
                     .format(timeout=timeout) if code == -9 else "")
                  + "\n" + err.read_text()[-1500:]
                  for rank, (code, (_, err)) in enumerate(zip(codes, logs))]
        raise AssertionError(f"{k}-rank spawn of {Path(script).name} "
                             f"failed:\n" + "\n".join(report))
    outs = [out.read_text() for out, _ in logs]
    return torch.load(tmp_path / "rank0.pt", weights_only=False), outs


def join_group(rank: int, k: int, directory: str):
    torch.set_num_threads(1)
    par.initialize_distributed(f"file://{directory}/rendezvous", k, rank,
                               device="cpu")
    return par.make_walker_mesh()


def leave_group() -> None:
    """End a rank process's group with the others: a rank that exits while
    its gloo group is alive can abort in teardown (``terminate called
    without an active exception``, return code -6) after it has done its
    work, when a peer closes their connections first. A barrier, then the
    group destroyed, before any rank exits."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def run_rank(worker) -> None:
    """A test file run as one rank process: ``worker(rank, k, directory)``
    from the command line, then :func:`leave_group`."""
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    leave_group()


def _q(w, d, seed=0, scale=1.0):
    return torch.from_numpy(
        scale * np.random.default_rng(seed).standard_normal((w, d))
        .astype(np.float32))


def _targets():
    cov = torch.tensor([[1.0, 0.5, 0.0], [0.5, 2.0, 0.3], [0.0, 0.3, 0.7]])
    return {"std_normal": tpot.make_standard_normal(D),
            "gaussian": tpot.make_gaussian(torch.tensor([1.0, -1.0, 0.5]),
                                           cov=cov, device="cpu")}


FIXED = dict(num_warmup=0, num_samples=6, num_steps=5, init_step_size=0.3,
             collect="moments")
ADAPT = dict(num_warmup=100, num_samples=60, num_steps=8,
             init_step_size=0.3, collect="moments")
SMC = dict(beta0=0.1, max_stages=12, num_mutation_steps=2,
           num_leapfrog_steps=6, init_step_size=0.5)
CLI = ["--device", "cpu", "--model", "builtin:std_normal_2d",
       "--num-walkers", "256", "--num-warmup", "40", "--num-samples", "20",
       "--num-steps", "6", "--seed", "3", "--sharded", "true"]


def _worker(rank: int, k: int, directory: str) -> None:
    """One rank: every sharded case, rank 0 saving what the tests read."""
    mesh = join_group(rank, k, directory)
    out = {}
    q = _q(W, D)
    for name, fn in _targets().items():
        # the fused step at a fixed step size, through run_hmc's seam
        res = pt.run_hmc(5, fn, q[mesh.block(W)], mesh=mesh,
                         kernel=pt.build_fused_hmc_kernel(fn, num_steps=5),
                         **FIXED)
        out[f"fixed/{name}"] = (par.gather_walkers(res.state.ensemble.q,
                                                   mesh), res.mean, res.var,
                                res.accept_rate)
    # one step through build_sharded_hmc_step, with its group statistics
    fn = _targets()["gaussian"]
    hk = pt.build_fused_hmc_kernel(fn, num_steps=5)
    step = par.build_sharded_hmc_step(hk, mesh)
    state = hk.init(q[mesh.block(W)])
    state, _, stats = step((9, 0), state, 0.4)
    out["step"] = (par.gather_walkers(state.ensemble.q, mesh), stats)
    # adaptation, fused path and composed sharded_run_hmc
    q_mc = _q(W_MC, D, seed=1)
    fn = tpot.make_standard_normal(D)
    res = pt.run_hmc(7, fn, q_mc[mesh.block(W_MC)], mesh=mesh,
                     kernel=pt.build_fused_hmc_kernel(fn, num_steps=8),
                     **ADAPT)
    out["adapt/fused"] = (res.mean, res.var, res.step_size, res.accept_rate)
    res = par.sharded_run_hmc(7, fn, q_mc, mesh=mesh, **ADAPT)
    out["adapt/composed"] = (res.mean, res.var, res.step_size,
                             res.accept_rate, res.kernel_used,
                             res.state.ensemble.q.shape)
    # a group of one repeats run_hmc with its adaptation, bit for bit
    ones = [torch.distributed.new_group([r]) for r in range(k)]
    solo = par.make_walker_mesh(ones[rank])
    res = pt.run_hmc(7, fn, q, mesh=solo,
                     kernel=pt.build_fused_hmc_kernel(fn, num_steps=8),
                     **ADAPT)
    out["solo"] = (res.state.ensemble.q, res.mean, res.var, res.step_size,
                   res.accept_rate)
    # SMC: composed (rank-folded draws), and the fused engine's plain
    # versions (the CPU stands in for the card), which repeat one process
    q_smc = _q(W, D, seed=2, scale=3.0)
    res = pt.run_smc(11, fn, q_smc, mesh=mesh, **SMC)
    out["smc/composed"] = (res.log_evidence, res.num_stages,
                           par.gather_walkers(res.q, mesh))
    tsmc.resolve_engine = lambda *a, **kw: "fused"
    res = pt.run_smc(11, fn, q_smc, mesh=mesh, **SMC)
    out["smc/fused"] = (res.log_evidence, res.num_stages, res.kernel_used,
                        par.gather_walkers(res.q, mesh), res.betas,
                        res.accept_history, res.final_step_size)
    # a gather to rank 0: its result there is the all-gather's
    block = torch.arange(6.0).reshape(3, 2) + 100.0 * rank
    out["gather_dst0"] = (par.gather_walkers(block, mesh),
                          par.gather_walkers(block, mesh, dst=0))
    # the command-line driver, last: it leaves the group
    from physicsbasedbayesianinference_tpu_torch import main as tmain
    stdout, stderr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(stdout), \
            contextlib.redirect_stderr(stderr), \
            _received_bytes() as received:
        tmain.main(CLI + ["--output-path", f"{directory}/cli.npz"])
    out["cli"] = (stdout.getvalue(), stderr.getvalue())
    out["cli_received"] = received
    if rank == 0:
        torch.save(out, Path(directory) / "rank0.pt")
    else:
        print(json.dumps({"rank": rank, "cli_stdout": out["cli"][0],
                          "cli_received": received,
                          "gather_dst0_is_none": out["gather_dst0"][1]
                          is None}))


@contextlib.contextmanager
def _received_bytes():
    """``[(collective, bytes)]``: what each collective that the package
    calls delivered to this rank while the block ran (the other ranks'
    blocks of an all-gather, or of a gather to this rank; the buffer of
    an all-reduce)."""
    import torch.distributed as dist
    log = []
    orig = {name: getattr(dist, name)
            for name in ("all_gather", "gather", "all_reduce")}

    def size(t):
        return t.numel() * t.element_size()

    def all_gather(parts, x, *args, **kwargs):
        log.append(("all_gather", size(x) * (len(parts) - 1)))
        return orig["all_gather"](parts, x, *args, **kwargs)

    def gather(x, gather_list=None, *args, **kwargs):
        log.append(("gather", 0 if gather_list is None
                    else size(x) * (len(gather_list) - 1)))
        return orig["gather"](x, gather_list, *args, **kwargs)

    def all_reduce(t, *args, **kwargs):
        log.append(("all_reduce", size(t)))
        return orig["all_reduce"](t, *args, **kwargs)

    patched = {"all_gather": all_gather, "gather": gather,
               "all_reduce": all_reduce}
    for name, fn in patched.items():
        setattr(dist, name, fn)
    try:
        yield log
    finally:
        for name, fn in orig.items():
            setattr(dist, name, fn)


@pytest.fixture(scope="module", params=[2, 4], ids=["K2", "K4"])
def ranks(request, tmp_path_factory):
    k = request.param
    tmp = tmp_path_factory.mktemp(f"parallel_k{k}")
    out, stdouts = spawn_ranks(__file__, k, tmp)
    return k, tmp, out, stdouts


@pytest.fixture(scope="module")
def one_process():
    """The one-process runs the sharded ones are held against."""
    out = {}
    q = _q(W, D)
    for name, fn in _targets().items():
        res = pt.run_hmc(5, fn, q,
                         kernel=pt.build_fused_hmc_kernel(fn, num_steps=5),
                         **FIXED)
        out[f"fixed/{name}"] = (res.state.ensemble.q, res.mean, res.var,
                                res.accept_rate)
    fn = tpot.make_standard_normal(D)
    res = pt.run_hmc(7, fn, _q(W_MC, D, seed=1),
                     kernel=pt.build_fused_hmc_kernel(fn, num_steps=8),
                     **ADAPT)
    out["adapt"] = (res.mean, res.var, res.step_size, res.accept_rate)
    res = pt.run_hmc(7, fn, q,
                     kernel=pt.build_fused_hmc_kernel(fn, num_steps=8),
                     **ADAPT)
    out["solo"] = (res.state.ensemble.q, res.mean, res.var, res.step_size,
                   res.accept_rate)
    q_smc = _q(W, D, seed=2, scale=3.0)
    res = pt.run_smc(11, fn, q_smc, **SMC)
    out["smc/composed"] = (res.log_evidence, res.num_stages)
    return out


def test_fused_fixed_step_is_the_one_process_run_bitwise(ranks, one_process):
    """Kernels A (standard normal) and B (the Gaussian form): the final
    positions bit for bit; the moments, merged rank by rank, to float32
    rounding (1e-6); the acceptance likewise."""
    _, _, out, _ = ranks
    for name in _targets():
        q, mean, var, acc = out[f"fixed/{name}"]
        q1, mean1, var1, acc1 = one_process[f"fixed/{name}"]
        assert torch.equal(q, q1), name
        torch.testing.assert_close(mean, mean1, rtol=0, atol=1e-6)
        torch.testing.assert_close(var, var1, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(acc, acc1, rtol=0, atol=1e-6)


def test_sharded_step_and_its_group_statistics(ranks):
    """build_sharded_hmc_step: the state is the one-process step's bit for
    bit, the group means those of the whole ensemble to 1e-6."""
    _, _, out, _ = ranks
    q_sharded, stats = out["step"]
    fn = _targets()["gaussian"]
    hk = pt.build_fused_hmc_kernel(fn, num_steps=5)
    state, info = hk.step((9, 0), hk.init(_q(W, D)), 0.4)
    assert torch.equal(q_sharded, state.ensemble.q)
    want = {"accept_rate": info.accept_prob.mean(),
            "divergence_rate": info.divergent.float().mean(),
            "mean_potential_energy": info.potential_energy.mean()}
    for key, value in want.items():
        torch.testing.assert_close(stats[key], value, rtol=1e-6, atol=1e-6)


def test_group_of_one_repeats_run_hmc_with_adaptation(ranks, one_process):
    _, _, out, _ = ranks
    for got, want in zip(out["solo"], one_process["solo"]):
        assert torch.equal(got, want)


def test_adapted_fused_run_matches_one_process_in_distribution(
        ranks, one_process):
    """W = 1024, 100 + 60 transitions: moments within 0.05 (mean) and 10%
    (variance), some six standard errors of a 1024-walker ensemble mean;
    the adapted step size within 25% (dual averaging's scatter from run
    to run at this warmup, measured at W = 256 and 2048)."""
    _, _, out, _ = ranks
    mean, var, step, acc = out["adapt/fused"]
    mean1, var1, step1, acc1 = one_process["adapt"]
    assert (mean - mean1).abs().max() < 0.05
    assert ((var / var1) - 1).abs().max() < 0.1
    assert abs(step / step1 - 1) < 0.25
    assert 0.6 <= float(acc) <= 0.99


def test_composed_sharded_run_matches_jax_gspmd_run(ranks):
    """sharded_run_hmc on CPU tensors runs the composed engine; its moments
    against the JAX package's sharded_run_hmc(kernel="xla") on the same
    numpy ensemble: within 0.05 (mean) and 10% (variance)."""
    import jax
    import jax.numpy as jnp
    from physicsbasedbayesianinference_tpu import parallel as jpar
    from physicsbasedbayesianinference_tpu.ops import potentials as jpot
    _, _, out, _ = ranks
    mean, var, _, acc, used, shape = out["adapt/composed"]
    assert used == "composed"
    assert tuple(shape) == (W_MC // ranks[0], D)
    r = jpar.sharded_run_hmc(
        jax.random.key(7), jpot.make_standard_normal(D),
        jnp.asarray(_q(W_MC, D, seed=1).numpy()),
        mesh=jpar.make_walker_mesh(), kernel="xla", **ADAPT)
    assert np.abs(mean.numpy() - np.asarray(r.mean)).max() < 0.05
    assert np.abs(var.numpy() / np.asarray(r.var) - 1).max() < 0.1
    # the adapted step sizes scatter from run to run, and the acceptance
    # with them: each in dual averaging's range
    assert 0.6 <= float(acc) <= 0.99 and 0.6 <= float(r.accept_rate) <= 0.99


def test_sharded_smc_matches_one_process(ranks, one_process, monkeypatch):
    """The fused engine (its plain versions): log Z, the ladder, the
    acceptances, the step size and the final ensemble bit for bit. The
    composed engine (rank-folded draws): the same stage count and log Z
    within 0.6, three standard deviations of the difference of two
    64-walker estimates (0.136 each, over 40 seeds of the one-process
    run, which took 3 stages at every seed)."""
    _, _, out, _ = ranks
    monkeypatch.setattr(tsmc, "resolve_engine", lambda *a, **kw: "fused")
    fn = tpot.make_standard_normal(D)
    res = pt.run_smc(11, fn, _q(W, D, seed=2, scale=3.0), **SMC)
    log_z, stages, used, q, betas, accepts, step = out["smc/fused"]
    assert used == "fused" and stages == res.num_stages
    for got, want in ((log_z, res.log_evidence), (q, res.q),
                      (betas, res.betas), (accepts, res.accept_history),
                      (step, res.final_step_size)):
        assert torch.equal(got, want)
    log_z, stages, q = out["smc/composed"]
    log_z1, stages1 = one_process["smc/composed"]
    assert stages == stages1
    assert abs(float(log_z) - float(log_z1)) < 0.6
    assert q.shape == (W, D) and bool(torch.isfinite(q).all())


def test_cli_sharded_on_the_cpu(ranks):
    """``main.main`` with ``--sharded true --device cpu`` on every rank:
    rank 0 prints the summary and writes the .npz with every rank's
    samples; the others print nothing."""
    k, tmp, out, stdouts = ranks
    stdout, stderr = out["cli"]
    summary = json.loads(stdout)
    assert summary["kernel_used"] == "composed"
    assert summary["num_grad_evals"] == 60 * 256 * 7
    assert max(abs(x) for x in summary["posterior_mean"]) < 0.15
    assert f"devices={k}" in stderr
    assert all(json.loads(s.splitlines()[-1])["cli_stdout"] == ""
               for s in stdouts[1:])
    with np.load(tmp / "cli.npz") as saved:
        assert saved["samples"].shape == (20, 256, 2)


def test_cli_sharded_gathers_the_samples_to_rank_0_only(ranks):
    """The samples of a sharded CLI run go to rank 0 in one gather: no
    collective of the run delivers another rank anything near a block of
    samples ([20, 256 / K, 2] float32; what the others receive are the
    warmup's small all-reduces), and rank 0's array is every rank's block
    in rank order, as the all-gather gave it."""
    k, _, out, stdouts = ranks
    block = 20 * (256 // k) * 2 * 4
    lead = out["cli_received"]
    assert ("gather", (k - 1) * block) in lead
    assert not any(name == "all_gather" and size >= block
                   for name, size in lead)
    for line in stdouts[1:]:
        rank = json.loads(line.splitlines()[-1])
        assert rank["gather_dst0_is_none"]
        assert ["gather", 0] in rank["cli_received"]
        assert max(size for _, size in rank["cli_received"]) < block
    whole, to_lead = out["gather_dst0"]
    assert torch.equal(to_lead, whole)
    assert torch.equal(whole, torch.cat([torch.arange(6.0).reshape(3, 2)
                                         + 100.0 * r for r in range(k)]))


def test_shard_ensemble_specs_and_divisibility():
    """A [D] mass stays whole where D equals W; a per-walker mass is split;
    W not divisible by the group raises. A WalkerMesh without a process
    group: nothing here communicates."""
    mesh = par.WalkerMesh(group=None, rank=1, size=2,
                          device=torch.device("cpu"))
    fn = tpot.make_standard_normal(4)
    state = pt.build_hmc_kernel(fn, num_steps=2).init(_q(4, 4),
                                                      mass=torch.ones(4))
    block = par.shard_ensemble(state, mesh)
    assert block.ensemble.q.shape == (2, 4)
    assert torch.equal(block.ensemble.q, state.ensemble.q[2:])
    assert block.ensemble.mass.shape == (4,)
    assert block.potential_energy.shape == (2,) and block.grad.shape == (2, 4)
    per_walker = state.replace(ensemble=state.ensemble.replace(
        mass=torch.arange(4.0)[:, None] + 1))
    assert torch.equal(par.shard_ensemble(per_walker, mesh).ensemble.mass,
                       torch.tensor([[3.0], [4.0]]))
    tree = par.shard_ensemble({"q": _q(4, 3), "scale": torch.ones(3)}, mesh)
    assert tree["q"].shape == (2, 3) and tree["scale"].shape == (3,)
    with pytest.raises(ValueError, match="divisible by the mesh size 2"):
        par.sharded_run_hmc(0, fn, _q(5, 4), mesh=mesh, num_warmup=1,
                            num_samples=1, num_steps=2)
    with pytest.raises(ValueError, match="divisible"):
        pt.run_smc(0, fn, _q(5, 4), mesh=mesh)
    with pytest.raises(ValueError, match="systematic"):
        pt.run_smc(0, fn, _q(4, 4), mesh=mesh, resampler="multinomial")
    # the dense metric runs sharded, composed; "fused" raises naming it
    with pytest.raises(ValueError, match="dense"):
        par.sharded_run_hmc(0, fn, _q(4, 4), mesh=mesh, num_warmup=1,
                            num_samples=1, num_steps=2, metric="dense",
                            kernel="fused")
    with pytest.raises(ValueError, match="auto|fused|composed"):
        par.sharded_run_hmc(0, fn, _q(4, 4), mesh=mesh, kernel="xla",
                            num_warmup=1, num_samples=1, num_steps=2)
    with pytest.raises(ValueError, match="kernel='fused' cannot run"):
        par.sharded_run_hmc(0, fn, _q(4, 4), mesh=mesh, kernel="fused",
                            num_warmup=1, num_samples=1, num_steps=2)


def test_initialize_distributed_without_environment_is_a_noop(monkeypatch):
    from physicsbasedbayesianinference_tpu import parallel as jpar
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    summary = par.initialize_distributed()
    assert not torch.distributed.is_initialized()
    assert set(summary) == set(jpar.initialize_distributed())
    assert summary["process_count"] == 1 and summary["process_index"] == 0
    with pytest.raises(RuntimeError, match="no process group"):
        par.make_walker_mesh()


if __name__ == "__main__":
    run_rank(_worker)
