"""The check that decides ``correct``, driven through the harness on the
CPU at a small size (the kernels' plain versions draw the fused kernels'
Philox stream): the program passes it; its control, the plain reference
in the next precision below the configuration's, fails it; and so does
each fault a cell can have, planted under the timed path or in the
warmup's adaptation."""

import multiprocessing
import os
import socket

import pytest
import torch

from portbench import control
from portbench.tests.helpers import cpu_run, fused_on_cpu, small_cell

CELLS = ["logreg.chees", "stdnormal.hmc"]


@pytest.mark.parametrize("name", CELLS)
def test_program_passes(monkeypatch, name):
    fused_on_cpu(monkeypatch)
    run = cpu_run(small_cell(name))
    checks = run.check()
    assert checks["draw_gap"]["value"] <= checks["draw_gap"]["limit"]
    assert checks["engine_mismatch"]["value"] == 0.0
    assert not any(j.failed for j in run.jobs)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(monkeypatch, name):
    """The reference in the next precision below, in the program's place
    for each kept transition, fails the check."""
    fused_on_cpu(monkeypatch)
    cell = small_cell(name, walkers=1024)
    if "num_rows" in cell["cfg"]:
        # the configuration's rows: TF32's error in the energy grows with
        # them, as it does at the cell's size
        cell["cfg"] = dict(cell["cfg"], num_rows=256)
    run = cpu_run(cell)
    job = control.control_job(run, run.jobs[0])
    checks = run.check([job])
    assert checks["draw_gap"]["value"] > checks["draw_gap"]["limit"]


def _plant(monkeypatch, fault: str) -> None:
    """Break kernels A and B underneath the samplers."""
    from physicsbasedbayesianinference_tpu_torch.ops import kernels
    for name, at in (("fused_hmc_diag_quadratic", 2),
                     ("fused_hmc_transition", 3)):
        orig = getattr(kernels, name)

        def broken(*args, _orig=orig, _at=at, **kw):
            out = list(_orig(*args, **kw))
            q = args[_at]
            if fault == "unchanged":
                out[0] = q.clone()
            elif fault == "half":
                h = q.shape[0] // 2
                out[0] = torch.cat((out[0][:h], q[h:]))
                acc = out[3].clone()
                acc[h:] = acc[:h].mean()
                out[3] = acc
            elif fault == "altered":
                out[0] = out[0].clone()
                out[0][::16, 0] += 1e-2
            return tuple(out)
        monkeypatch.setattr(kernels, name, broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_fails(monkeypatch, name, fault):
    fused_on_cpu(monkeypatch)
    _plant(monkeypatch, fault)
    run = cpu_run(small_cell(name))
    checks = run.check()
    assert checks["draw_gap"]["value"] > checks["draw_gap"]["limit"]


ADAPTATION_FAULTS = [
    ("logreg.chees", "step_size_frozen", "step_size_gap"),
    ("logreg.chees", "mass_ones", "mass_gap"),
    ("logreg.chees", "partial_sum", "mass_gap"),
    ("logreg.chees", "tau_frozen", "tau_gap"),
    ("stdnormal.hmc", "step_size_frozen", "step_size_gap"),
    ("stdnormal.hmc", "partial_sum", "mass_gap"),
]


@pytest.mark.parametrize("name,fault,number", ADAPTATION_FAULTS)
def test_adaptation_fault_fails(monkeypatch, name, fault, number):
    """A fault in the warmup's adaptation leaves the draws the sampler's own
    at its settings (``draw_gap`` passes) and fails the number that holds
    that setting to the reference."""
    fused_on_cpu(monkeypatch)
    cell = small_cell(name, walkers=1024, warmup=60, samples=8)
    with control.planted(fault):
        run = cpu_run(cell)
    checks = run.check()
    assert checks["draw_gap"]["value"] <= checks["draw_gap"]["limit"]
    assert checks[number]["value"] > checks[number]["limit"]


def _rank(rank: int, world: int, port: int, fault: str, out) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from physicsbasedbayesianinference_tpu_torch import chees, hmc

    def fused(kernel, potential_fn, q, **kw):
        return "fused"
    hmc.resolve_engine = chees.resolve_engine = fused
    if fault == "exchange":
        def alone(x, mesh):
            return x.reshape(1, -1)
        chees.gather_rows = alone
    if fault == "raises" and rank == 2:
        # rank 2's sampler raises once its collectives are done, where the
        # other ranks' jobs return
        import physicsbasedbayesianinference_tpu_torch as port
        sampler = port.run_chees_hmc

        def broken(*args, **kw):
            sampler(*args, **kw)
            raise RuntimeError("a fault planted on rank 2")
        port.run_chees_hmc = broken
    cell = dict(small_cell("logreg.chees", walkers=64), chips=world)
    run = cpu_run(cell, rank=rank, world=world)
    checks = run.check()
    import torch.distributed as dist
    dist.destroy_process_group()
    if rank == 0:
        out.put((checks, [j.failed for j in run.jobs]))


@pytest.mark.parametrize("fault", ["none", "exchange", "raises"])
def test_four_ranks(fault):
    """The logistic cell on four CPU ranks (gloo): sound, it passes; with
    the exchange between the ranks left out, each rank adapts alone and
    fails; where one rank's sampler raises after its collectives, every
    rank leaves the job together and the run's jobs count as failed (no
    rank waits in a collective of the harness)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, 4, port, fault, out))
             for r in range(4)]
    for p in procs:
        p.start()
    checks, failed = out.get(timeout=600)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    gap = checks["draw_gap"]
    if fault == "none":
        assert gap["value"] <= gap["limit"] and not any(failed)
    elif fault == "exchange":
        assert gap["value"] > gap["limit"]
    else:
        assert failed and all(failed)
