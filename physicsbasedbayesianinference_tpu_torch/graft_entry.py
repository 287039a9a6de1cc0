"""Entry points that check the port compiles and runs (counterparts of the
repository's ``__graft_entry__.py``): one transition of the flagship
configuration, and a dry run of a sharded transition over n processes.

The flagship is the fused ensemble-HMC transition (``hmc.
build_fused_hmc_kernel``): momentum refresh, the leapfrog trajectory and
the per-walker Metropolis step, one launch of kernel A on the card (its
plain version on the CPU).
"""

from __future__ import annotations

import tempfile

import torch


def entry(device=None):
    """``(fn, example_args)``: one HMC transition of the flagship
    configuration (a 32-dim standard normal, 256 walkers, 8 leapfrog
    steps) on ``device``, the card by default (``default_device()``);
    ``fn(key, state, step_size) -> (q', accept_prob)`` with ``key = (seed,
    transition index)``."""
    import physicsbasedbayesianinference_tpu_torch as pt
    from physicsbasedbayesianinference_tpu_torch.device import resolve_device
    from physicsbasedbayesianinference_tpu_torch.ops import potentials as pot

    device = resolve_device(device)
    num_walkers, num_dims, num_steps = 256, 32, 8
    kernel = pt.build_fused_hmc_kernel(pot.make_standard_normal(num_dims),
                                       num_steps=num_steps)
    q0 = torch.randn(num_walkers, num_dims, device=device,
                     generator=torch.Generator(device=device).manual_seed(0))
    state = kernel.init(q0)

    def fn(key, state, step_size):
        new_state, info = kernel.step(key, state, step_size)
        return new_state.ensemble.q, info.accept_prob

    example_args = ((1, 0), state, torch.full((), 0.5, device=device))
    return fn, example_args


def _dry_rank(rank: int, n: int, directory: str, device: str) -> None:
    """One rank of :func:`dryrun_multichip`."""
    import torch.distributed as dist

    import physicsbasedbayesianinference_tpu_torch as pt
    from physicsbasedbayesianinference_tpu_torch import parallel as par
    from physicsbasedbayesianinference_tpu_torch.ops import potentials as pot

    torch.set_num_threads(1)
    par.initialize_distributed(f"file://{directory}/rendezvous", n, rank,
                               device=device)
    try:
        mesh = par.make_walker_mesh()
        num_walkers, num_dims, num_steps = 8 * n, 4, 3
        fn = pot.make_standard_normal(num_dims)
        q0 = torch.randn(num_walkers, num_dims, generator=torch.Generator(
            ).manual_seed(0)).to(mesh.device)
        block = q0[mesh.block(num_walkers)]
        for build in (pt.build_hmc_kernel, pt.build_fused_hmc_kernel):
            kernel = build(fn, num_steps=num_steps)
            step = par.build_sharded_hmc_step(kernel, mesh)
            new_state, _, stats = step((1, 0), kernel.init(block), 0.5)
            acc = float(stats["accept_rate"])
            whole = par.gather_walkers(new_state.ensemble.q, mesh)
            if not (0.0 <= acc <= 1.0
                    and tuple(new_state.ensemble.q.shape) == (
                        num_walkers // n, num_dims)
                    and tuple(whole.shape) == (num_walkers, num_dims)):
                raise AssertionError(
                    f"{build.__name__} over {n} ranks: accept rate {acc}, "
                    f"block {tuple(new_state.ensemble.q.shape)}, whole "
                    f"{tuple(whole.shape)}")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int) -> None:
    """One sharded transition through the composed and the fused kernel
    (``parallel.build_sharded_hmc_step``) over an ``n``-rank group of
    processes, on tiny shapes (8 walkers a rank, 4 dims, 3 steps): NCCL
    over ``n`` cards where the host has them, else gloo on CPU processes.
    Each rank checks the group's accept rate and the block and gathered
    shapes; a failing rank raises here."""
    device = "cuda" if torch.cuda.device_count() >= n else "cpu"
    with tempfile.TemporaryDirectory(prefix="pbbi_dryrun_") as directory:
        torch.multiprocessing.start_processes(
            _dry_rank, args=(n, directory, device), nprocs=n, join=True,
            start_method="spawn")
