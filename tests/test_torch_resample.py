"""The port's ring resampler (``parallel/resample.py``) at K = 2 and K = 4
gloo ranks on the CPU (the rank processes of ``test_torch_parallel.py``'s
launcher), against the one-process systematic resampler of the port, whose
indices it must give exactly, and the JAX package's ring resampler, which
draws another offset and is held to the same law: every walker gets
floor(W w_i) or ceil(W w_i) copies.
"""

from __future__ import annotations


import numpy as np
import pytest
import torch

from test_torch_parallel import join_group, run_rank, spawn_ranks

from physicsbasedbayesianinference_tpu_torch import parallel as par
from physicsbasedbayesianinference_tpu_torch import smc as tsmc

W, D = 64, 3


def _cases():
    """Named log-weights [W]: random, one walker with all the weight,
    a zero-weight block of 16 walkers (a whole rank's at K = 4), equal."""
    rng = np.random.default_rng(4)
    random = 2.0 * rng.standard_normal(W)
    single = np.full(W, -np.inf)
    single[37] = 0.0
    hole = rng.standard_normal(W)
    hole[16:32] = -np.inf
    return {name: torch.from_numpy(v.astype(np.float32)) for name, v in (
        ("random", random), ("single", single), ("hole", hole),
        ("equal", np.zeros(W)))}


def _tree():
    rng = np.random.default_rng(5)
    return {"q": torch.from_numpy(rng.standard_normal((W, D))
                                  .astype(np.float32)),
            "id": torch.arange(W)}


def _worker(rank: int, k: int, directory: str) -> None:
    mesh = join_group(rank, k, directory)
    out = {}
    tree = _tree()
    block = mesh.block(W)
    for name, log_w in _cases().items():
        for stage in (0, 3):
            local = {key: v[block] for key, v in tree.items()}
            res, zeroed = par.ring_systematic_resample(
                17, stage, local, log_w[block], mesh=mesh)
            out[name, stage] = {key: par.gather_walkers(v, mesh)
                                for key, v in res.items()}
            assert torch.equal(zeroed, torch.zeros(W // k))
    # a single tensor as the tree
    res, _ = par.ring_systematic_resample(
        17, 1, tree["q"][block], _cases()["random"][block], mesh=mesh)
    out["tensor"] = par.gather_walkers(res, mesh)
    if rank == 0:
        from pathlib import Path
        torch.save(out, Path(directory) / "rank0.pt")


@pytest.fixture(scope="module", params=[2, 4], ids=["K2", "K4"])
def ranks(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"resample_k{request.param}")
    return spawn_ranks(__file__, request.param, tmp)[0]


def _one_process_indices(log_w, stage):
    gen = tsmc._step_generator((17, tsmc._RESAMPLE_COUNTER + stage),
                               torch.device("cpu"))
    return tsmc.systematic_indices(gen, log_w, W)


def test_ring_indices_are_the_one_process_indices(ranks):
    tree = _tree()
    for name, log_w in _cases().items():
        for stage in (0, 3):
            idx = _one_process_indices(log_w, stage)
            got = ranks[name, stage]
            assert torch.equal(got["id"], idx), (name, stage)
            assert torch.equal(got["q"], tree["q"][idx]), (name, stage)
    idx = _one_process_indices(_cases()["random"], 1)
    assert torch.equal(ranks["tensor"], tree["q"][idx])


def test_ring_resampler_law_matches_jax(ranks):
    """Offspring counts of the port's and the JAX package's ring resampler
    (8-device host mesh, its own offset): both within one of W w_i."""
    import jax
    import jax.numpy as jnp
    from physicsbasedbayesianinference_tpu import parallel as jpar
    mesh = jpar.make_walker_mesh()
    for name, log_w in _cases().items():
        lw = log_w.double()
        expected = W * torch.exp(lw - torch.logsumexp(lw, 0)).numpy()
        out, _ = jpar.ring_systematic_resample(
            jax.random.key(3), {"id": jnp.arange(W)},
            jnp.asarray(log_w.numpy()), mesh=mesh)
        for ids in (ranks[name, 0]["id"].numpy(), np.asarray(out["id"])):
            counts = np.bincount(ids, minlength=W)
            assert counts.sum() == W
            assert np.all(np.abs(counts - expected) < 1.0 + 1e-6), name


if __name__ == "__main__":
    run_rank(_worker)
