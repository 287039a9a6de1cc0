"""The port's ring N-body functions (``parallel/ring.py``) at K = 2 and K = 4
gloo ranks on the CPU (the rank processes of ``test_torch_parallel.py``'s
launcher), whose tile is kernel E's plain source-block form, against the
port's dense functions and the JAX package's ring functions on the
8-device host mesh of ``tests/test_ring.py``.

Tolerances: float32 accelerations to 1e-5 (the JAX ring test's), energies
to 1e-5 relative, positions after 10 velocity-Verlet steps to 1e-5; the
float64 accelerations to 1e-12 relative of the dense ones.
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from test_torch_parallel import join_group, spawn_ranks

from physicsbasedbayesianinference_tpu_torch import parallel as par
from physicsbasedbayesianinference_tpu_torch.ops import kernels
from physicsbasedbayesianinference_tpu_torch.ops.potentials import (
    nbody_accelerations, nbody_potential_energy)

N = 32
SIM = dict(num_steps=10, save_every=5, softening=0.05)
DT = 0.01


def _system(n=N, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = 2.0 * rng.standard_normal((n, 3))
    v = 0.1 * rng.standard_normal((n, 3))
    m = rng.uniform(0.5, 2.0, n)
    return tuple(torch.from_numpy(a.astype(dtype)) for a in (x, v, m))


def _worker(rank: int, k: int, directory: str) -> None:
    mesh = join_group(rank, k, directory)
    bodies = par.make_body_mesh()
    assert bodies.axis_name == "bodies" and bodies.size == k
    out = {}
    for dtype in (np.float32, np.float64):
        x, v, m = _system(dtype=dtype)
        out["acc", dtype] = par.gather_walkers(
            par.ring_nbody_accelerations(x, m, mesh=bodies, softening=1e-3),
            mesh)
        out["pot", dtype] = par.ring_nbody_potential_energy(
            x, m, mesh=bodies, softening=1e-3)
    x, v, m = _system()
    xf, vf, energies = par.ring_simulate(x, v, m, DT, mesh=bodies, **SIM)
    out["sim"] = (par.gather_walkers(xf, mesh), par.gather_walkers(vf, mesh),
                  energies)
    # 30 bodies padded to 32, the padding's accelerations dropped
    xp, mp_, n = par.pad_bodies(x[:30], m[:30], 4 * k)
    out["padded"] = par.gather_walkers(par.ring_nbody_accelerations(
        xp, mp_, mesh=bodies, softening=1e-3), mesh)[:n]
    if rank == 0:
        from pathlib import Path
        torch.save(out, Path(directory) / "rank0.pt")


@pytest.fixture(scope="module", params=[2, 4], ids=["K2", "K4"])
def ranks(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"ring_k{request.param}")
    return spawn_ranks(__file__, request.param, tmp)[0]


def _dense_simulate(x, v, m):
    """The same velocity Verlet, one process, the one-set accelerations."""
    def accel(y):
        return kernels.nbody_accelerations_tiled(
            y, m, g_const=1.0, softening=SIM["softening"])
    dt = torch.tensor(DT)
    a = accel(x)
    for _ in range(SIM["num_steps"]):
        vh = v + 0.5 * dt * a
        x = x + dt * vh
        a = accel(x)
        v = vh + 0.5 * dt * a
    return x, v


def test_ring_matches_port_dense(ranks):
    for dtype, tol in ((np.float32, 1e-5), (np.float64, 1e-12)):
        x, _, m = _system(dtype=dtype)
        dense = nbody_accelerations(x, m, softening=1e-3)
        torch.testing.assert_close(ranks["acc", dtype], dense, rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(
            ranks["pot", dtype],
            nbody_potential_energy(x, m, softening=1e-3), rtol=tol, atol=0)
    x, v, m = _system()
    xd, vd = _dense_simulate(x, v, m)
    xf, vf, _ = ranks["sim"]
    torch.testing.assert_close(xf, xd, rtol=0, atol=1e-5)
    torch.testing.assert_close(vf, vd, rtol=0, atol=1e-5)
    torch.testing.assert_close(
        ranks["padded"], nbody_accelerations(x[:30], m[:30], softening=1e-3),
        rtol=1e-5, atol=1e-5)


def test_ring_matches_jax_ring(ranks):
    import jax
    import jax.numpy as jnp
    from physicsbasedbayesianinference_tpu.parallel import ring as jring
    mesh = jring.make_body_mesh(jax.devices())
    x, v, m = (jnp.asarray(a.numpy()) for a in _system())
    np.testing.assert_allclose(
        ranks["acc", np.float32].numpy(),
        np.asarray(jring.ring_nbody_accelerations(x, m, mesh=mesh,
                                                  softening=1e-3)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(ranks["pot", np.float32]),
        float(jring.ring_nbody_potential_energy(x, m, mesh=mesh,
                                                softening=1e-3)), rtol=1e-5)
    xj, vj, ej = jring.ring_simulate(x, v, m, DT, mesh=mesh, **SIM)
    xf, vf, energies = ranks["sim"]
    np.testing.assert_allclose(xf.numpy(), np.asarray(xj), atol=1e-5)
    np.testing.assert_allclose(vf.numpy(), np.asarray(vj), atol=1e-5)
    np.testing.assert_allclose(energies.numpy(), np.asarray(ej), rtol=1e-5)


def test_pad_bodies_matches_jax_and_body_divisibility():
    from physicsbasedbayesianinference_tpu.parallel import ring as jring
    import jax.numpy as jnp
    x, v, m = _system(n=30)
    for got, want in zip(par.pad_bodies(x, m, 8, v=v),
                         jring.pad_bodies(jnp.asarray(x.numpy()),
                                          jnp.asarray(m.numpy()), 8,
                                          v=jnp.asarray(v.numpy()))):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-6)
    assert par.pad_bodies(x, m, 5)[2] == 30
    mesh = par.WalkerMesh(group=None, rank=0, size=4,
                          device=torch.device("cpu"), axis_name="bodies")
    for fn in (par.ring_nbody_accelerations,
               par.ring_nbody_potential_energy):
        with pytest.raises(ValueError, match="divisible by the mesh size 4"):
            fn(x, m, mesh=mesh)
    with pytest.raises(ValueError, match="divisible by the mesh size 4"):
        par.ring_simulate(x, v, m, DT, mesh=mesh, num_steps=2)
    with pytest.raises(ValueError, match="multiple of save_every"):
        par.ring_simulate(x, v, m, DT, mesh=mesh, num_steps=3, save_every=2)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
