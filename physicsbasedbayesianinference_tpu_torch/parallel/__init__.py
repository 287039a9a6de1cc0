"""Walker-axis and body-axis parallelism over processes (port of the JAX
package's ``parallel/``).

The JAX package shards the ensemble over one ``walkers`` axis of a device
mesh and lets XLA insert the collectives. Here a shard is one process per
device under ``torch.distributed`` (NCCL between cards, gloo between CPU
processes): each rank runs the fused kernels on its own block of walkers,
drawing by global walker index, and the samplers reduce their ensemble
statistics over the group themselves. Launch K processes with
``python -m torch.distributed.run --nproc_per_node=K ...`` and call
:func:`initialize_distributed` in each.

Not ported yet: the replica mesh of sharded parallel tempering
(``make_replica_mesh``, ``replica_sharding``), sharded ChEES, NUTS and
dense-metric runs, sharded checkpoints; JAX's ``walker_sharding`` and
``replicated_sharding`` have no counterpart (:mod:`.mesh`).
"""

from .distributed import initialize_distributed
from .mesh import (
    WALKER_AXIS,
    WalkerMesh,
    gather_walkers,
    make_walker_mesh,
    shard_ensemble,
)
from .resample import ring_systematic_resample
from .ring import (
    BODY_AXIS,
    make_body_mesh,
    pad_bodies,
    ring_nbody_accelerations,
    ring_nbody_potential_energy,
    ring_simulate,
)
from .sharded import build_sharded_hmc_step, shard_map_kernel, sharded_run_hmc

__all__ = [
    "make_walker_mesh",
    "shard_ensemble",
    "build_sharded_hmc_step",
    "shard_map_kernel",
    "sharded_run_hmc",
    "initialize_distributed",
    "BODY_AXIS",
    "make_body_mesh",
    "pad_bodies",
    "ring_nbody_accelerations",
    "ring_nbody_potential_energy",
    "ring_simulate",
    "ring_systematic_resample",
    "WALKER_AXIS",
    "WalkerMesh",
    "gather_walkers",
]
