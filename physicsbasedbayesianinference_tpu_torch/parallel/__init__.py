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

Every sampler takes a group: ``run_hmc`` (both metrics), ``run_chees_hmc``,
``run_nuts`` and ``run_smc`` a walker group (``mesh=``), and
``run_parallel_tempering`` a walker group or a replica x walker group
(:func:`make_replica_mesh`); ``checkpoint.CheckpointManager(mesh=)``
writes a file a rank. JAX's ``walker_sharding`` and
``replicated_sharding`` have no counterpart (:mod:`.mesh`).
"""

from .distributed import initialize_distributed
from .mesh import (
    REPLICA_AXIS,
    WALKER_AXIS,
    ReplicaMesh,
    WalkerMesh,
    gather_walkers,
    make_replica_mesh,
    make_walker_mesh,
    shard_ensemble,
    shard_replicas,
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
from .sharded import (build_sharded_hmc_step, fold_rank, shard_map_kernel,
                      sharded_run_hmc)

__all__ = [
    "make_walker_mesh",
    "make_replica_mesh",
    "shard_ensemble",
    "shard_replicas",
    "fold_rank",
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
    "REPLICA_AXIS",
    "WalkerMesh",
    "ReplicaMesh",
    "gather_walkers",
]
