"""physicsbasedbayesianinference_tpu_torch — ensemble HMC in PyTorch with
hand-written CUDA transition kernels for NVIDIA Hopper.

The port of ``physicsbasedbayesianinference_tpu`` (JAX on a TPU, kept in the
repository as the reference). It imports torch and never JAX. It covers
fixed-length ensemble HMC through :func:`run_hmc` (constants, the ensemble
state, the analytic potentials, the splitting integrators with kernel D's
``pallas_leapfrog``, warmup adaptation, the fused transition kernels and
the diagnostics), the model DSL in :mod:`.models` with ChEES-HMC
(:func:`run_chees_hmc`, trajectory-length adaptation, fused on models that
have a device form), tempered SMC (:func:`run_smc`) and parallel tempering
(:func:`run_parallel_tempering`), both mutating in the fused kernels at a
beta read on the device, lockstep NUTS (:func:`run_nuts`), direct
N-body simulation in :mod:`.physics`, whose accelerations run kernel E on
CUDA, and the runtime: :class:`RunConfig`, checkpoints
(:class:`CheckpointManager`), the sample sink (:class:`SampleSink`,
:func:`read_samples`) and the command-line driver
``python -m physicsbasedbayesianinference_tpu_torch.main``. Multi-process
runs (one process per card under ``torch.distributed``: every sampler over
a walker group, parallel tempering over a replica x walker group, the ring
N-body forces) are in :mod:`.parallel`; tree and plot helpers in
:mod:`.utils`, the compile-and-run entry points in :mod:`.graft_entry`.
"""

from . import (adaptation, checkpoint, chees, config, constants, device,
               diagnostics, ensemble, hmc, models, native, nuts, ops,
               parallel, physics, smc, tempering, utils)
from .checkpoint import CheckpointManager
from .chees import ChEESRunResult, run_chees_hmc
from .config import RunConfig
from .constants import NATURAL, SI, Constants, solar_system_units
from .device import default_device, set_default_device
from .ensemble import (
    EnsembleState,
    kinetic_energy,
    new_ensemble,
    sample_momenta,
    sample_positions,
)
from .hmc import (HMCInfo, HMCKernel, HMCRunResult, HMCState,
                  build_dense_hmc_kernel, build_fused_hmc_kernel,
                  build_hmc_kernel, run_hmc)
from .native import SampleSink, read_samples
from .nuts import NUTSInfo, NUTSKernel, build_nuts_kernel, run_nuts
from .smc import SMCResult, run_smc
from .tempering import PTResult, run_parallel_tempering

__all__ = [
    "adaptation",
    "chees",
    "constants",
    "device",
    "diagnostics",
    "ensemble",
    "hmc",
    "models",
    "native",
    "ops",
    "parallel",
    "physics",
    "utils",
    "Constants",
    "NATURAL",
    "SI",
    "solar_system_units",
    "default_device",
    "set_default_device",
    "EnsembleState",
    "new_ensemble",
    "sample_positions",
    "sample_momenta",
    "kinetic_energy",
    "HMCState",
    "HMCInfo",
    "HMCKernel",
    "HMCRunResult",
    "build_dense_hmc_kernel",
    "build_fused_hmc_kernel",
    "build_hmc_kernel",
    "run_hmc",
    "smc",
    "SMCResult",
    "run_smc",
    "tempering",
    "ChEESRunResult",
    "run_chees_hmc",
    "PTResult",
    "run_parallel_tempering",
    "nuts",
    "NUTSInfo",
    "NUTSKernel",
    "build_nuts_kernel",
    "run_nuts",
    "checkpoint",
    "config",
    "CheckpointManager",
    "RunConfig",
    "SampleSink",
    "read_samples",
]
