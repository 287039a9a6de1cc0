"""physicsbasedbayesianinference_tpu_torch — ensemble HMC in PyTorch with
hand-written CUDA transition kernels for NVIDIA Hopper.

The port of ``physicsbasedbayesianinference_tpu`` (JAX on a TPU, kept in the
repository as the reference). It imports torch and never JAX. It covers
fixed-length ensemble HMC through :func:`run_hmc` (constants, the ensemble
state, the analytic potentials, the splitting integrators with kernel D's
``pallas_leapfrog``, warmup adaptation, the fused transition kernels and
the diagnostics) and direct N-body simulation in :mod:`.physics`, whose
accelerations run kernel E on CUDA.
"""

from . import (adaptation, constants, device, diagnostics, ensemble, hmc,
               native, ops, physics, utils)
from .constants import NATURAL, SI, Constants, solar_system_units
from .device import default_device
from .ensemble import (
    EnsembleState,
    kinetic_energy,
    new_ensemble,
    sample_momenta,
    sample_positions,
)
from .hmc import (HMCInfo, HMCKernel, HMCRunResult, HMCState,
                  build_fused_hmc_kernel, build_hmc_kernel, run_hmc)

__all__ = [
    "adaptation",
    "constants",
    "device",
    "diagnostics",
    "ensemble",
    "hmc",
    "native",
    "ops",
    "physics",
    "utils",
    "Constants",
    "NATURAL",
    "SI",
    "solar_system_units",
    "default_device",
    "EnsembleState",
    "new_ensemble",
    "sample_positions",
    "sample_momenta",
    "kinetic_energy",
    "HMCState",
    "HMCInfo",
    "HMCKernel",
    "HMCRunResult",
    "build_fused_hmc_kernel",
    "build_hmc_kernel",
    "run_hmc",
]
