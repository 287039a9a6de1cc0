"""The port imports and runs without JAX (HMC with both integrator routes
and the dense metric, the multi-process modules of ``parallel/``, the model DSL and ChEES-HMC on a model, SMC,
parallel tempering and NUTS, the command-line driver with its config,
checkpoints and sample sink, the physics package, the native parser and
every kernel wrapper), and
``chip_smoke.py`` refuses to run (printing no result) where there is no CUDA
device."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

BLOCK_JAX = ("import sys\n"
             "for name in ('jax', 'jaxlib', 'flax', 'orbax'):\n"
             "    sys.modules[name] = None\n")


def _run(code, timeout=120):
    return subprocess.run([sys.executable, "-c", BLOCK_JAX + code],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


def test_port_imports_and_samples_without_jax():
    proc = _run(
        "import torch\n"
        "import physicsbasedbayesianinference_tpu_torch as pt\n"
        "pt.device.set_default_device('cpu')\n"
        "from physicsbasedbayesianinference_tpu_torch import (adaptation,\n"
        "    constants, diagnostics, ensemble, hmc)\n"
        "from physicsbasedbayesianinference_tpu_torch.ops import (kernels,\n"
        "    philox, potentials, integrators, _build)\n"
        "from physicsbasedbayesianinference_tpu_torch.utils import convert\n"
        "from physicsbasedbayesianinference_tpu_torch import native, physics\n"
        "from physicsbasedbayesianinference_tpu_torch import parallel\n"
        "from physicsbasedbayesianinference_tpu_torch.parallel import (\n"
        "    distributed, mesh, resample, ring, sharded)\n"
        "assert parallel.sharded_run_hmc and parallel.ring_simulate\n"
        "from physicsbasedbayesianinference_tpu_torch.physics import (\n"
        "    integrators as pi, nbody, simulate_lib)\n"
        "from physicsbasedbayesianinference_tpu_torch.ops.kernels import (\n"
        "    leapfrog_trajectory, nbody_accelerations_tiled)\n"
        "r = pt.run_hmc(0, potentials.make_standard_normal(2),\n"
        "               torch.zeros(64, 2), num_warmup=5, num_samples=5,\n"
        "               num_steps=2, integrator='pallas_leapfrog')\n"
        "assert r.samples.shape == (5, 64, 2)\n"
        "from physicsbasedbayesianinference_tpu_torch import chees, models\n"
        "from physicsbasedbayesianinference_tpu_torch.models import (core,\n"
        "    device_forms, distributions, examples, potential, transforms)\n"
        "mp = models.make_model_potential(\n"
        "    models.eight_schools_noncentered, (),\n"
        "    models.EIGHT_SCHOOLS_DATA, device='cpu')\n"
        "assert mp.potential.device_form[0] == 'eight_schools_nc'\n"
        "c = pt.run_chees_hmc(0, mp.potential, mp.init(0, 32),\n"
        "                     num_warmup=5, num_samples=5, max_steps=8)\n"
        "assert c.samples.shape == (5, 32, 10)\n"
        "assert 'numpyro' not in sys.modules\n"
        "from physicsbasedbayesianinference_tpu_torch import (nuts, smc,\n"
        "    tempering)\n"
        "q = torch.randn(64, 2)\n"
        "target = potentials.make_standard_normal(2)\n"
        "s = pt.run_smc(0, target, 3 * q, beta0=0.1, max_stages=3)\n"
        "assert s.q.shape == (64, 2) and s.kernel_used == 'composed'\n"
        "p = pt.run_parallel_tempering(0, target, q, num_replicas=2,\n"
        "    num_warmup=3, num_samples=3)\n"
        "assert p.samples.shape == (3, 64, 2)\n"
        "n = pt.run_nuts(0, target, q, num_warmup=3, num_samples=3,\n"
        "    max_depth=3)\n"
        "assert n.samples.shape == (3, 64, 2)\n"
        "from physicsbasedbayesianinference_tpu_torch import (checkpoint,\n"
        "    config, main)\n"
        "r = pt.run_hmc(0, target, q, num_warmup=3, num_samples=3,\n"
        "               num_steps=2, metric='dense')\n"
        "assert r.kernel_used == 'dense'\n"
        "cfg = pt.RunConfig(num_walkers=16, num_warmup=2, num_samples=2,\n"
        "                   num_steps=2, device='cpu')\n"
        "assert main.run(cfg)['kernel_used'] == 'composed'\n"
        "assert pt.CheckpointManager and pt.SampleSink and pt.read_samples\n"
        "s, tmax, dt = physics.load_nbody_text('examples/nbody/pl3.txt')\n"
        "tr = physics.simulate(s, dt, 4, save_every=2)\n"
        "assert tr.num_valid == 2 and tr.x.shape == (2, 3, 3)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'orbax') and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_a_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = _run("import runpy\n"
                "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "torch.cuda.is_available() is false" in proc.stderr
