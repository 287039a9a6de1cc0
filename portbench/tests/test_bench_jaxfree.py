"""The run's look for JAX and the JAX package compares whole top-level
names; the harness, the reference and the program load neither, and the
reference loads nothing of the program."""

import subprocess
import sys
import types

import pytest

from portbench import harness


@pytest.mark.parametrize("name,found", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("physicsbasedbayesianinference_tpu", True),
    ("physicsbasedbayesianinference_tpu.ops", True),
    ("physicsbasedbayesianinference_tpu_torch", False),
    ("physicsbasedbayesianinference_tpu_torch.hmc", False),
    ("jaxtyping", False)])
def test_whole_top_level_names(monkeypatch, name, found):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in harness.forbidden_modules()) == found


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT, check=True)
    return set(out.stdout.split())


def test_harness_and_program_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.harness, portbench.trace, portbench.control;"
            "import portbench.reference.hmc;"
            "import physicsbasedbayesianinference_tpu_torch as p;"
            "import physicsbasedbayesianinference_tpu_torch.models;"
            "import physicsbasedbayesianinference_tpu_torch.parallel;"
            "[portbench.harness.load_module(k, n) for k, n in ("
            "('configs', 'logistic_regression'), ('configs', 'std_normal'),"
            "('ports', 'logistic_regression'), ('ports', 'std_normal'),"
            "('entries', 'run_hmc'), ('entries', 'run_chees_hmc'))];"
            "print(*portbench.harness.forbidden_modules())")
    assert _loaded(code) == set()


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.reference.hmc, portbench.ess;"
            "from portbench import harness;"
            "harness.load_module('configs', 'logistic_regression');"
            "harness.load_module('configs', 'std_normal');"
            "print(*{m.split('.')[0] for m in sys.modules})")
    tops = _loaded(code)
    assert not tops & {"physicsbasedbayesianinference_tpu_torch",
                       *harness.FORBIDDEN}
