"""The diagonal forms of kernels B and D on the CPU (``"diag"``, form 5,
and ``"diag_model"``, form 12: the funnel model under ``reparam="auto"``),
and the port's device rule.

1. The forms' plain versions (``kernels._diag_vg``, ``_diag_model_vg``),
   which sum the value over dims as the kernels' lanes do, against the
   JAX package on the same numpy inputs: the funnel model under
   ``make_model_potential(funnel, reparam="auto")`` at D = 5 and 16
   (value and gradient, rtol 1e-4, atol 1e-5 as in
   ``test_torch_model_forms.py``: the DSL sums its log densities in
   another order and adds their constants one by one), and the harmonic
   and standard-normal potentials (the value rtol 2e-6: D positive terms
   summed in another order; the gradient k q, one rounding on both
   sides, equal).
2. Kernel B's wrapper on CPU tensors (its plain version) at D = 16: a call
   on three rungs gives each rung the bits of a call on that rung alone.
3. The device rule: with no card and no request for the CPU, the
   constructors and entry points raise and name the request; each way of
   asking (``device="cpu"``, CPU tensors, ``device.set_default_device``)
   runs on the CPU; a test module's request for the CPU ends with its
   tests.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import physicsbasedbayesianinference_tpu_torch as pt
from physicsbasedbayesianinference_tpu import models as jm
from physicsbasedbayesianinference_tpu.ops import potentials as jp
from physicsbasedbayesianinference_tpu_torch import device as tdevice
from physicsbasedbayesianinference_tpu_torch import graft_entry, physics
from physicsbasedbayesianinference_tpu_torch import models as tm
from physicsbasedbayesianinference_tpu_torch import parallel as tpar
from physicsbasedbayesianinference_tpu_torch.ops import kernels as tk
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp
from _torch_cpu import cpu_requested  # noqa: F401  (the CPU, asked for)

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d", [5, 16])
def test_diag_model_form_matches_the_jax_funnel_under_auto(d):
    kw = {"dim": d - 1}
    jmp = jm.make_model_potential(jm.examples.funnel, (), kw,
                                  reparam="auto")
    tmp = tm.make_model_potential(tm.funnel, (), kw, reparam="auto",
                                  device="cpu")
    form = tmp.potential.device_form
    assert form[0] == "diag_model" and tmp.num_dims == d
    q = np.random.default_rng(d).normal(size=(41, d)).astype(np.float32)
    fu, fg = tk.device_value_and_grad(form)(torch.as_tensor(q))
    ju, jg = jp.batched_value_and_grad(jmp.potential)(jnp.asarray(q))
    np.testing.assert_allclose(fu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_allclose(fg.numpy(), np.asarray(jg), **TOL)
    # the constant aside, the diagonal form's own bits
    du, dg = tk.device_value_and_grad(("diag", form[1][:2]))(
        torch.as_tensor(q))
    assert torch.equal(fu, du + form[1][2][0]) and torch.equal(fg, dg)


@pytest.mark.parametrize("d", [1, 5, 16, 33])
@pytest.mark.parametrize("kind", ["harmonic", "standard_normal"])
def test_diag_form_matches_the_jax_diagonal_potentials(kind, d):
    rng = np.random.default_rng(100 + d)
    if kind == "harmonic":
        k = rng.uniform(0.5, 2.0, d).astype(np.float32)
        jfn = jp.make_harmonic(jnp.asarray(k))
        tfn = tp.make_harmonic(k, device="cpu")
    else:
        k = np.ones(d, np.float32)
        jfn = jp.make_standard_normal(d)
        tfn = tp.make_standard_normal(d)
    # the JAX potential's own (k, mean): what kernel A and the diagonal
    # form are given on either side
    jk, jmu = jfn.diag_quadratic
    np.testing.assert_array_equal(np.broadcast_to(np.asarray(jk), (d,)), k)
    assert float(jmu) == 0.0 and tfn.diag_quadratic[1] == 0.0
    q = (2.0 * rng.normal(size=(37, d))).astype(np.float32)
    form = ("diag", (torch.as_tensor(k), torch.zeros(d)))
    fu, fg = tk.device_value_and_grad(form)(torch.as_tensor(q))
    ju, jg = jp.batched_value_and_grad(jfn)(jnp.asarray(q))
    np.testing.assert_allclose(fu.numpy(), np.asarray(ju), rtol=2e-6)
    np.testing.assert_array_equal(fg.numpy(), np.asarray(jg))
    tu = tfn(torch.as_tensor(q))
    np.testing.assert_allclose(fu.numpy(), tu.numpy(), rtol=2e-6)


def test_diag_form_value_sums_as_the_lanes_do():
    """Lane l of T adds its dims 4 l .. 4 l + 3 in order, then the xor
    butterfly: at D = 16 (T = 4) that is ((a0 + a1) + (a2 + a3)) with a_l
    the lane's sum, which torch.sum need not give."""
    q = torch.as_tensor(np.random.default_rng(7).normal(
        size=(64, 16)).astype(np.float32))
    k = torch.linspace(0.1, 3.0, 16)
    u, _ = tk.device_value_and_grad(("diag", (k, torch.zeros(16))))(q)
    terms = k * q * q
    lanes = [((terms[:, 4 * l] + terms[:, 4 * l + 1]) + terms[:, 4 * l + 2])
             + terms[:, 4 * l + 3] for l in range(4)]
    assert torch.equal(u, 0.5 * ((lanes[0] + lanes[2])
                                 + (lanes[1] + lanes[3])))


def _funnel_auto_case(w, d, rungs=None):
    form = tm.make_model_potential(tm.funnel, (), {"dim": d - 1},
                                   reparam="auto",
                                   device="cpu").potential.device_form
    rng = np.random.default_rng(w + d)
    shape = (w, d) if rungs is None else (rungs, w, d)
    q = torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    vg = tk.device_value_and_grad(form)
    if rungs is None:
        u, g = vg(q)
    else:
        u, g = (torch.stack(x) for x in zip(*(vg(x) for x in q)))
    im = torch.as_tensor(rng.uniform(0.5, 2.0, d).astype(np.float32))
    r = 1 if rungs is None else rungs
    betas = torch.linspace(1.0, 0.4, r)
    scalars = torch.stack([0.3 / betas.sqrt(), betas,
                           torch.linspace(1.0, 0.7, r)], 1)
    p_std = torch.sqrt(1.0 / (im * betas[:, None]))
    if rungs is None:
        scalars, p_std = scalars[0], p_std[0]
    return form, q, u, g, dict(scalars=scalars, p_std=p_std, inv_mass=im)


@pytest.mark.parametrize("variant", ["fixed", "counted+proposal"])
def test_kernel_b_diag_model_wrapper_on_cpu_rungs_are_their_own_calls(
        variant):
    """D = 16, W = 37: the wrapper on CPU tensors is the plain version, bit
    for bit, and a call on three rungs gives each rung the bits of its own
    call with its key, scalars and momentum std."""
    form, q, u, g, kw = _funnel_auto_case(37, 16, rungs=3)
    extra = (dict(num_steps=8) if variant == "fixed" else
             dict(num_steps=torch.tensor([5], dtype=torch.int32),
                  max_steps=8, emit_proposal=True))
    seeds = [11, 12, 13]
    before = tk.fused_hmc_transition.launches
    whole = tk.fused_hmc_transition(form, seeds, 4, q, u, g, **kw, **extra)
    for r, seed in enumerate(seeds):
        kr = dict(scalars=kw["scalars"][r], p_std=kw["p_std"][r],
                  inv_mass=kw["inv_mass"])
        one = tk.fused_hmc_transition(form, seed, 4, q[r], u[r], g[r],
                                      **kr, **extra)
        plain = tk.fused_hmc_transition_plain(form, seed, 4, q[r], u[r],
                                              g[r], **kr, **extra)
        assert len(one) == (8 if variant != "fixed" else 6)
        for a, b, c in zip(whole, one, plain):
            assert torch.equal(a[r], b) and torch.equal(b, c)
    # the plain route is no launch
    assert tk.fused_hmc_transition.launches == before


# --- the device rule -------------------------------------------------------

def _makers():
    """Constructors and entry points that, given nothing that names a
    device, resolve ``device.default_device()``."""
    q = np.zeros((8, 2), np.float32)
    return {
        "make_harmonic": lambda **d: tp.make_harmonic([1.0, 2.0], **d),
        "new_ensemble": lambda **d: pt.new_ensemble(4, 3, **d),
        "make_model_potential": lambda **d: tm.make_model_potential(
            tm.funnel, (), {"dim": 3}, reparam="auto", **d),
        "new_system": lambda **d: physics.new_system(
            np.zeros((2, 3)), np.zeros((2, 3)), [1.0, 1.0], **d),
        "run_hmc": lambda **d: pt.run_hmc(
            0, tp.make_standard_normal(2),
            q if not d else torch.as_tensor(q, device=d["device"]),
            num_warmup=2, num_samples=2, num_steps=2),
        "graft_entry": lambda **d: graft_entry.entry(**d),
    }


@pytest.fixture
def no_card(monkeypatch):
    """No CUDA device and no process-wide request for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tdevice, "_requested", None)


@pytest.mark.parametrize("name", sorted(_makers()))
def test_no_card_and_no_request_raises(no_card, name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _makers()[name]()


def test_no_card_and_no_request_raises_in_the_process_group(no_card,
                                                            tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpar.initialize_distributed(f"file://{tmp_path}/rendezvous", 2, 0)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        graft_entry.dryrun_multichip(2)


@pytest.mark.parametrize("how", ["argument", "set_default_device"])
@pytest.mark.parametrize("name", sorted(_makers()))
def test_an_explicit_cpu_request_runs(no_card, monkeypatch, name, how):
    if how == "argument":
        made = _makers()[name](device="cpu")
    else:
        pt.set_default_device("cpu")
        assert pt.default_device() == torch.device("cpu")
        made = _makers()[name]()
        pt.set_default_device(None)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.default_device()
    assert made is not None


def test_cpu_tensors_are_a_request(no_card):
    """A CPU tensor handed in keeps its device: run_hmc on CPU tensors and
    a potential built from CPU tensors need no other request."""
    k = torch.tensor([1.0, 2.0])
    res = pt.run_hmc(0, tp.make_harmonic(k), torch.zeros(16, 2),
                     num_warmup=2, num_samples=2, num_steps=2)
    assert res.samples.device.type == "cpu"
    assert tdevice.resolve_device(None, k) == torch.device("cpu")


def test_the_cpu_request_stays_in_the_modules_that_make_it(tmp_path):
    """A pytest session that collects a module asking for the CPU
    (``_torch_cpu.cpu_requested``) before one that does not: the first
    module's tests get the CPU by default, the second's no request at all,
    as the card's tests in ``test_torch_cuda.py`` must."""
    tests = Path(__file__).resolve().parent
    (tmp_path / "test_a_asks.py").write_text(
        "import sys, torch\n"
        f"sys.path.insert(0, {str(tests)!r})\n"
        "from _torch_cpu import cpu_requested  # noqa: F401\n"
        "from physicsbasedbayesianinference_tpu_torch import device\n"
        "def test_asks():\n"
        "    assert device.default_device() == torch.device('cpu')\n")
    (tmp_path / "test_b_does_not.py").write_text(
        "from physicsbasedbayesianinference_tpu_torch import device\n"
        "def test_does_not():\n"
        "    assert device._requested is None\n")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "--rootdir", str(tmp_path),
         "test_a_asks.py", "test_b_does_not.py"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(tests.parent), os.environ.get("PYTHONPATH", "")])})
    assert proc.returncode == 0 and "2 passed" in proc.stdout, (
        proc.stdout[-2000:], proc.stderr[-2000:])
