"""The two model device forms (``"logistic"``, ``"eight_schools_nc"``):
their plain versions, which sum in the CUDA kernels' order, against the
DSL potentials of the port (``vmap(grad_and_value)``) and of the JAX
package (``batched_value_and_grad``) on the same numpy inputs, and the
registry that attaches them.

Tolerance: value and gradient rtol=1e-4, atol=1e-5, float32 (found: up to
2e-5 relative in the value, whose 256 likelihood terms the form sums lane
by lane; the gradients agree to about 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import models as jm
from physicsbasedbayesianinference_tpu.ops import potentials as jp
from physicsbasedbayesianinference_tpu_torch import models as tm
from physicsbasedbayesianinference_tpu_torch.models import core as tcore
from physicsbasedbayesianinference_tpu_torch.models import distributions as td
from physicsbasedbayesianinference_tpu_torch.ops import kernels as tk
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp

TOL = dict(rtol=1e-4, atol=1e-5)


def _logistic(n, p):
    x, y = tm.logistic_regression_data(n, p)
    jmp = jm.make_model_potential(jm.examples.logistic_regression,
                                  (jnp.asarray(x), jnp.asarray(y)), {})
    tmp = tm.make_model_potential(tm.logistic_regression, (x, y), {},
                                  device="cpu")
    return jmp, tmp, 0.3


def _eight_schools():
    data = tm.EIGHT_SCHOOLS_DATA
    jmp = jm.make_model_potential(
        jm.examples.eight_schools_noncentered, (),
        {"J": 8, "sigma": jnp.asarray(data["sigma"]),
         "y": jnp.asarray(data["y"])})
    tmp = tm.make_model_potential(tm.eight_schools_noncentered, (), data,
                                  device="cpu")
    return jmp, tmp, 1.0


CASES = {
    "logistic N=256 D=32": lambda: _logistic(256, 31),
    "logistic N=7 D=6": lambda: _logistic(7, 5),
    "logistic N=40 D=34": lambda: _logistic(40, 33),
    "eight_schools_nc D=10": _eight_schools,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_form_matches_both_dsl_potentials(case):
    jmp, tmp, spread = CASES[case]()
    form = tmp.potential.device_form
    assert form is not None and form[0] == case.split()[0]
    assert tk.generic_unsupported(form, tmp.num_dims) is None
    assert tk.leapfrog_unsupported(form, tmp.num_dims) is None
    q = (spread * np.random.default_rng(2).normal(
        size=(33, tmp.num_dims))).astype(np.float32)
    fu, fg = tk.device_value_and_grad(form)(torch.as_tensor(q))
    tu, tg = tp.batched_value_and_grad(tmp.potential)(torch.as_tensor(q))
    ju, jg = jp.batched_value_and_grad(jmp.potential)(jnp.asarray(q))
    for u, g in ((tu.numpy(), tg.numpy()), (np.asarray(ju), np.asarray(jg))):
        np.testing.assert_allclose(fu.numpy(), u, **TOL)
        np.testing.assert_allclose(fg.numpy(), g, **TOL)


def test_forms_are_attached_by_model_function_only():
    x, y = tm.logistic_regression_data(16, 3)
    kw = dict(device="cpu")
    assert tm.make_model_potential(
        tm.logistic_regression, (x, y), {}, **kw
    ).potential.device_form[0] == "logistic"
    # data given by keyword reaches the form too
    mp = tm.make_model_potential(tm.logistic_regression, (),
                                 {"x": x, "labels": y}, **kw)
    name, (fx, fy) = mp.potential.device_form
    assert fx.shape == (16, 3) and fy.shape == (16,)
    assert fx.dtype == torch.float32 and fx.is_contiguous()
    # a reparameterised wrapper, even one that rewrites nothing
    assert tm.make_model_potential(
        tm.logistic_regression, (x, y), {}, reparam="auto", **kw
    ).potential.device_form is None
    assert tm.make_model_potential(
        tm.eight_schools_noncentered, (), tm.EIGHT_SCHOOLS_DATA,
        reparam={"theta_raw": False}, **kw).potential.device_form is None

    def subsampled(x, labels):  # the same model over a subsampled plate
        with tcore.plate("features", x.shape[-1]):
            w = tcore.sample("w", td.Normal(0.0, 1.0))
        b = tcore.sample("b", td.Normal(0.0, 1.0))
        with tcore.plate("N", x.shape[0], subsample_size=4,
                         generator=torch.Generator().manual_seed(0)) as idx:
            tcore.sample("obs", td.BernoulliLogits(x[idx] @ w + b),
                         obs=labels[idx])

    assert tm.make_model_potential(
        subsampled, (x, y), {}, **kw).potential.device_form is None
    # registered models only: the centred eight schools has no form
    assert tm.make_model_potential(
        tm.eight_schools, (), tm.EIGHT_SCHOOLS_DATA, **kw
    ).potential.device_form is None
    assert tm.device_form_for(lambda: None, (), {}, "cpu") is None
    # every potential carries the three attributes the engines read
    mp = tm.make_model_potential(tm.funnel, **kw)
    assert (mp.potential.device_form, mp.potential.diag_quadratic,
            mp.potential.analytic_grad) == (None, None, None)


def test_form_limits_are_decided_before_any_launch():
    y8 = torch.as_tensor(tm.EIGHT_SCHOOLS_DATA["y"])
    form = ("eight_schools_nc", (y8, y8.abs() + 1.0, torch.zeros(1)))
    assert "takes D=10" in tk.generic_unsupported(form, 16)
    # N * P + N parameter floats over the staging limit
    big = ("logistic", (torch.zeros(2048, 31), torch.zeros(2048)))
    assert "exceed" in tk.generic_unsupported(big, 32)
    # few columns, many rows: under that limit, but the padded rows and the
    # block's buffers pass the card's shared memory
    wide = ("logistic", (torch.zeros(8000, 1), torch.zeros(8000)))
    assert "shared memory" in tk.generic_unsupported(wide, 2)
    assert tk.logistic_shared_bytes(256, 32) == 4 * (256 * 37 + 32 * 36)
    ok = ("logistic", (torch.zeros(256, 31), torch.zeros(256)))
    assert tk.generic_unsupported(ok, 32) is None
    assert "parameters" in tk.generic_unsupported(("logistic", (y8,)), 3)
    # a too-large model is routed to the composed engine when it is built
    from physicsbasedbayesianinference_tpu_torch import hmc

    def potential(q):
        return 0.5 * torch.sum(q * q, dim=-1)

    potential.device_form = big
    assert hmc.resolve_engine("auto", potential,
                              torch.zeros(4, 32)) == "composed"


def test_fused_engine_on_cpu_runs_the_model_forms():
    """The CPU fused engine (the kernels' plain versions) on eight schools:
    (u, g) of the returned state are the DSL potential's at the returned
    q, and a tensor leapfrog count gives the int count's bits."""
    from physicsbasedbayesianinference_tpu_torch import hmc
    tmp = tm.make_model_potential(tm.eight_schools_noncentered, (),
                                  tm.EIGHT_SCHOOLS_DATA, device="cpu")
    fused = hmc.FusedTransition(tmp.potential)
    assert fused.variant_for(64, 10) == "generic"
    vg = tp.batched_value_and_grad(tmp.potential)
    state = hmc.init_state(vg, tmp.init(0, 64) * 0.25)
    a, info, prop = fused((3, 0), state, 0.1, num_steps=5,
                          emit_proposal=True)
    b, _, none = fused((3, 0), state, 0.1, max_steps=9,
                       num_steps=torch.tensor([5], dtype=torch.int32))
    assert none is None and torch.equal(a.ensemble.q, b.ensemble.q)
    assert 0 < int(info.accepted.sum()) <= 64
    u, g = vg(a.ensemble.q)
    np.testing.assert_allclose(a.potential_energy.numpy(), u.numpy(), **TOL)
    np.testing.assert_allclose(a.grad.numpy(), g.numpy(), **TOL)
    acc = info.accepted
    assert torch.equal(prop[0][acc], a.ensemble.q[acc])
    assert not torch.equal(prop[0][~acc], a.ensemble.q[~acc]) or \
        not bool((~acc).any())
