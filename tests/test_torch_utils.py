"""The port's last small modules against the JAX package's, on the same
numpy inputs: ``utils.trees`` (``ravel_ensemble``, ``tree_bytes``,
``tree_summary``), the plot helpers under the Agg backend (as
``tests/test_plotting.py`` runs the JAX ones), ``ops.potentials.
numerical_grad`` / ``numerical_force``, ``native.native_available`` and
``graft_entry`` (``entry``, ``dryrun_multichip``)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import native as jnative
from physicsbasedbayesianinference_tpu import utils as jutils
from physicsbasedbayesianinference_tpu.ops import potentials as jpot
from physicsbasedbayesianinference_tpu_torch import graft_entry
from physicsbasedbayesianinference_tpu_torch import native as tnative
from physicsbasedbayesianinference_tpu_torch import utils as tutils
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tpot


def _tree(rng):
    """A per-walker tree of 16 walkers: a dict with a nested list and a
    tuple, keys out of order (both packages visit them sorted)."""
    return {"z": rng.normal(size=(16, 3, 2)).astype(np.float32),
            "a": [rng.normal(size=(16,)).astype(np.float32),
                  (rng.normal(size=(16, 4)).astype(np.float32),)]}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def test_ravel_ensemble_matches_jax_and_unravels():
    tree = _tree(np.random.default_rng(0))
    flat_j, unravel_j = jutils.ravel_ensemble(_map(jnp.asarray, tree))
    flat_t, unravel_t = tutils.ravel_ensemble(_map(torch.from_numpy, tree))
    assert flat_t.shape == (16, 11)
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    # a batch of draws [S, W, D] unravels to [S, W, *site shape]
    draws = np.random.default_rng(1).normal(size=(5, 16, 11)).astype(
        np.float32)
    back_j = unravel_j(jnp.asarray(draws))
    back_t = unravel_t(torch.from_numpy(draws))
    assert back_t["z"].shape == (5, 16, 3, 2)
    assert isinstance(back_t["a"], list) and isinstance(back_t["a"][1],
                                                        tuple)
    for got, want in ((back_t["z"], back_j["z"]),
                      (back_t["a"][0], back_j["a"][0]),
                      (back_t["a"][1][0], back_j["a"][1][0])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    again = unravel_t(flat_t)
    np.testing.assert_array_equal(again["z"].numpy(), tree["z"])


def test_tree_bytes_and_summary_match_jax():
    """The same bytes; the same lines but for the placement, which the
    port prints as the device where JAX prints the sharding."""
    tree = _tree(np.random.default_rng(2))
    tree["n"] = np.arange(6, dtype=np.int32).reshape(2, 3)
    jtree = _map(jnp.asarray, tree)
    ttree = _map(torch.from_numpy, tree)
    assert tutils.tree_bytes(ttree) == jutils.tree_bytes(jtree) == (
        16 * 11 * 4 + 6 * 4)
    assert tutils.tree_bytes(tree) == jutils.tree_bytes(jtree)
    got, want = (s.splitlines() for s in (tutils.tree_summary(ttree),
                                          jutils.tree_summary(jtree)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.split(" @ ")[0] == w.split(" @ ")[0]
        assert g.endswith(" @ cpu")


@pytest.mark.parametrize("helper", ["trajectories", "error", "samples",
                                    "energy"])
def test_plot_helpers_draw_under_agg(tmp_path, helper):
    """Each helper from tensors and from numpy arrays writes a figure, as
    the JAX helpers do; matplotlib loads with the module, on first use."""
    pytest.importorskip("matplotlib")
    from physicsbasedbayesianinference_tpu_torch.utils import plotting
    rng = np.random.default_rng(3)
    dts = np.geomspace(1e-3, 0.1, 5)
    cases = {
        "trajectories": lambda conv, path: plotting.plot_trajectories(
            conv(np.cumsum(rng.normal(size=(50, 3, 3)), 0)),
            body_names=["a", "b", "c"], save_path=path),
        "error": lambda conv, path: plotting.plot_error_vs_stepsize(
            conv(dts), {"leapfrog": conv(dts**2)}, save_path=path),
        "samples": lambda conv, path: plotting.plot_samples(
            conv(rng.normal(size=(4, 25, 2))),
            reference_samples=conv(rng.normal(size=(100, 2))),
            save_path=path),
        "energy": lambda conv, path: plotting.plot_energy_drift(
            conv(np.arange(10.0)), conv(1.0 + 1e-4 * rng.normal(size=10)),
            save_path=path),
    }
    for name, conv in (("numpy", np.asarray), ("torch", torch.as_tensor)):
        out = tmp_path / f"{helper}_{name}.png"
        fig = cases[helper](conv, str(out))
        assert out.exists() and out.stat().st_size > 0
        fig.clf()


def test_numerical_grad_and_force_match_jax():
    """float64 on both sides (the JAX test's precision): the central
    differences of the harmonic and 3-body potentials at the same numpy
    positions agree with the JAX oracle's to 1e-9 and with the closed
    forms as the JAX test holds them."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        k = np.asarray([2.0, 3.0, 0.5])
        q = np.asarray([3.0, -4.0, 1.5])
        tfn = tpot.make_harmonic(torch.tensor(k), device="cpu")
        jfn = jpot.make_harmonic(jnp.asarray(k))
        got = tpot.numerical_grad(tfn, 1e-6)(torch.tensor(q))
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jpot.numerical_grad(jfn, 1e-6)(
                jnp.asarray(q))), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(got.numpy(), k * q, rtol=1e-6)

        mass = np.asarray([1.0, 2.0, 3.0])
        qn = np.random.default_rng(1).normal(size=9)
        tn = tpot.make_nbody_potential(torch.tensor(mass), 3, 3,
                                       device="cpu")
        jn = jpot.make_nbody_potential(jnp.asarray(mass), 3, 3)
        force = tpot.numerical_force(tn, 1e-6)(torch.tensor(qn))
        np.testing.assert_allclose(
            force.numpy(), np.asarray(jpot.numerical_force(jn, 1e-6)(
                jnp.asarray(qn))), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(
            force.numpy(), -tn.analytic_grad(torch.tensor(qn)).numpy(),
            rtol=1e-5, atol=1e-8)
    finally:
        jax.config.update("jax_enable_x64", old)


def test_numerical_grad_makes_one_batched_call():
    calls = []

    def fn(q):
        calls.append(tuple(q.shape))
        return 0.5 * torch.sum(q * q, dim=-1)

    g = tpot.numerical_grad(fn)(torch.tensor([1.0, -2.0, 0.5, 3.0]))
    assert len(calls) == 1
    torch.testing.assert_close(g, torch.tensor([1.0, -2.0, 0.5, 3.0]),
                               rtol=1e-3, atol=1e-3)


def test_native_available_matches_jax():
    """Both packages build the same ``csrc/pbbi_io.cpp``."""
    assert tnative.native_available() == jnative.native_available()
    assert isinstance(tnative.native_available(), bool)


def test_graft_entry_runs_the_flagship_transition():
    """The JAX entry's configuration (256 walkers, 32 dims, 8 steps, step
    0.5), on the CPU: one transition of the port's and of the JAX
    package's, each from its own N(0, 1) draw; both accept rates in
    [0, 1] and within 0.1 of each other (256 walkers' means)."""
    import __graft_entry__ as jentry
    fn, args = graft_entry.entry("cpu")
    key, state, step = args
    assert state.ensemble.q.shape == (256, 32) and float(step) == 0.5
    q, acc = fn(*args)
    jfn, jargs = jentry.entry()
    jq, jacc = jfn(*jargs)
    assert q.shape == tuple(jq.shape) and q.dtype == torch.float32
    assert bool(torch.isfinite(q).all())
    assert 0.0 <= float(acc.min()) and float(acc.max()) <= 1.0
    assert abs(float(acc.mean()) - float(jnp.mean(jacc))) < 0.1


def test_dryrun_multichip_over_two_cpu_processes():
    """Two gloo processes: each rank's checks of the composed and the
    fused transition pass (a failing rank raises here)."""
    graft_entry.dryrun_multichip(2)
