"""Kernels A and B over a rung axis (q ``[R, W, D]``, a key, scalars and
momentum std a rung) and parallel tempering's sweep as one call for every
rung, on the CPU: the plain versions on rungs are the rung-alone calls
stacked, bit for bit; ``build_pt_transition(kernel="fused")`` (the fused
engine's plain versions, ``resolve_engine`` patched as the CPU has no
card) is a per-rung loop of ``FusedTransition(beta=...)`` bit for bit;
the wrappers refuse rung arguments of the wrong shape; and the fused
``run_parallel_tempering`` agrees with the JAX package's within
Monte-Carlo error."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import tempering as jtemp
from physicsbasedbayesianinference_tpu.ops import potentials as jp
import physicsbasedbayesianinference_tpu_torch as pt
from physicsbasedbayesianinference_tpu_torch import tempering
from physicsbasedbayesianinference_tpu_torch.ensemble import EnsembleState
from physicsbasedbayesianinference_tpu_torch.hmc import (
    FusedTransition, HMCState, _splitmix64, _step_generator)
from physicsbasedbayesianinference_tpu_torch.ops import kernels
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp

R, W = 3, 100   # W not a multiple of any block
SEEDS = [11, 2**63 + 5, 7]


def _rng_t(rng, *shape, scale=1.0, lo=None, hi=None):
    x = (rng.uniform(lo, hi, shape) if lo is not None
         else scale * rng.standard_normal(shape))
    return torch.as_tensor(np.asarray(x, np.float32))


def _b_forms(d):
    """Kernel B's mixture, non-centred eight-schools (J = d - 2) and coin
    forms at dimension ``d``."""
    rng = np.random.default_rng(d)
    j = d - 2
    return {
        "mixture": ("mixture", (torch.tensor([[-2.0] + [0.0] * (d - 1),
                                              [2.0] + [0.5] * (d - 1)]),
                                torch.tensor([-0.7, -0.7]),
                                torch.tensor([1.3]))),
        "eight_schools_nc": ("eight_schools_nc", (
            _rng_t(rng, j, scale=10.0), _rng_t(rng, j, lo=8.0, hi=18.0),
            torch.tensor([3.1]))),
        "coin": ("coin", (_rng_t(rng, d, lo=1.0, hi=9.0),
                          _rng_t(rng, d, lo=1.0, hi=9.0))),
    }


def _rung_args(d, seed=0):
    rng = np.random.default_rng(seed)
    betas = _rng_t(rng, R, lo=0.1, hi=1.0)
    im = _rng_t(rng, d, lo=0.5, hi=2.0)
    step = _rng_t(rng, R, lo=0.05, hi=0.3)
    return dict(
        q=_rng_t(rng, R, W, d, scale=1.5),
        scalars=torch.stack((step, betas, _rng_t(rng, R, lo=0.5, hi=1.0)),
                            dim=1),
        p_std=torch.sqrt(1.0 / (im * betas[:, None])), inv_mass=im)


def _same_bits(a, b):
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32
                           else x, y.view(torch.int32)
                           if y.dtype == torch.float32 else y)
               for x, y in zip(a, b, strict=True))


@pytest.mark.parametrize("counted", [False, True])
def test_kernel_a_rungs_are_the_rung_calls_stacked(counted):
    """Kernel A's plain version and its wrapper on q [R, W, D]: every
    output the stack of the R rung-alone calls, bit for bit."""
    d = 5
    a = _rung_args(d, 1)
    q, scalars, p_std = a.pop("q"), a.pop("scalars"), a.pop("p_std")
    rng = np.random.default_rng(3)
    kw = dict(a, k_diag=_rng_t(rng, d, lo=0.5, hi=2.0),
              mean=_rng_t(rng, d), walker_offset=40,
              num_steps=torch.tensor([6], dtype=torch.int32) if counted
              else 6, max_steps=9 if counted else None)
    want = kernels._stack_rungs(
        kernels.fused_hmc_diag_quadratic_plain(
            SEEDS[r], 4, q[r], scalars=scalars[r], p_std=p_std[r], **kw)
        for r in range(R))
    for fn in (kernels.fused_hmc_diag_quadratic_plain,
               kernels.fused_hmc_diag_quadratic):
        got = fn(SEEDS, 4, q, scalars=scalars, p_std=p_std, **kw)
        assert [tuple(x.shape) for x in got] == [
            (R, W, d), (R, W, d), (R, W), (R, W), (R, W), (R, W)]
        assert _same_bits(got, want)


@pytest.mark.parametrize("name", ["mixture", "eight_schools_nc", "coin"])
@pytest.mark.parametrize("proposal", [False, True])
def test_kernel_b_rungs_are_the_rung_calls_stacked(name, proposal):
    """Kernel B's plain version and its wrapper on q [R, W, D] for three
    forms, with and without the proposal outputs: every output the stack
    of the R rung-alone calls, bit for bit; the rungs differ."""
    d = 6
    form = _b_forms(d)[name]
    a = _rung_args(d, 2)
    q, scalars, p_std = a.pop("q"), a.pop("scalars"), a.pop("p_std")
    vg = kernels.device_value_and_grad(form)
    u, g = (torch.stack(x) for x in zip(*(vg(q[r]) for r in range(R))))
    kw = dict(a, num_steps=5, emit_proposal=proposal)
    want = kernels._stack_rungs(
        kernels.fused_hmc_transition_plain(
            form, SEEDS[r], 9, q[r], u[r], g[r], scalars=scalars[r],
            p_std=p_std[r], **kw) for r in range(R))
    for fn in (kernels.fused_hmc_transition_plain,
               kernels.fused_hmc_transition):
        got = fn(form, SEEDS, 9, q, u, g, scalars=scalars, p_std=p_std,
                 **kw)
        assert len(got) == (8 if proposal else 6)
        assert _same_bits(got, want)
    assert not torch.equal(want[0][0], want[0][1])


def test_rung_wrappers_refuse_wrong_shapes():
    """A call on rungs takes a list of one key a rung, scalars [R, 3],
    p_std [R, D] and, in kernel B, u [R, W] and g [R, W, D]; kernel A's
    and B's wrappers refuse anything else before they run."""
    d = 4
    a = _rung_args(d)
    q, scalars, p_std = a.pop("q"), a.pop("scalars"), a.pop("p_std")
    form = _b_forms(d)["mixture"]
    u, g = torch.zeros(R, W), torch.zeros(R, W, d)
    kw = dict(a, num_steps=3)

    def call_a(seeds, **over):
        args = dict(scalars=scalars, p_std=p_std, k_diag=torch.ones(d),
                    mean=torch.zeros(d), **kw)
        args.update(over)
        return kernels.fused_hmc_diag_quadratic(seeds, 0, q, **args)

    def call_b(seeds, **over):
        args = dict(u=u, g=g, scalars=scalars, p_std=p_std, **kw)
        args.update(over)
        return kernels.fused_hmc_transition(form, seeds, 0, q, **args)

    for call in (call_a, call_b):
        with pytest.raises(ValueError, match="3 Philox keys.*got 2"):
            call(SEEDS[:2])
        with pytest.raises(ValueError, match="got one key"):
            call(5)
        with pytest.raises(ValueError, match=r"scalars .*want \(3, 3\)"):
            call(SEEDS, scalars=scalars[0])
        with pytest.raises(ValueError, match=r"scalars .*want \(3, 3\)"):
            call(SEEDS, scalars=scalars[:, :2].contiguous())
        with pytest.raises(ValueError, match=r"p_std .*want \(3, 4\)"):
            call(SEEDS, p_std=p_std[0])
    with pytest.raises(ValueError, match=r"u .*want \(3, 100\)"):
        call_b(SEEDS, u=u[0])
    with pytest.raises(ValueError, match=r"g .*want \(3, 100, 4\)"):
        call_b(SEEDS, g=g[:, :, :2])


def _targets():
    return {"mixture (kernel B)": tp.make_gaussian_mixture(
                torch.tensor([[-2.0, 0.0], [2.0, 0.0]]), device="cpu"),
            "std normal (kernel A)": tp.make_standard_normal(2)}


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """The fused engine on CPU tensors: its kernels' plain versions."""
    monkeypatch.setattr(tempering, "resolve_engine",
                        lambda *a, **kw: "fused")


@pytest.mark.parametrize("target", sorted(_targets()))
@pytest.mark.parametrize("parity", [0, 1])
def test_pt_transition_is_a_per_rung_loop(fused_on_cpu, target, parity):
    """``build_pt_transition(kernel="fused")`` over 3 transitions (from
    counter ``parity``) against the transition written out as a loop of
    ``FusedTransition(beta=beta_r)`` over the rungs, keyed
    ``_replica_seed(seed, r)``, then the swap of the same uniforms: q, u,
    g, the acceptance means and the swap rates the same bits."""
    fn = _targets()[target]
    r, w, seed = 4, 64, 21
    mass = torch.tensor([1.0, 1.7])
    betas = tempering.geometric_ladder(r, 0.1, device="cpu")
    transition, used, vg = tempering.build_pt_transition(
        fn, betas=betas, num_dims=2, num_steps=5, mass=mass, kernel="fused",
        device="cpu")
    assert used == "fused"
    q = torch.as_tensor(np.random.default_rng(8).normal(
        size=(r, w, 2)).astype(np.float32)) * 2.0
    u, g = vg(q.reshape(-1, 2))
    u, g = u.reshape(r, w), g.reshape(r, w, 2)
    step_sizes = torch.tensor([0.3, 0.45, 0.6, 0.9])
    fused = FusedTransition(fn)
    mine = (q, u, g)
    ref = (q, u, g)
    for i in range(parity, parity + 3):
        key = (seed, 50 + i)
        *mine, acc, swaps = transition(key, *mine, step_sizes, i)
        rows = []
        for k in range(r):
            qk, uk, gk = (x[k] for x in ref)
            state = HMCState(ensemble=EnsembleState(q=qk, p=qk, mass=mass,
                                                    log_weight=uk),
                             potential_energy=uk, grad=gk)
            new, info, _ = fused((tempering._replica_seed(seed, k), key[1]),
                                 state, step_sizes[k], num_steps=5,
                                 beta=betas[k], walker_offset=0)
            rows.append((new.ensemble.q, new.potential_energy, new.grad,
                         torch.mean(info.accept_prob)))
        *ref, ref_acc = (torch.stack(x) for x in zip(*rows))
        uniform = torch.rand((r, w), generator=_step_generator(
            (_splitmix64(seed), key[1]), q.device))
        partner = torch.as_tensor(tempering._partner_tables(r)[i % 2])
        *ref, ref_swaps = tempering.swap_phase(*ref, betas, partner,
                                               uniform)
        assert _same_bits((*mine, acc, swaps), (*ref, ref_acc, ref_swaps))
    assert float(swaps.max()) > 0.0


def test_fused_pt_on_cpu_matches_jax(fused_on_cpu):
    """``run_parallel_tempering(kernel="fused")`` (the rung launches' plain
    versions) on the JAX test's two-mode mixture at (+-3, 0) against the
    JAX package's run (its fused route, which runs as XLA off the TPU)
    from the same numpy start: cold means within 0.5 and variances within
    1.0 (the JAX test's gates), both runs in both modes, the right-mode
    shares within 0.15 of each other."""
    r, w = 4, 256
    init = np.broadcast_to(3.0 * np.random.default_rng(5).standard_normal(
        (w, 2)).astype(np.float32), (r, w, 2)).copy()
    kw = dict(num_replicas=r, num_warmup=100, num_samples=100, num_steps=8,
              collect="samples")
    res = pt.run_parallel_tempering(
        1, tp.make_gaussian_mixture(torch.tensor([[-3.0, 0.0], [3.0, 0.0]]),
                                    device="cpu"),
        torch.as_tensor(init), kernel="fused", **kw)
    assert res.kernel_used == "fused"
    jres = jtemp.run_parallel_tempering(
        jax.random.key(1), jp.make_gaussian_mixture(
            jnp.asarray([[-3.0, 0.0], [3.0, 0.0]])), jnp.asarray(init),
        kernel="fused", **kw)
    mine, theirs = res.samples.reshape(-1, 2).numpy(), np.asarray(
        jres.samples).reshape(-1, 2)
    np.testing.assert_allclose(mine.mean(0), theirs.mean(0), atol=0.5)
    np.testing.assert_allclose(mine.var(0), theirs.var(0), atol=1.0)
    assert mine.var(0)[0] > 4.0 and theirs.var(0)[0] > 4.0
    right, right_jax = (float((x[:, 0] > 0).mean()) for x in (mine, theirs))
    assert 0.2 < right < 0.8 and abs(right - right_jax) < 0.15
    assert float(res.accept_rate.min()) > 0.5
