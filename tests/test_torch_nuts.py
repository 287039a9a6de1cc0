"""The port's lockstep NUTS against the JAX package's: the U-turn criterion
and the trailing-zero count exactly, the tree's behaviour (truncation,
depth against step size, divergence), the mean depth against the JAX
kernel's at the same step size and metric, posterior moments against
closed forms and against ensemble HMC, and the sparse reads of the
subtree's condition against a read at every leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import nuts as jnuts
from physicsbasedbayesianinference_tpu.ops import potentials as jp
import physicsbasedbayesianinference_tpu_torch as pt
from physicsbasedbayesianinference_tpu_torch import nuts
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp


def _normal(seed, shape, scale=1.0):
    return torch.as_tensor(
        (scale * np.random.default_rng(seed).normal(size=shape)).astype(
            np.float32))


def test_uturn_and_ctz_match_jax_exactly():
    rng = np.random.default_rng(0)
    ql, pl, qr, pr = (rng.normal(size=(256, 5)).astype(np.float32)
                      for _ in range(4))
    im = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    want = np.asarray(jax.vmap(jnuts._uturn, (0, 0, 0, 0, None))(
        *map(jnp.asarray, (ql, pl, qr, pr)), jnp.asarray(im)))
    got = nuts._uturn(*map(torch.as_tensor, (ql, pl, qr, pr, im))).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1
    i = np.arange(1, 5000, dtype=np.int32)
    np.testing.assert_array_equal(
        [nuts._ctz(int(k)) for k in i], np.asarray(jnuts._ctz(jnp.asarray(i))))


def _step(target, step_size, *, w=128, d=2, max_depth=8, seed=0, **kw):
    k = nuts._build_lockstep_nuts_kernel(
        target, max_depth=max_depth, temperature=1.0,
        constants=pt.NATURAL, divergence_threshold=1000.0, **kw)
    st = k.init(_normal(seed, (w, d)))
    return k.step((seed, 1), st, torch.tensor(step_size))


def test_uturn_truncates_trajectory():
    """A standard normal turns after about pi / step leapfrogs; the depth
    shows that, not max_depth."""
    _, info = _step(tp.make_standard_normal(2), 0.3, max_depth=10)
    assert 4 < float(info.num_leapfrogs.float().mean()) < 40
    assert float(info.turned.float().mean()) > 0.9
    assert int(info.depth.max()) < 10


def test_depth_grows_with_smaller_steps():
    _, big = _step(tp.make_standard_normal(2), 0.5)
    _, small = _step(tp.make_standard_normal(2), 0.05)
    assert float(small.depth.float().mean()) > \
        float(big.depth.float().mean()) + 1.0


def test_divergence_flagged_for_huge_step():
    _, info = _step(tp.make_banana(device="cpu"), 5.0, seed=3)
    assert float(info.divergent.float().mean()) > 0.3


def test_accept_prob_in_range():
    _, info = _step(tp.make_standard_normal(4), 0.25, d=4)
    acc = info.accept_prob
    assert bool(torch.all((acc >= 0) & (acc <= 1)))
    assert float(acc.mean()) > 0.8


@pytest.mark.parametrize("step_size", [0.25, 0.8])
def test_mean_depth_matches_jax(step_size):
    """One transition of 2048 walkers from the same positions at the same
    step size and metric (a [D] mass): the mean depth and leapfrog count
    within 0.1 and 6% of the JAX kernel's (the two draw other momenta; the
    standard errors of the means are about 0.02 and 1.5%)."""
    d = 3
    q = _normal(4, (2048, d))
    mass = np.float32([1.0, 2.0, 0.5])
    jk = jnuts.build_nuts_kernel(jp.make_standard_normal(d), max_depth=8)
    jst = jk.init(jnp.asarray(q.numpy()), mass=jnp.asarray(mass))
    _, jinfo = jax.jit(jk.step)(jax.random.key(5), jst,
                                jnp.float32(step_size))
    k = nuts.build_nuts_kernel(tp.make_standard_normal(d), max_depth=8)
    _, info = k.step((5, 0), k.init(q, mass=torch.as_tensor(mass)),
                     step_size)
    assert float(info.depth.float().mean()) == pytest.approx(
        float(jnp.mean(jinfo.depth)), abs=0.1)
    assert float(info.num_leapfrogs.float().mean()) == pytest.approx(
        float(jnp.mean(jinfo.num_leapfrogs)), rel=0.06)
    assert float(info.accept_prob.mean()) == pytest.approx(
        float(jnp.mean(jinfo.accept_prob)), abs=0.02)


def test_sparse_reads_give_the_outputs_of_a_read_at_every_leaf():
    """The subtree's condition read after leaves 1, 2, 4, ... only: the
    extra leaves after every walker stopped change no output, so both
    schedules give the same bits from the same draws, with fewer reads."""
    target = tp.make_gaussian(np.float32([0.5, -1.0, 2.0]),
                              cov=np.diag(np.float32([1.0, 4.0, 0.25])),
                              device="cpu")
    outs, reads = [], []
    for every in (True, False):
        before = nuts._host_read.reads
        st, info = _step(target, 0.2, w=256, d=3, seed=6,
                         read_every_leaf=every)
        reads.append(nuts._host_read.reads - before)
        outs.append((st.ensemble.q, st.potential_energy, st.grad,
                     info.accept_prob, info.depth, info.num_leapfrogs,
                     info.divergent, info.turned))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert reads[1] < reads[0]


def test_reads_per_transition_are_the_loop_conditions():
    """A transition that reaches depth k reads the outer condition k times
    (or k + 1 if it stops before max_depth) and the subtree's at leaf
    counts that are powers of two: no read at leaf 0 of a subtree."""
    before = nuts._host_read.reads
    _, info = _step(tp.make_standard_normal(2), 0.3, w=64, max_depth=2)
    # depth 0: 1 leaf, no read; depth 1: 2 leaves, a read before leaf 1;
    # the outer condition at depths 0 and 1 (max_depth stops the third)
    assert int(info.depth.max()) == 2
    assert nuts._host_read.reads - before == 3


def test_nuts_gaussian_posterior():
    """A correlated 3-dim Gaussian: mean within 0.05 and covariance within
    0.15 (the JAX test's limits)."""
    mean = np.float32([1.0, -2.0, 0.5])
    cov = np.float32([[1.0, 0.6, 0.2], [0.6, 2.0, 0.3], [0.2, 0.3, 0.5]])
    res = pt.run_nuts(0, tp.make_gaussian(mean, cov=cov, device="cpu"),
                      _normal(1, (512, 3)), num_warmup=200, num_samples=300,
                      max_depth=8)
    flat = res.samples.reshape(-1, 3).double()
    np.testing.assert_allclose(flat.mean(0).numpy(), mean, atol=0.05)
    np.testing.assert_allclose(torch.cov(flat.T).numpy(), cov, atol=0.15)
    assert float(res.accept_rate) > 0.7
    assert float(res.divergence_rate) < 0.01
    assert 1.0 < float(res.mean_depth) < 8.0


def test_nuts_matches_hmc_on_gaussian():
    target = tp.make_standard_normal(4)
    q0 = _normal(4, (512, 4))
    r_nuts = pt.run_nuts(5, target, q0, num_warmup=150, num_samples=200)
    r_hmc = pt.run_hmc(6, target, q0, num_warmup=150, num_samples=200,
                       num_steps=16)
    m1 = r_nuts.samples.reshape(-1, 4).mean(0)
    m2 = r_hmc.samples.reshape(-1, 4).mean(0)
    np.testing.assert_allclose(m1.numpy(), m2.numpy(), atol=0.15)
    np.testing.assert_allclose(m1.numpy(), 0.0, atol=0.1)
    np.testing.assert_allclose(r_nuts.samples.reshape(-1, 4).var(0).numpy(),
                               1.0, atol=0.1)


def test_engines_and_arguments():
    target = tp.make_standard_normal(2)
    with pytest.raises(ValueError, match="lockstep"):
        nuts.build_nuts_kernel(target, engine="vmap")
    with pytest.raises(ValueError, match="lockstep"):
        nuts.build_nuts_kernel(target, engine="xla")
    with pytest.raises(ValueError, match="collect"):
        pt.run_nuts(0, target, _normal(0, (8, 2)), num_warmup=1,
                    num_samples=1, collect="moments")
    res = pt.run_nuts(0, target, _normal(0, (8, 2)), num_warmup=0,
                      num_samples=0, collect="none")
    assert res.samples is None and bool(torch.isnan(res.accept_rate))
    with pytest.raises(ValueError, match="num_walkers, num_dims"):
        nuts.build_nuts_kernel(target).init(torch.zeros(3))
