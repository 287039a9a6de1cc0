"""The port's ``smc`` against the JAX package's: the deterministic parts on
the same numpy-made inputs, the samplers within Monte-Carlo error and
against closed forms, and the fused mutation against the composed tempered
step on the same draws.

Tolerances: the weight functions at float32 rounding (rtol 1e-6 on O(1)
results); the inverse CDF exactly, both cumulative sums taken in float64;
the next beta within 1e-6 (the bisection's last bracket is 2^-30 of the
interval, below float32's resolution: what is left is where the two
packages' float32 ESS round differently near the target); one stage's
weights and log-Z increment at float32 rounding (rtol 1e-5, atol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import smc as jsmc
from physicsbasedbayesianinference_tpu.ops import potentials as jp
import physicsbasedbayesianinference_tpu_torch as pt
from physicsbasedbayesianinference_tpu_torch import smc
from physicsbasedbayesianinference_tpu_torch.hmc import FusedTransition
from physicsbasedbayesianinference_tpu_torch.ops import philox
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp
from physicsbasedbayesianinference_tpu_torch.utils import convert
from _torch_cpu import cpu_requested  # noqa: F401  (the CPU, asked for)


def _log_w(seed, n=512, scale=2.0):
    return (scale * np.random.default_rng(seed).normal(size=n)).astype(
        np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weights_and_ess_match_jax(seed):
    lw = _log_w(seed)
    np.testing.assert_allclose(
        smc.normalize_log_weights(torch.as_tensor(lw)).numpy(),
        np.asarray(jsmc.normalize_log_weights(jnp.asarray(lw))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(smc.effective_sample_size(torch.as_tensor(lw))),
        float(jsmc.effective_sample_size(jnp.asarray(lw))), rtol=1e-5)


def test_ess_limits():
    assert float(smc.effective_sample_size(torch.zeros(100))) == \
        pytest.approx(100.0, rel=1e-5)
    one_hot = torch.full((100,), -1e9)
    one_hot[3] = 0.0
    assert float(smc.effective_sample_size(one_hot)) == \
        pytest.approx(1.0, rel=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_inverse_cdf_indices_match_jax_exactly(seed):
    rng = np.random.default_rng(seed)
    w = np.exp(_log_w(seed, 1000).astype(np.float64))
    cum = np.cumsum(w / w.sum())
    # sorted positions, among them the cumulative sums themselves and
    # points past the end of a cumulative sum that stops under 1
    pos = np.sort(np.concatenate([rng.uniform(size=3000), cum[::7],
                                  [0.0, cum[-1], np.nextafter(1.0, 0.0)]]))
    with jax.enable_x64(True):
        want = np.asarray(jsmc._inverse_cdf_indices(jnp.asarray(cum),
                                                    jnp.asarray(pos)))
    got = smc._inverse_cdf_indices(torch.as_tensor(cum),
                                   torch.as_tensor(pos)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() == 999 and got.min() == 0


def test_the_clip_catches_a_cumulative_sum_that_ends_under_one():
    """The JAX resamplers' float32 cumulative sum of normalised weights need
    not reach 1: positions past its end search to W and are clipped to the
    last walker. The port's fixed-point CDF (exact integer sums, the same
    in any order) ends within W units of 2^52, and the clip is the same."""
    lw = _log_w(3, 3000)
    cum = jnp.cumsum(jnp.exp(jsmc.normalize_log_weights(jnp.asarray(lw))))
    assert float(cum[-1]) < 1.0
    pos = jnp.asarray([float(cum[-1]), 0.99999994], jnp.float32)
    assert np.asarray(jnp.searchsorted(cum, pos, side="right")).tolist() == \
        [3000, 3000]
    assert np.asarray(jsmc._inverse_cdf_indices(cum, pos)).tolist() == \
        [2999, 2999]
    fixed = smc._fixed_point_cdf(torch.as_tensor(lw))
    assert fixed.dtype == torch.int64
    assert abs(int(fixed[-1]) - 2**52) <= 3000
    assert smc._inverse_cdf_indices(
        fixed, torch.tensor([2**52 - 1, 2**53])).tolist() == [2999, 2999]


@pytest.mark.parametrize("method", ["systematic", "stratified",
                                    "multinomial"])
def test_fixed_point_resampling_is_the_float64_inverse_cdf(method):
    """The resamplers' indices are those of the float64 CDF at the same
    positions (they could differ only within 2^-52 of a boundary)."""
    lw = torch.as_tensor(_log_w(4, 5000, 3.0))
    idx = smc.RESAMPLERS[method](torch.Generator().manual_seed(3), lw, 5000)
    gen = torch.Generator().manual_seed(3)
    u = torch.rand((5000,) if method != "systematic" else (), generator=gen)
    pos = u if method == "multinomial" else (u + torch.arange(5000.0)) / 5000
    cum = torch.cumsum(torch.exp(smc.normalize_log_weights(lw.double())), 0)
    want = smc._inverse_cdf_indices(cum, pos.double())
    assert torch.equal(idx, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("target_frac", [0.3, 0.5, 0.9])
def test_next_beta_by_ess_matches_jax(seed, target_frac):
    rng = np.random.default_rng(seed)
    u = (10.0 * rng.normal(size=512) ** 2).astype(np.float32)
    lw = (0.3 * rng.normal(size=512)).astype(np.float32)
    beta = np.float32(0.05)
    want = float(jsmc.next_beta_by_ess(jnp.asarray(u), jnp.asarray(lw),
                                       jnp.asarray(beta),
                                       target_frac=target_frac))
    got = float(smc.next_beta_by_ess(torch.as_tensor(u), torch.as_tensor(lw),
                                     torch.tensor(beta),
                                     target_frac=target_frac))
    assert got == pytest.approx(want, abs=1e-6)
    assert 0.05 < got <= 1.0


def test_next_beta_monotone_and_jumps_to_max():
    u = torch.randn(512, generator=torch.Generator().manual_seed(2)) ** 2 * 10
    b1 = smc.next_beta_by_ess(u, torch.zeros(512), 0.0, target_frac=0.9)
    b2 = smc.next_beta_by_ess(u, torch.zeros(512), 0.0, target_frac=0.3)
    assert 0.0 < float(b1) <= float(b2) <= 1.0
    easy = smc.next_beta_by_ess(torch.full((64,), 1e-3), torch.zeros(64), 0.0)
    assert float(easy) == 1.0


@pytest.mark.parametrize("method", ["systematic", "stratified",
                                    "multinomial"])
def test_resampling_proportional(method):
    """Counts in proportion to the weights: within 1 of exact for the
    systematic resampler, statistically (3 points) for the others."""
    w = torch.tensor([0.5, 0.3, 0.15, 0.05])
    num = 4000
    idx = smc.RESAMPLERS[method](torch.Generator().manual_seed(0),
                                 torch.log(w), num)
    counts = torch.bincount(idx, minlength=4).double() / num
    tol = 1.0 / num if method == "systematic" else 0.03
    np.testing.assert_allclose(counts.numpy(), w.numpy(), atol=tol + 1e-9)


def test_resample_tree():
    tree = {"q": torch.arange(8.0)[:, None], "e": (torch.arange(8.0),)}
    log_w = torch.full((8,), -1e9)
    log_w[5] = 0.0
    out, lw = smc.resample(torch.Generator().manual_seed(1), tree, log_w)
    assert torch.all(out["q"] == 5.0) and torch.all(out["e"][0] == 5.0)
    assert torch.all(lw == 0.0)
    with pytest.raises(ValueError, match="resampler"):
        smc.build_smc_machinery(tp.make_standard_normal(2), 8,
                                torch.float32, num_dims=2,
                                resampler="residual", device="cpu")


def test_one_stage_weights_and_log_z_match_jax():
    """One stage of both machineries with no mutation and no resample:
    the next beta, the weights, the log-Z increment and the ESS."""
    rng = np.random.default_rng(3)
    q = (rng.normal(size=(2048, 3)) * 3.0).astype(np.float32)
    kw = dict(num_dims=3, num_mutation_steps=0, beta0=0.1,
              resample_threshold_frac=0.0, max_stages=5)
    jm = jsmc.build_smc_machinery(jp.make_standard_normal(3), 2048,
                                  jnp.float32, **kw)
    tm = smc.build_smc_machinery(tp.make_standard_normal(3), 2048,
                                 torch.float32, device="cpu", **kw)
    jc = jm["init_carry"](jax.random.key(0), jnp.asarray(q))
    tc = tm["init_carry"](0, torch.as_tensor(q))
    for _ in range(2):
        jc, tc = jm["body"](jc), tm["body"](tc)
        (jq, ju, jbeta, jlw, jlz, jstage, _, _, jbetas, jess, _) = jc
        np.testing.assert_allclose(float(tc.beta), float(jbeta), atol=1e-6)
        tol = dict(rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tc.log_w.numpy(), np.asarray(jlw), **tol)
        np.testing.assert_allclose(float(tc.log_z), float(jlz), **tol)
        np.testing.assert_allclose(tc.ess_history.numpy(), np.asarray(jess),
                                   rtol=1e-4)
        np.testing.assert_array_equal(tc.q.numpy(), np.asarray(jq))
        assert tc.stage == int(jstage)


def _init(seed, w, d, scale):
    return (scale * np.random.default_rng(seed).normal(size=(w, d))).astype(
        np.float32)


def test_smc_gaussian_evidence_and_moments_against_jax():
    """Anneal N(0, I/beta0) -> N(0, I) in 4 dims. Oracle: log Z = (d/2)
    log(beta0) (the JAX test's 0.25); variance 1 and mean 0 within 0.1;
    the JAX run from the same numpy positions within 0.2 in log Z."""
    d, beta0 = 4, 0.1
    init = _init(0, 4096, d, 1 / np.sqrt(beta0))
    kw = dict(num_mutation_steps=3, num_leapfrog_steps=10,
              init_step_size=0.8, beta0=beta0, max_stages=40)
    reads = smc._host_read.reads
    res = pt.run_smc(1, tp.make_standard_normal(d), torch.as_tensor(init),
                     **kw)
    assert smc._host_read.reads - reads == res.num_stages + 1
    assert res.kernel_used == "composed" and res.num_stages >= 2
    want = 0.5 * d * np.log(beta0)
    assert float(res.log_evidence) == pytest.approx(want, abs=0.25)
    assert float(torch.var(res.q)) == pytest.approx(1.0, abs=0.1)
    assert abs(float(torch.mean(res.q))) < 0.1
    jres = jsmc.run_smc(jax.random.key(1), jp.make_standard_normal(d),
                        jnp.asarray(init), kernel="xla", **kw)
    assert float(res.log_evidence) == pytest.approx(
        float(jres.log_evidence), abs=0.2)
    assert float(torch.var(res.q)) == pytest.approx(
        float(jnp.var(jres.q)), abs=0.1)


def test_smc_multimodal_mixture():
    """Tempering populates both modes of a symmetric 1-D bimodal target
    (autograd through a potential with no closed-form gradient)."""
    sep = 4.0

    def potential(q):
        x = q[..., 0]
        return -torch.logaddexp(-0.5 * (x - sep) ** 2, -0.5 * (x + sep) ** 2)

    res = pt.run_smc(4, potential, torch.as_tensor(_init(3, 4096, 1, 6.0)),
                     num_mutation_steps=5, num_leapfrog_steps=10,
                     init_step_size=1.0, beta0=0.05, max_stages=40)
    right = res.q[res.q[:, 0] > 0, 0]
    assert 0.3 < right.numel() / 4096 < 0.7
    assert float(right.mean()) == pytest.approx(sep, abs=0.3)


def test_smc_acceptance_reasonable():
    res = pt.run_smc(6, tp.make_standard_normal(2),
                     torch.as_tensor(_init(5, 1024, 2, 3.0)), beta0=0.1,
                     max_stages=30)
    assert float(res.accept_history[:res.num_stages].mean()) > 0.5
    assert torch.all(res.betas[res.num_stages:] == 1.0)


def test_smc_mutation_dual_averaging_tracks_target():
    """Late (cold) stages keep the mutation acceptance near the dual
    averaging's target on a curved target, from a step far too large."""
    res = pt.run_smc(11, tp.make_funnel(6),
                     torch.as_tensor(_init(10, 1024, 6, 3.0)), beta0=0.05,
                     max_stages=40, num_mutation_steps=5, init_step_size=2.0,
                     mutation_target_accept=0.75)
    acc = res.accept_history[:res.num_stages].numpy()
    assert 0.5 < acc[-3:].mean() < 0.98, acc
    assert float(res.final_step_size) < 2.0


def test_smc_engine_choice():
    """"fused" on CPU tensors raises (no silent fallback), "xla" is not a
    name of the port's engines, "composed" runs."""
    q = torch.as_tensor(_init(0, 256, 2, 2.0))
    kw = dict(beta0=0.1, max_stages=3)
    target = tp.make_standard_normal(2)
    with pytest.raises(ValueError, match="cannot run"):
        pt.run_smc(1, target, q, kernel="fused", **kw)
    with pytest.raises(ValueError, match="auto|fused|composed"):
        pt.run_smc(1, target, q, kernel="xla", **kw)
    assert pt.run_smc(1, target, q, kernel="composed",
                      **kw).kernel_used == "composed"


def _forms():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(5, 5))
    return {
        "diag": (tp.make_standard_normal(5), 1.5 * rng.normal(size=(64, 5))),
        "gaussian": (convert.potential_params_from_numpy("gaussian", {
            "mean": rng.normal(size=5).astype(np.float32),
            "cov": (a @ a.T / 5 + 0.5 * np.eye(5)).astype(np.float32)}),
            rng.normal(size=(64, 5))),
        "nbody": (convert.potential_params_from_numpy("nbody", {
            "mass": np.ones(4, np.float32), "num_bodies": 4,
            "softening": 0.3}), 2.0 * rng.normal(size=(64, 12))),
    }


@pytest.mark.parametrize("name", ["diag", "gaussian", "nbody"])
@pytest.mark.parametrize("scale", [0.37, 1.0])
def test_fused_mutation_equals_the_composed_tempered_step(name, scale):
    """An SMC mutation through ``FusedTransition`` (potential scale = the
    stage beta; on the CPU the plain kernels A and B) against the composed
    tempered step fed the same Philox momenta and uniforms: the same
    energy errors, decisions and states (float32, sums in another order:
    rtol=atol=1e-5)."""
    fn, q = _forms()[name]
    q = torch.as_tensor(q, dtype=torch.float32)
    w, d = q.shape
    fused = FusedTransition(fn)
    u, g = tp.batched_value_and_grad(fn)(q)
    state = pt.hmc.init_state(lambda x: (u, g), q, 1.0)
    new, info, _ = fused((9, 4), state, 0.1, num_steps=6,
                         potential_scale=torch.tensor(scale))
    momentum = philox.momentum_normals(9, 4, w, d, q.device)
    uniform = philox.accept_uniforms(9, 4, w, q.device)
    q_c, acc_c = smc.tempered_hmc_step(
        fn, (0, 0), q, torch.tensor(scale), 0.1, num_steps=6,
        momentum=momentum, uniform=uniform)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(info.accept_prob.mean()), float(acc_c),
                               **tol)
    np.testing.assert_allclose(new.ensemble.q.numpy(), q_c.numpy(), **tol)
    # (u, g) out are unscaled
    u1, g1 = tp.batched_value_and_grad(fn)(new.ensemble.q)
    np.testing.assert_allclose(new.potential_energy.numpy(), u1.numpy(),
                               **tol)
    np.testing.assert_allclose(new.grad.numpy(), g1.numpy(), **tol)


def test_a_stage_stopped_short_of_beta_max_resamples():
    """The bisection stops where the ESS meets its target, 0.5 W by
    default, the resampling threshold too. The JAX package then resamples
    only if the float32 ESS rounds under the threshold: here it does not,
    and the next stage cannot move (the ESS can only fall) but by ulps.
    The port resamples such a stage, and the next one moves on."""
    q = _init(12, 2048, 3, 3.0)
    kw = dict(num_dims=3, num_mutation_steps=0, beta0=0.1, max_stages=5)
    jm = jsmc.build_smc_machinery(jp.make_standard_normal(3), 2048,
                                  jnp.float32, **kw)
    jc = jm["body"](jm["init_carry"](jax.random.key(0), jnp.asarray(q)))
    jbeta1, jlw1, jess1 = jc[2], jc[3], jc[9][0]
    assert float(jess1) >= 0.5 * 2048 and float(jnp.std(jlw1)) > 0.1
    jc = jm["body"](jc)
    assert float(jc[2]) - float(jbeta1) < 1e-5  # stalled
    tm = smc.build_smc_machinery(tp.make_standard_normal(3), 2048,
                                 torch.float32, device="cpu", **kw)
    tc = tm["body"](tm["init_carry"](0, torch.as_tensor(q)))
    assert float(tc.beta) == pytest.approx(float(jbeta1), abs=1e-6)
    assert bool(torch.all(tc.log_w == 0.0))  # resampled
    beta1 = float(tc.beta)
    tc = tm["body"](tc)
    assert float(tc.beta) > beta1 + 0.05


def test_fused_step_takes_a_potential_scale_and_the_composed_raises():
    """``build_fused_hmc_kernel``'s step with ``potential_scale`` (on CPU
    tensors the plain kernel B) targets exp(-scale U): its energy error is
    the composed tempered step's on the same draws; a state that runs the
    composed step refuses a scale."""
    fn, q = _forms()["gaussian"]
    q = torch.as_tensor(q, dtype=torch.float32)
    kern = pt.build_fused_hmc_kernel(fn, num_steps=6)
    st = kern.init(q)
    _, info = kern.step((9, 4), st, 0.1, potential_scale=0.37)
    w, d = q.shape
    k = pt.build_hmc_kernel(smc._tempered(fn, 0.37), num_steps=6)
    _, info_c = k.step((0, 0), k.init(q), 0.1,
                       momentum=philox.momentum_normals(9, 4, w, d, q.device),
                       uniform=philox.accept_uniforms(9, 4, w, q.device))
    np.testing.assert_allclose(info.energy_error.numpy(),
                               info_c.energy_error.numpy(),
                               rtol=1e-4, atol=1e-5)

    def unformed(x):
        return 0.5 * torch.sum(x * x, dim=-1)

    kern = pt.build_fused_hmc_kernel(unformed, num_steps=2)
    with pytest.raises(ValueError, match="potential_scale"):
        kern.step((0, 0), kern.init(q), 0.1, potential_scale=0.5)
