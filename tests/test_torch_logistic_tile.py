"""The logistic form's register tile on the host side: the walker tile it
takes (``kernels.logistic_tile``), its shared memory
(``kernels.logistic_shared_bytes``) and the refusals decided before any
launch, and its plain version (``kernels.device_value_and_grad`` of the
``"logistic"`` form), which rounds each multiply-add once as the kernels'
``fmaf`` does (``kernels._fma32``), against an exact reference and against
the JAX package's DSL potential.

Tolerance against JAX: value and gradient rtol=1e-4, atol=1e-5 in float32,
as ``tests/test_torch_model_forms.py`` (the value's 257 likelihood terms
are summed lane by lane, JAX sums them as XLA does)."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import models as jm
from physicsbasedbayesianinference_tpu.ops import potentials as jp
from physicsbasedbayesianinference_tpu_torch import models as tm
from physicsbasedbayesianinference_tpu_torch.ops import kernels as tk
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp

TOL = dict(rtol=1e-4, atol=1e-5)


def _form(n, p):
    x, y = tm.logistic_regression_data(n, p)
    return ("logistic", (torch.as_tensor(x), torch.as_tensor(y)))


# (W, N, D) -> tile
@pytest.mark.parametrize("w,n,d,want", [
    (102400, 256, 32, 4),  # phase 8a's shape: 800 blocks at tile 4
    (101376, 256, 32, 4),  # 792 blocks: 3 whole waves of 2 an SM on 132 SMs
    (8192, 256, 32, 2),    # 128 blocks at tile 2, 64 at tile 4
    (8192, 256, 31, 2),    # off the 16-byte path, the same layout
    (4096, 256, 32, 1),    # 128 blocks at tile 1
    (102400, 768, 33, 2),  # 16 lanes a walker: tile 4 passes shared memory
    (102400, 7, 6, 4), (1, 1, 1, 1)])
def test_logistic_tile_values(w, n, d, want):
    assert tk.logistic_tile(w, n, d) == want
    assert tk.logistic_tile(w, n, d) <= tk.walker_tile(w, d)
    assert tk.logistic_shared_bytes(n, d, want) <= tk.MAX_SHARED_BYTES


def test_logistic_shared_bytes_follow_the_layout():
    # D = 32: 8 lanes a walker, chunks of 4 x 8 = 32 rows, rows of 36 + 1
    # floats (x and y), 32 lane groups a block, a buffer row of 36 floats
    # per walker and a residual tile of 32 rows x R walkers + 4 a group;
    # before them kernel B's own part, a log uniform for each of the
    # block's 32 R walkers
    for tile in tk.WALKER_TILES:
        assert tk.logistic_shared_bytes(256, 32, tile) == 4 * (
            32 * tile + 256 * 37 + 32 * tile * 36 + 32 * (32 * tile + 4))
    # N = 257 pads to 288 rows (257 * 37 floats would not do)
    assert tk.logistic_shared_bytes(257, 32, 4) == 4 * (
        128 + 288 * 37 + 32 * 4 * 36 + 32 * (128 + 4))
    # D = 6: 2 lanes a walker, chunks of 8 rows, 7 rows pad to 8; x and y
    # round up to whole 16 bytes; kernel B's own part is 128 x 2 walkers
    assert tk.logistic_shared_bytes(7, 6, 2) == 4 * (
        256 + (8 * 13 + 3) // 4 * 4 + 128 * 2 * 12 + 128 * (8 * 2 + 4))


def test_refusals_come_before_any_launch():
    before = tk.fused_hmc_transition.launches
    # too many rows for shared memory even at tile 1
    assert "shared memory" in tk.generic_unsupported(_form(8000, 1), 2)
    # fits at tile 2 but not at 4: the chooser falls back, a forced 4 raises
    big = _form(768, 32)
    assert tk.generic_unsupported(big, 33) is None
    assert tk.logistic_tile(102400, 768, 33) == 2
    q = torch.zeros(3, 33)
    u, g = torch.zeros(3), torch.zeros(3, 33)
    kw = dict(scalars=torch.tensor([0.1, 1.0, 1.0]), p_std=torch.ones(33),
              inv_mass=torch.ones(33), num_steps=1)
    with pytest.raises(ValueError, match="shared memory"):
        tk.fused_hmc_transition(big, 0, 0, q, u, g, tile=4, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        tk.leapfrog_trajectory(big, q, q, step_size=torch.tensor(0.1),
                               num_steps=1, inv_mass=torch.ones(33), tile=4)
    assert tk.fused_hmc_transition.launches == before


def test_forced_tile_is_checked_and_changes_nothing_on_the_cpu():
    form = _form(40, 11)
    rng = np.random.default_rng(4)
    q = torch.as_tensor(0.3 * rng.normal(size=(9, 12)).astype(np.float32))
    p = torch.as_tensor(rng.normal(size=(9, 12)).astype(np.float32))
    u, g = tk.device_value_and_grad(form)(q)
    kw = dict(scalars=torch.tensor([0.05, 1.0, 1.0]), p_std=torch.ones(12),
              inv_mass=torch.ones(12), num_steps=3)
    lf = dict(step_size=torch.tensor(0.05), num_steps=3,
              inv_mass=torch.ones(12))
    base_b = tk.fused_hmc_transition(form, 1, 2, q, u, g, **kw)
    base_d = tk.leapfrog_trajectory(form, q, p, **lf)
    for tile in tk.WALKER_TILES:
        for a, b in zip(base_b, tk.fused_hmc_transition(
                form, 1, 2, q, u, g, tile=tile, **kw)):
            assert torch.equal(a, b)
        for a, b in zip(base_d, tk.leapfrog_trajectory(
                form, q, p, tile=tile, **lf)):
            assert torch.equal(a, b)
    for bad in (3, 8):
        with pytest.raises(ValueError, match="tile must be one of"):
            tk.fused_hmc_transition(form, 1, 2, q, u, g, tile=bad, **kw)
        with pytest.raises(ValueError, match="tile must be one of"):
            tk.leapfrog_trajectory(form, q, p, tile=bad, **lf)


def test_fma32_rounds_once():
    # 1 + 2^-23 + (2^-24 - 2^-70): a float64 sum rounds onto the float32
    # tie and then to even (1 + 2^-22); the fused multiply-add gives
    # 1 + 2^-23
    a = torch.tensor([1 + 2**-23, -(1 + 2**-23)], dtype=torch.float32)
    b = torch.tensor([2**-24 - 2**-47] * 2, dtype=torch.float32)
    c = torch.tensor([1 + 2**-23, -(1 + 2**-23)], dtype=torch.float32)
    assert tk._fma32(a, b, c).tolist() == [1 + 2**-23, -(1 + 2**-23)]
    naive = (a.double() * b.double() + c.double()).float()
    assert naive.tolist() == [1 + 2**-22, -(1 + 2**-22)]
    # infinities pass through as the card's fmaf passes them
    inf = float("inf")
    got = tk._fma32(torch.tensor([1.0, 1.0, 2.0]),
                    torch.tensor([inf, -inf, 3.0]),
                    torch.tensor([0.0, 0.0, -inf]))
    assert got.tolist() == [inf, -inf, -inf]
    # random operands, with sums that cancel, against exact arithmetic
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 400)).astype(np.float32)
    x[2, :200] = (-(x[0, :200].astype(np.float64) * x[1, :200])
                  + 1e-7 * rng.normal(size=200)).astype(np.float32)
    got = tk._fma32(*map(torch.as_tensor, x)).numpy()
    for i in range(x.shape[1]):
        assert got[i] == _round_f32(Fraction(float(x[0, i]))
                                    * Fraction(float(x[1, i]))
                                    + Fraction(float(x[2, i])))


def _round_f32(v: Fraction) -> np.float32:
    """v rounded to the nearest float32, ties to even."""
    f = np.float32(float(v))
    near = [np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda c: (abs(Fraction(float(c)) - v),
                                    int(c.view(np.uint32)) & 1))


def test_plain_form_sums_as_the_kernel_does():
    """z over the dims and the gradient over the rows, each in index order
    with one rounding a multiply-add, against exact arithmetic step by
    step; the value's likelihood terms lane by lane (rows l, l + T, ...)."""
    n, p, w = 9, 5, 3
    x, y = tm.logistic_regression_data(n, p)
    rng = np.random.default_rng(7)
    q = (0.5 * rng.normal(size=(w, p + 1))).astype(np.float32)
    u, g = tk.device_value_and_grad(("logistic", (
        torch.as_tensor(x), torch.as_tensor(y))))(torch.as_tensor(q))
    xa = np.concatenate([x, np.ones((n, 1), np.float32)], 1)
    for i in range(w):
        z = np.zeros(n, np.float32)
        for r in range(n):
            for k in range(p + 1):
                z[r] = _round_f32(Fraction(float(xa[r, k]))
                                  * Fraction(float(q[i, k]))
                                  + Fraction(float(z[r])))
        res = (1.0 / (1.0 + torch.exp(-torch.as_tensor(z)))
               - torch.as_tensor(y)).numpy()
        acc = np.zeros(p + 1, np.float32)
        for r in range(n):
            for k in range(p + 1):
                acc[k] = _round_f32(Fraction(float(res[r]))
                                    * Fraction(float(xa[r, k]))
                                    + Fraction(float(acc[k])))
        assert np.array_equal(g[i].numpy(), q[i] + acc)
        zt = torch.as_tensor(z)
        lik = ((torch.clamp_min(zt, 0.0) + torch.log1p(torch.exp(-zt.abs())))
               - torch.as_tensor(y) * zt)
        t = tk.threads_per_walker(p + 1)  # 2 lanes: rows 0, 2, ... and 1, 3
        lanes = [torch.zeros(()) for _ in range(t)]
        for r in range(n):
            lanes[r % t] = lanes[r % t] + lik[r]
        quad = torch.zeros(t)
        q4 = torch.zeros(4 * t)
        q4[:p + 1] = torch.as_tensor(q[i])
        for e in range(4):
            quad = quad + q4.reshape(t, 4)[:, e] * q4.reshape(t, 4)[:, e]
        want = (0.5 * (quad[0] + quad[1]) + (lanes[0] + lanes[1])
                + torch.tensor(tk._HALF_LOG_2PI) * float(p + 1))
        assert u[i].item() == want.item()


@pytest.mark.parametrize("n,p", [(257, 31), (257, 30), (100, 32)])
def test_plain_form_matches_the_jax_potential(n, p):
    """N = 257 (not a multiple of the 32-row chunk), D = 32, 31 and 33."""
    x, y = tm.logistic_regression_data(n, p)
    jmp = jm.make_model_potential(jm.examples.logistic_regression,
                                  (jnp.asarray(x), jnp.asarray(y)), {})
    tmp = tm.make_model_potential(tm.logistic_regression, (x, y), {},
                                  device="cpu")
    form = tmp.potential.device_form
    assert form[0] == "logistic" and tk.generic_unsupported(
        form, tmp.num_dims) is None
    q = (0.3 * np.random.default_rng(n + p).normal(
        size=(17, tmp.num_dims))).astype(np.float32)
    fu, fg = tk.device_value_and_grad(form)(torch.as_tensor(q))
    ju, jg = jp.batched_value_and_grad(jmp.potential)(jnp.asarray(q))
    tu, tg = tp.batched_value_and_grad(tmp.potential)(torch.as_tensor(q))
    for u, g in ((np.asarray(ju), np.asarray(jg)), (tu.numpy(), tg.numpy())):
        np.testing.assert_allclose(fu.numpy(), u, **TOL)
        np.testing.assert_allclose(fg.numpy(), g, **TOL)
