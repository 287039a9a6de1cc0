"""What the CPU can check of the Gaussian form's register-tiled matvec in
kernels B and D: the plain version's arithmetic (one rounding per
multiply-add, as the kernels' fmaf), the plain transition and trajectory
with that form against the JAX Pallas kernels in interpret mode, and the
host side of the layout (``threads_per_walker``, ``walker_tile``).

Tolerance of the gradient: g_i = sum_j d_j P_ji in float32, summed in index
order, is within (j - 1 + 1) roundings of u = 2^-24 each of the exact sum,
at most D u S_i with S_i = sum_j |d_j P_ji| and about sqrt(D) u S_i for
roundings that do not line up; 4 sqrt(D) u S_i is held against the float64
matvec, and twice that against the JAX gradient, which carries its own
roundings of the same size in another order. The value 0.5 d . g inherits
g's error and adds a D-term float32 sum: 8 sqrt(D) u sum_i |d_i| S_i.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu.ops import pallas_kernels as jk
from physicsbasedbayesianinference_tpu.ops import potentials as jp
from physicsbasedbayesianinference_tpu_torch.ops import kernels as tk
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp
from _torch_cpu import cpu_requested  # noqa: F401  (the CPU, asked for)

pytestmark = pytest.mark.skipif(
    jax.default_backend() == "tpu",
    reason="the JAX side runs the Pallas kernels in interpret mode")

TOL = dict(rtol=1e-5, atol=1e-5)
U32 = 2.0 ** -24


def _gaussian(d, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(d, d)) / np.sqrt(d)
    mean = rng.normal(size=d).astype(np.float32)
    cov = (a @ a.T + 0.5 * np.eye(d)).astype(np.float32)
    return rng, mean, cov


# ---------------------------------------------------------------------------
# (a) the plain version's arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [2, 10, 31, 32, 33, 128])
def test_gaussian_vg_matches_float64_and_jax(d):
    rng, mean, cov = _gaussian(d, d)
    form = tp.make_gaussian(mean, cov=cov).device_form
    prec = form[1][1].numpy()
    q = (mean + 2.0 * rng.normal(size=(64, d))).astype(np.float32)
    u, g = (x.numpy() for x in tk.device_value_and_grad(form)(
        torch.as_tensor(q)))
    assert u.dtype == np.float32 and g.dtype == np.float32

    diff = (q - mean).astype(np.float64)  # the float32 difference, widened
    p64 = prec.astype(np.float64)
    g64 = diff @ p64
    abs_sum = np.abs(diff) @ np.abs(p64)                     # S_i
    assert (np.abs(g - g64) <= 4 * np.sqrt(d) * U32 * abs_sum).all()
    u64 = 0.5 * np.sum(diff * g64, axis=1)
    u_scale = np.sum(np.abs(diff) * abs_sum, axis=1)
    assert (np.abs(u - u64) <= 8 * np.sqrt(d) * U32 * u_scale).all()

    ju, jg = (np.asarray(x) for x in jp.batched_value_and_grad(
        jp.make_gaussian(mean, precision=prec))(jnp.asarray(q)))
    assert (np.abs(g - jg) <= 8 * np.sqrt(d) * U32 * abs_sum).all()
    assert (np.abs(u - ju) <= 16 * np.sqrt(d) * U32 * u_scale).all()


def test_gaussian_vg_rounds_each_multiply_add_once():
    """One term shows the single rounding: with d = P = 1 + 2^-12 the exact
    product is 1 + 2^-11 + 2^-24, which a float32 multiplication rounds to
    1 + 2^-11 (a tie, to even); added to g = -(1 + 2^-11) that gives 0,
    while the fused multiply-add keeps 2^-24."""
    x = np.float32(1 + 2.0 ** -12)
    rounded = np.float32(1 + 2.0 ** -11)
    assert np.float32(x * x) == rounded
    # g_0 after row 0 is -(1 + 2^-11) exactly; row 1 adds x * x
    mean = torch.zeros(2)
    prec = torch.tensor([[-float(rounded), 0.0], [float(x), 0.0]])
    q = torch.tensor([[1.0, float(x)]])
    _, g = tk.device_value_and_grad(("gaussian", (mean, prec)))(q)
    assert g[0, 0].item() == 2.0 ** -24
    assert g[0, 1].item() == 0.0


def test_gaussian_vg_keeps_float64_parameters_in_float64():
    rng, mean, cov = _gaussian(6, 3)
    prec = np.linalg.inv(cov.astype(np.float64))
    q = rng.normal(size=(9, 6))
    u, g = tk.device_value_and_grad(
        ("gaussian", (torch.as_tensor(mean, dtype=torch.float64),
                      torch.as_tensor(prec))))(torch.as_tensor(q))
    assert u.dtype == torch.float64 and g.dtype == torch.float64
    np.testing.assert_allclose(g.numpy(), (q - mean) @ prec, rtol=1e-12)


# ---------------------------------------------------------------------------
# (b) the plain transition and trajectory with the Gaussian form
# ---------------------------------------------------------------------------

B_ORDER = ("q", "u", "g", "accept_prob", "accepted", "energy_error")


@pytest.mark.parametrize("d", [5, 32])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_gaussian_transition_plain_matches_pallas(d, scale):
    """From rest (p_std = 0) nothing depends on a random stream:
    energy_error, accept_prob and, where both accept, q', u', g' to
    rtol=atol=1e-5 of JAX kernel B in interpret mode (float32, sums in
    another order)."""
    w, steps, step, beta = 64, 4, 0.15, 1.0
    rng, mean, cov = _gaussian(d, 10 + d)
    q = (mean + rng.normal(size=(w, d))).astype(np.float32)
    im = rng.uniform(0.5, 2.0, d).astype(np.float32)
    vg = jp.batched_value_and_grad(jp.make_gaussian(mean, cov=cov))
    u, g = (np.array(x) for x in vg(jnp.asarray(q)))
    jout = jk.make_fused_hmc_transition(vg, num_steps=steps)(
        jnp.int32(3), jnp.asarray(q), jnp.asarray(u), jnp.asarray(g),
        step_size=jnp.float32(step), p_std=0.0, inv_mass=jnp.asarray(im),
        beta=beta, scale=jnp.float32(scale))
    tout = tk.fused_hmc_transition_plain(
        tp.make_gaussian(mean, cov=cov).device_form, 3, 0,
        torch.as_tensor(q), torch.as_tensor(u), torch.as_tensor(g),
        scalars=torch.tensor([step, beta, scale]), p_std=torch.zeros(d),
        inv_mass=torch.as_tensor(im), num_steps=steps)
    j = dict(zip(B_ORDER, (np.asarray(x) for x in jout)))
    t = dict(zip(B_ORDER, (x.numpy() for x in tout)))
    np.testing.assert_allclose(t["energy_error"], j["energy_error"], **TOL)
    np.testing.assert_allclose(t["accept_prob"], j["accept_prob"], **TOL)
    both = j["accepted"] & t["accepted"]
    assert both.mean() > 0.5
    for key in ("q", "u", "g"):
        np.testing.assert_allclose(t[key][both], j[key][both], **TOL)


@pytest.mark.parametrize("d", [8, 32])
def test_gaussian_leapfrog_plain_matches_pallas(d):
    """q', p', u', g' to rtol=atol=1e-5 of JAX kernel D in interpret mode
    (float32, sums in another order)."""
    w, steps, step = 128, 6, 0.1
    rng, mean, cov = _gaussian(d, 20 + d)
    q = (mean + rng.normal(size=(w, d))).astype(np.float32)
    p = rng.normal(size=(w, d)).astype(np.float32)
    im = rng.uniform(0.5, 2.0, d).astype(np.float32)
    jout = jk.make_pallas_leapfrog(128)(
        jp.batched_value_and_grad(jp.make_gaussian(mean, cov=cov)),
        jnp.asarray(q), jnp.asarray(p), step_size=jnp.float32(step),
        num_steps=steps, inv_mass=jnp.asarray(im))
    tout = tk.leapfrog_trajectory_plain(
        tp.make_gaussian(mean, cov=cov).device_form, torch.as_tensor(q),
        torch.as_tensor(p), step_size=torch.tensor(step), num_steps=steps,
        inv_mass=torch.as_tensor(im))
    for a, b in zip(tout, jout):  # q', p', u', g'
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# (c) the layout's host side: lanes per walker and the walker tile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,want", [(1, 1), (4, 1), (5, 2), (8, 2), (10, 4),
                                    (16, 4), (17, 8), (32, 8), (33, 16),
                                    (64, 16), (65, 32), (127, 32),
                                    (128, 32)])
def test_threads_per_walker(d, want):
    assert tk.threads_per_walker(d) == want


# (W, D) -> tile: the shapes of the kernel table, D = 128, and the edges
@pytest.mark.parametrize("w,d,want", [
    (102400, 32, 4),   # the correlated Gaussian at the bench width
    (8192, 32, 2),     # 128 blocks at tile 2, 64 at tile 4
    (8192, 2, 1),      # the verify drive: 32 blocks whatever the tile
    (8192, 10, 1),     # the 10-dim drive: 128 blocks at tile 1
    (102400, 128, 4),
    (8192, 128, 4),    # 8 walkers a block at tile 1: 256 blocks at tile 4
    (4096, 32, 1), (8192, 32, 2), (16384, 32, 4),   # 128 full blocks
    (8128, 32, 1), (8129, 32, 2),      # 127 and 128 blocks at tile 2
    (16256, 32, 2), (16257, 32, 4),    # 127 and 128 blocks at tile 4
    (1, 1, 1), (1, 128, 1), (10**7, 1, 4)])
def test_walker_tile_values(w, d, want):
    assert tk.walker_tile(w, d) == want


FILL = 128  # blocks of 256 threads that fill the card (all but 4 of 132 SMs)


def _blocks(w, d, tile):
    per_block = 256 // tk.threads_per_walker(d) * tile
    return -(-w // per_block)


def test_walker_tile_fills_the_card_and_never_grows_as_w_shrinks():
    for d in (1, 2, 10, 31, 32, 33, 64, 100, 128):
        widths = [1, 2, 100, 1000, 4064, 4065, 4096, 8128, 8129, 8192, 16256,
                  16257, 16384, 20000, 65536, 102400, 10**6, 10**7]
        tiles = [tk.walker_tile(w, d) for w in widths]
        assert all(a <= b for a, b in zip(tiles, tiles[1:])), (d, tiles)
        for w, tile in zip(widths, tiles):
            assert tile in tk.WALKER_TILES
            # never fewer blocks than fill the card where tile 1 has them
            if _blocks(w, d, 1) >= FILL:
                assert _blocks(w, d, tile) >= FILL
            # and the largest such tile
            for larger in tk.WALKER_TILES:
                if larger > tile:
                    assert _blocks(w, d, larger) < FILL
    for bad in ((0, 4), (4, 0)):
        with pytest.raises(ValueError, match="at least one walker"):
            tk.walker_tile(*bad)


def test_forced_tile_is_checked_and_changes_nothing_on_the_cpu():
    rng, mean, cov = _gaussian(6, 0)
    form = tp.make_gaussian(mean, cov=cov).device_form
    q = torch.as_tensor(rng.normal(size=(11, 6)).astype(np.float32))
    p = torch.as_tensor(rng.normal(size=(11, 6)).astype(np.float32))
    u, g = tk.device_value_and_grad(form)(q)
    kw = dict(scalars=torch.tensor([0.1, 1.0, 1.0]), p_std=torch.ones(6),
              inv_mass=torch.ones(6), num_steps=3)
    lf = dict(step_size=torch.tensor(0.1), num_steps=3,
              inv_mass=torch.ones(6))
    base_b = tk.fused_hmc_transition(form, 1, 2, q, u, g, **kw)
    base_d = tk.leapfrog_trajectory(form, q, p, **lf)
    for tile in tk.WALKER_TILES:
        for x, y in zip(base_b, tk.fused_hmc_transition(
                form, 1, 2, q, u, g, tile=tile, **kw)):
            assert torch.equal(x, y)
        for x, y in zip(base_d, tk.leapfrog_trajectory(form, q, p, tile=tile,
                                                       **lf)):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="tile must be one of"):
        tk.fused_hmc_transition(form, 1, 2, q, u, g, tile=3, **kw)
    with pytest.raises(ValueError, match="tile must be one of"):
        tk.leapfrog_trajectory(form, q, p, tile=8, **lf)
    funnel = tp.make_funnel(6).device_form
    fu, fg = tk.device_value_and_grad(funnel)(q)
    with pytest.raises(ValueError, match="only the gaussian form"):
        tk.fused_hmc_transition(funnel, 1, 2, q, fu, fg, tile=2, **kw)
    tk.fused_hmc_transition(funnel, 1, 2, q, fu, fg, tile=1, **kw)
