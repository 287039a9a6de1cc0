"""Kernel E's plain version (``ops/kernels.py``
``nbody_accelerations_tiled_plain``) against the JAX package's
``nbody_accelerations_pallas`` in interpret mode (as tests/test_pallas.py
runs it) and against its XLA ``nbody_accelerations``, plus the CPU dispatch
of the wrapper.

Tolerance, from summation order: per body and component, |a_port - a_jax|
<= C u sqrt(N) S_i with u the dtype's unit roundoff, S_i the sum of the
magnitudes of a_i's terms (``kernels.nbody_abs_sum``) and C = 4, the
summation-order part of the bound ``chip_smoke.py`` holds kernel E to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu.constants import SI
from physicsbasedbayesianinference_tpu.ops import pallas_kernels as jk
from physicsbasedbayesianinference_tpu.ops import potentials as jp
from physicsbasedbayesianinference_tpu_torch.ops import kernels as tk

C = 4.0


def _bodies(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(dtype),
            rng.uniform(0.5, 2.0, n).astype(dtype))


def _assert_within_bound(port, ref, x, m, softening, g_const=1.0):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(port).all()
    scale = tk.nbody_abs_sum(torch.as_tensor(x), torch.as_tensor(m),
                             g_const=g_const, softening=softening).numpy()
    u = np.finfo(x.dtype).eps / 2
    bound = C * u * np.sqrt(x.shape[0]) * scale[:, None]
    ratio = np.abs(port - ref) / bound
    assert ratio.max() <= 1.0, ratio.max()


@pytest.mark.parametrize("n", [100, 300, 512])
def test_plain_matches_pallas_interpret(n):
    x, m = _bodies(n, n)
    ref = jk.nbody_accelerations_pallas(jnp.asarray(x), jnp.asarray(m),
                                        block=128)
    port = tk.nbody_accelerations_tiled_plain(
        torch.as_tensor(x), torch.as_tensor(m), g_const=1.0,
        softening=1e-8)
    _assert_within_bound(port.numpy(), ref, x, m, 1e-8)


def test_body_at_origin_without_softening_stays_finite():
    """The JAX kernel pads its sources with zero-mass bodies at the origin,
    so a body there sees 0 * inf = NaN at eps = 0; the XLA form and the
    port have no padded source."""
    x, m = _bodies(100, 7)
    x[17] = 0.0
    pallas = np.asarray(jk.nbody_accelerations_pallas(
        jnp.asarray(x), jnp.asarray(m), softening=0.0, block=128))
    assert np.isnan(pallas[17]).all()  # the fault, not copied
    ref = jp.nbody_accelerations(jnp.asarray(x), jnp.asarray(m),
                                 softening=0.0)
    port = tk.nbody_accelerations_tiled_plain(
        torch.as_tensor(x), torch.as_tensor(m), g_const=1.0, softening=0.0)
    _assert_within_bound(port.numpy(), ref, x, m, 0.0)


def test_float64_and_constants_match_xla():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        x, m = _bodies(100, 3, np.float64)
        ref = jp.nbody_accelerations(jnp.asarray(x), jnp.asarray(m),
                                     constants=SI, softening=0.05)
        port = tk.nbody_accelerations_tiled_plain(
            torch.as_tensor(x), torch.as_tensor(m), g_const=SI.G,
            softening=0.05)
        assert port.dtype == torch.float64
        _assert_within_bound(port.numpy(), ref, x, m, 0.05, SI.G)
    finally:
        jax.config.update("jax_enable_x64", old)


def test_plain_blocks_agree_with_one_block(monkeypatch):
    x, m = _bodies(300, 5)
    xt, mt = torch.as_tensor(x), torch.as_tensor(m)
    whole = tk.nbody_accelerations_tiled_plain(xt, mt, g_const=1.0,
                                               softening=0.1)
    monkeypatch.setattr(tk, "_PLAIN_PAIR_BLOCK", 300 * 7)  # 7-row blocks
    blocked = tk.nbody_accelerations_tiled_plain(xt, mt, g_const=1.0,
                                                 softening=0.1)
    assert torch.equal(whole, blocked)  # row blocks do not reorder a sum


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    x, m = _bodies(50, 1)
    xt, mt = torch.as_tensor(x), torch.as_tensor(m)
    before = tk.launch_counts()
    a = tk.nbody_accelerations_tiled(xt, mt, g_const=2.0, softening=0.1)
    b = tk.nbody_accelerations_tiled_plain(xt, mt, g_const=2.0,
                                           softening=0.1)
    assert torch.equal(a, b)
    assert tk.launch_counts() == before


def test_wrapper_refuses_other_devices():
    x = torch.empty(8, 3, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tk.nbody_accelerations_tiled(x, torch.empty(8, device="meta"),
                                     g_const=1.0, softening=0.0)
