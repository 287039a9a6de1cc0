"""The plain-torch Philox4x32-10 stream that the fused CUDA kernels share."""

import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu_torch.ops import philox

M = 0xFFFFFFFF


@pytest.mark.parametrize("ctr,key,expect", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M, M, M, M), (M, M),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_known_answer_vectors(ctr, key, expect):
    """Random123's philox4x32_10 known-answer vectors, bit for bit."""
    out = philox.philox4x32_10(*ctr, *key)
    assert tuple(int(x) for x in out) == expect


def test_vectorised_matches_scalar_calls():
    w = torch.arange(5, dtype=torch.int64)
    batch = philox.philox4x32_10(3, w, 2, 1, 0x1234, 0x5678)
    for i in range(5):
        one = philox.philox4x32_10(3, i, 2, 1, 0x1234, 0x5678)
        assert [int(b[i]) for b in batch] == [int(x) for x in one]


def test_uniforms_match_the_jax_conversion():
    """Top 24 bits / 2^24 + 2^-25, bit for bit as the JAX kernels convert
    (pallas_kernels._uniform_from_bits); the range is (0, 1] because the
    largest word rounds to 1.0 in float32."""
    import jax.numpy as jnp

    from physicsbasedbayesianinference_tpu.ops.pallas_kernels import (
        _uniform_from_bits)

    words = [0, 0xFF, 0x100, 0x12345678, 0xFFFFFEFF, M]
    u = philox.uniform_from_bits(torch.tensor(words, dtype=torch.int64))
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(_uniform_from_bits(
            jnp.asarray(words, dtype=jnp.uint32))))
    np.testing.assert_array_equal(
        u.numpy()[[0, 2, 5]], np.float32([2.0**-25, 2.0**-24 + 2.0**-25,
                                          1.0]))
    draws = philox.accept_uniforms(7, 3, 100_000)
    assert bool((draws > 0).all()) and bool((draws <= 1).all())
    # MC error of the mean of 1e5 uniforms is 9e-4
    assert abs(float(draws.mean()) - 0.5) < 5e-3


def test_normals_moments_and_layout():
    n = philox.momentum_normals(11, 5, 4000, 64)
    assert n.shape == (4000, 64) and n.dtype == torch.float32
    x = n.double()
    # MC errors over 256000 draws: mean 2e-3, var 2.8e-3, 3rd moment 4.8e-3
    assert abs(float(x.mean())) < 0.01
    assert abs(float(x.var()) - 1.0) < 0.015
    assert abs(float((x**3).mean())) < 0.025
    # dims come in groups of four: a narrower D is a prefix of a wider one
    np.testing.assert_array_equal(
        philox.momentum_normals(11, 5, 10, 6).numpy(),
        philox.momentum_normals(11, 5, 10, 8)[:, :6].numpy())


def test_streams_differ_by_counter_walker_and_seed():
    base = philox.momentum_normals(1, 0, 8, 4)
    assert not torch.equal(base, philox.momentum_normals(1, 1, 8, 4))
    assert not torch.equal(base, philox.momentum_normals(2, 0, 8, 4))
    assert not torch.equal(base[0], base[1])
    # 64-bit seeds: the high word is part of the key
    assert not torch.equal(philox.momentum_normals(1 << 32, 0, 8, 4),
                           philox.momentum_normals(0, 0, 8, 4))
    assert not torch.equal(philox.accept_uniforms(1, 0, 8),
                           philox.accept_uniforms(1, 1, 8))
