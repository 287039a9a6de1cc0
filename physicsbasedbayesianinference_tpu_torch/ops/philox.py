"""Counter-based Philox4x32-10 in plain torch: the same bits as
``csrc/philox.cuh``, which both fused CUDA kernels include.

Counter layout, shared with the kernels:

    key     = the run's 64-bit seed (k0 = low 32 bits, k1 = high 32 bits)
    counter = (transition index, walker, dim-group, draw site)

A dim-group is four consecutive dimensions ``4g .. 4g+3``: one Philox call
yields four uint32 words, turned into four normals by Box-Muller with both
branches (``(w0, w1)`` -> dims ``4g, 4g+1``; ``(w2, w3)`` -> ``4g+2, 4g+3``).
Site 0 is the momentum refresh, site 1 the Metropolis uniform (word 0 of
group 0). Distinct transitions, walkers and sites never share a counter, so
no per-transition host RNG is needed. The walker word is the global walker
index: ``walker_offset`` is the index of row 0 of a block of a sharded
ensemble, so the block draws the rows that the whole ensemble draws.

uint32 arithmetic runs in int64 tensors. The 32x32-bit multiply splits the
constant multiplier into 16-bit halves so that no product exceeds 2^48.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85

SITE_MOMENTUM = 0
SITE_ACCEPT = 1


def _mulhilo(a: Tensor, m: int) -> tuple[Tensor, Tensor]:
    """(hi, lo) 32-bit words of ``a * m`` for ``a`` in [0, 2^32)."""
    x = a * (m & 0xFFFF)      # < 2^48
    y = a * (m >> 16)         # < 2^48
    hi = (y + (x >> 16)) >> 16
    lo = (((y & 0xFFFF) << 16) + x) & _MASK
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Random123's philox4x32_10 on broadcastable int64 counter words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64)
                      for c in (c0, c1, c2, c3))
    for r in range(10):
        if r > 0:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def split_seed(seed: int) -> tuple[int, int]:
    """64-bit seed -> Philox key words (k0, k1)."""
    seed &= 0xFFFFFFFFFFFFFFFF
    return seed & _MASK, seed >> 32


def uniform_from_bits(bits: Tensor) -> Tensor:
    """uint32 words -> float32 uniforms: top 24 bits / 2^24 + 2^-25, the JAX
    kernels' conversion. The range is (0, 1]: the largest word rounds to
    exactly 1.0, where log gives 0 and Box-Muller a zero normal."""
    return ((bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
            + (0.5 / (1 << 24)))


def _box_muller(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    u1, u2 = uniform_from_bits(a), uniform_from_bits(b)
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = (2.0 * math.pi) * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def _walkers(num_walkers: int, walker_offset: int, device) -> Tensor:
    """The walker words of rows ``walker_offset .. + num_walkers``, as the
    kernels form them (uint32 arithmetic)."""
    return (torch.arange(num_walkers, dtype=torch.int64, device=device)
            + walker_offset) & _MASK


def momentum_normals(seed: int, counter: int, num_walkers: int,
                     num_dims: int, device=None,
                     walker_offset: int = 0) -> Tensor:
    """[W, D] standard normals of transition ``counter`` (site 0) for the
    walkers ``walker_offset .. walker_offset + W - 1``."""
    k0, k1 = split_seed(seed)
    groups = -(-num_dims // 4)
    w = _walkers(num_walkers, walker_offset, device)[:, None]
    g = torch.arange(groups, dtype=torch.int64, device=device)[None, :]
    x0, x1, x2, x3 = philox4x32_10(counter & _MASK, w, g, SITE_MOMENTUM,
                                   k0, k1)
    n0, n1 = _box_muller(x0, x1)
    n2, n3 = _box_muller(x2, x3)
    n = torch.stack([n0, n1, n2, n3], dim=-1)  # [W, G, 4]
    return n.reshape(num_walkers, 4 * groups)[:, :num_dims]


def accept_uniforms(seed: int, counter: int, num_walkers: int,
                    device=None, walker_offset: int = 0) -> Tensor:
    """[W] Metropolis uniforms in (0, 1] of transition ``counter`` for the
    walkers ``walker_offset .. walker_offset + W - 1``."""
    k0, k1 = split_seed(seed)
    w = _walkers(num_walkers, walker_offset, device)
    x0, _, _, _ = philox4x32_10(counter & _MASK, w, 0, SITE_ACCEPT, k0, k1)
    return uniform_from_bits(x0)
