"""Philox4x32-10 counter draws in plain torch: the random stream every fused
transition of the port draws, written out again here so that the plain
reference and the program take the same momenta and uniforms.

Counter layout (the kernels'): key = the run's 64-bit seed (k0 low word,
k1 high word); counter = (transition index, global walker index,
dim-group, site). A dim-group is four dims: one Philox block gives four
words, two Box-Muller pairs ((w0, w1) -> dims 4g, 4g+1; (w2, w3) -> 4g+2,
4g+3). Site 0 is the momentum, site 1 the Metropolis uniform (word 0 of
group 0). uint32 arithmetic runs in int64 tensors; the multiplier is split
into 16-bit halves so that no product passes 2^48.
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


def _mulhilo(a: Tensor, m: int):
    x = a * (m & 0xFFFF)
    y = a * (m >> 16)
    hi = (y + (x >> 16)) >> 16
    lo = (((y & 0xFFFF) << 16) + x) & _MASK
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Random123's philox4x32_10 on broadcastable int64 counter words."""
    dev = next(c.device for c in (c0, c1, c2, c3) if isinstance(c, Tensor))
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64, device=dev)
          for c in (c0, c1, c2, c3)))
    for r in range(10):
        if r > 0:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _key(seed: int):
    seed &= 0xFFFFFFFFFFFFFFFF
    return seed & _MASK, seed >> 32


def uniforms(bits: Tensor, dtype) -> Tensor:
    """Words -> uniforms in (0, 1]: the top 24 bits / 2^24 + 2^-25, exact
    in float32 and float64."""
    return (bits >> 8).to(dtype) * (1.0 / (1 << 24)) + 0.5 / (1 << 24)


def momentum_normals(seed: int, counter: int, walkers: Tensor, num_dims: int,
                     dtype) -> Tensor:
    """[len(walkers), D] standard normals of transition ``counter`` for the
    global walker indices ``walkers`` (int64), Box-Muller in ``dtype``."""
    k0, k1 = _key(seed)
    groups = -(-num_dims // 4)
    w = (walkers.to(torch.int64) & _MASK)[:, None]
    g = torch.arange(groups, dtype=torch.int64, device=walkers.device)[None]
    x = philox4x32_10(counter & _MASK, w, g, SITE_MOMENTUM, k0, k1)
    out = []
    for a, b in ((x[0], x[1]), (x[2], x[3])):
        u1, u2 = uniforms(a, dtype), uniforms(b, dtype)
        r = torch.sqrt(-2.0 * torch.log(u1))
        theta = (2.0 * math.pi) * u2
        out += [r * torch.cos(theta), r * torch.sin(theta)]
    n = torch.stack(out, dim=-1)  # [W, G, 4]
    return n.reshape(walkers.shape[0], 4 * groups)[:, :num_dims]


def accept_uniforms(seed: int, counter: int, walkers: Tensor,
                    dtype) -> Tensor:
    """[len(walkers)] Metropolis uniforms in (0, 1] of transition
    ``counter``."""
    k0, k1 = _key(seed)
    w = walkers.to(torch.int64) & _MASK
    x0, _, _, _ = philox4x32_10(counter & _MASK, w, 0, SITE_ACCEPT, k0, k1)
    return uniforms(x0, dtype)
