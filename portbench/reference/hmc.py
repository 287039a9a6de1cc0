"""The plain reference of the port's samplers: one HMC transition, the
replay of a sampling transition from given positions, and what the
warmup's adapted settings are held to: the step size at which the
transitions accept at the target rate, the metric the draws' variance
gives, and the ChEES criterion's slope at the adapted trajectory time.
Plain torch, written from the samplers' published semantics (Hoffman &
Gelman 2014; Hoffman, Radul & Sountsov 2021); it imports nothing of the
program.

``Precision`` says how the reference computes: in float64 it is the
reference; in a control it stands in for the program in the precision
below the configuration's (the configuration's ``control`` names it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from . import philox

Tensor = torch.Tensor
DIVERGENCE = 1000.0


@dataclasses.dataclass(frozen=True)
class Precision:
    """``dtype``: every float of the run. ``trajectory``: the drift/kick
    chain's dtype where it is lower (the momentum, both energies and the
    test stay in ``dtype``). ``tf32``: data products take their operands
    rounded to TF32, as tensor cores do."""

    name: str
    dtype: torch.dtype
    trajectory: Optional[torch.dtype] = None
    tf32: bool = False


PRECISIONS = {
    "float64": Precision("float64", torch.float64),
    "tf32_matmul": Precision("tf32_matmul", torch.float32, tf32=True),
    "bf16_trajectory": Precision("bf16_trajectory", torch.float32,
                                 trajectory=torch.bfloat16),
}


def to_tf32(x: Tensor) -> Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to
    even), kept in float32."""
    raw = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (raw + 0xFFF + ((raw >> 13) & 1)) & 0xFFFFE000
    r = r - ((r >> 31) << 32)
    return r.to(torch.int32).view(torch.float32)


def halton(length: int, base: int = 2) -> np.ndarray:
    """The van der Corput sequence in (0, 1), float64."""
    out = np.zeros((length,), np.float64)
    for i in range(length):
        f, r, n = 1.0, 0.0, i + 1
        while n > 0:
            f /= base
            r += f * (n % base)
            n //= base
        out[i] = r
    return out


def noise(seed: int, counter: int, walkers: Tensor, d: int, dtype) -> tuple:
    """Transition ``counter``'s momentum normals [w, D] and log uniforms
    [w] of the walkers ``walkers`` from the Philox stream."""
    return (philox.momentum_normals(seed, counter, walkers, d, dtype),
            torch.log(philox.accept_uniforms(seed, counter, walkers, dtype)))


def transition(vg: Callable, seed: int, counter: int, walkers: Tensor,
               q: Tensor, u: Tensor, g: Tensor, eps: Tensor,
               inv_mass: Tensor, num_steps: int, prec: Precision,
               draws: Optional[tuple] = None) -> dict:
    """One HMC transition of the walkers ``walkers`` (global indices) at
    positions ``q`` with cached ``(u, g)``: momentum ~ N(0, mass) from
    the Philox stream (``draws``: its :func:`noise`, drawn before),
    ``num_steps`` leapfrog steps with merged kicks, the Metropolis test on
    the stream's uniform. Returns the selected state, the proposal ``(q1,
    p1)`` with p1 flipped, and what decided."""
    dt = prec.dtype
    z, log_u = draws or noise(seed, counter, walkers, q.shape[1], dt)
    p0 = torch.sqrt(1.0 / inv_mass) * z
    h0 = 0.5 * torch.sum(p0 * p0 * inv_mass, dim=1) + u
    dtim = eps * inv_mass
    p = p0 - (0.5 * eps) * g
    if prec.trajectory is None:
        q1 = q
        for _ in range(num_steps):
            q1 = q1 + p * dtim
            u1, g1 = vg(q1)
            p = p - eps * g1
    else:
        low = prec.trajectory
        q1, p, dtiml, epsl = q.to(low), p.to(low), dtim.to(low), eps.to(low)
        for _ in range(num_steps):
            q1 = q1 + p * dtiml
            p = p - epsl * vg(q1)[1]
        q1, p = q1.to(dt), p.to(dt)
        u1, g1 = vg(q1)
    p = p + (0.5 * eps) * g1
    h1 = 0.5 * torch.sum(p * p * inv_mass, dim=1) + u1
    derr = h1 - h0
    derr = torch.where(torch.isfinite(derr), derr, torch.inf)
    divergent = derr > DIVERGENCE
    accepted = (log_u < -derr) & ~divergent
    accept_prob = torch.where(divergent, 0.0,
                              torch.exp(torch.clamp_max(-derr, 0.0)))
    sel = accepted[:, None]
    return {"q": torch.where(sel, q1, q), "u": torch.where(accepted, u1, u),
            "g": torch.where(sel, g1, g), "accept_prob": accept_prob,
            "accepted": accepted, "q1": q1, "p1": -p, "h0": h0,
            "margin": torch.where(divergent, torch.inf, log_u + derr)}


def chees_gradient(q0, q1, p1, accept_prob, h, inv_mass) -> Tensor:
    """d ChEES / d log tau (Hoffman et al. 2021, eq. 8) over the walkers
    given, accept-weighted and scaled by the spread of its two factors."""
    w = accept_prob + 1e-8
    wsum = torch.sum(w)
    q0c = q0 - torch.mean(q0, dim=0)
    q1c = q1 - torch.sum(w[:, None] * q1, dim=0) / wsum
    a = torch.sum(q1c * q1c, dim=1) - torch.sum(q0c * q0c, dim=1)
    b = torch.sum(q1c * (-p1 * inv_mass), dim=1)
    scale = torch.sqrt(torch.mean(a * a) * torch.mean(b * b)) + 1e-10
    return h * (torch.sum(w * a * b) / wsum) / scale


def chees_count(h: float, tau: float, eps: float, max_steps: int) -> int:
    """clip(round(2 h tau / eps), 1, max_steps)."""
    return int(min(max(round(2.0 * h * tau / eps), 1), max_steps))


@dataclasses.dataclass
class Kept:
    """A kept sampling transition: its Philox counter, its walkers' global
    indices, their positions before it with (U, dU/dq) there, its Halton
    jitter h and its :func:`noise`."""

    counter: int
    walkers: Tensor
    q: Tensor
    u: Tensor
    g: Tensor
    h: float
    draws: tuple


def mean_accept(vg: Callable, seed: int, kept: list, eps: float,
                inv_mass: Tensor, count: Callable, prec: Precision) -> float:
    """The Metropolis acceptance probability, averaged over the kept
    transitions' walkers, at step size ``eps``; ``count(h, eps)`` is the
    leapfrog count there."""
    total, num = 0.0, 0
    e = torch.tensor(eps, dtype=prec.dtype, device=inv_mass.device)
    for k in kept:
        out = transition(vg, seed, k.counter, k.walkers, k.q, k.u, k.g, e,
                         inv_mass, count(k.h, eps), prec, k.draws)
        total += float(torch.sum(out["accept_prob"]))
        num += k.q.shape[0]
    return total / num


def target_step_size(vg: Callable, seed: int, kept: list, eps: float,
                     inv_mass: Tensor, count: Callable, target: float,
                     prec: Precision, span: float = 3.0, stride: float = 0.05,
                     iters: int = 6) -> float:
    """The step size nearest ``eps`` at which the kept transitions accept
    at ``target`` on average: steps of ``stride`` in log step size from
    ``eps`` towards the target (up where they accept more), then bisection
    within the step that crossed; the last step within a factor e**span
    where none crosses. Nearest, since with a fixed leapfrog count the
    acceptance ripples with the step size beyond the first crossing."""
    def above(x):
        return mean_accept(vg, seed, kept, math.exp(x), inv_mass, count,
                           prec) > target
    x0 = math.log(eps)
    up = above(x0)
    step = stride if up else -stride
    lo = x0
    while abs(lo + step - x0) <= span + 1e-9:
        hi = lo + step
        if above(hi) != up:
            break
        lo = hi
    else:
        return math.exp(lo)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if above(mid) == up:
            lo = mid
        else:
            hi = mid
    return math.exp(0.5 * (lo + hi))


def chees_slope(vg: Callable, seed: int, kept: list, eps: float,
                inv_mass: Tensor, count: Callable, prec: Precision,
                grid: int = 8) -> float:
    """The ChEES criterion's slope in log tau at the trajectory time that
    ``count(h, eps)`` implies: the gradient over the jitters h = (k + 1/2)
    / grid, each from a kept transition in turn, summed and over the sum
    of the h. It is near 0 where tau was adapted, and towards +1 where
    longer trajectories would move the walkers further."""
    e = torch.tensor(eps, dtype=prec.dtype, device=inv_mass.device)
    total, hsum = 0.0, 0.0
    for j in range(grid):
        k = kept[j % len(kept)]
        h = (j + 0.5) / grid
        out = transition(vg, seed, k.counter, k.walkers, k.q, k.u, k.g, e,
                         inv_mass, count(h, eps), prec, k.draws)
        total += float(chees_gradient(k.q, out["q1"], out["p1"],
                                      out["accept_prob"], h, inv_mass))
        hsum += h
    return total / hsum


def metric_gap(mass: Tensor, moments: Tensor, count: int) -> float:
    """The largest |log(mass var)| over the dims: the program's diagonal
    metric (mass = 1 / variance) against the variance of the draws, from
    their sums ``moments`` [2, D] (of x and x^2, float64) over ``count``
    draws. At ~10^7 draws the samplers' shrinkage of the variance towards
    1e-3 moves it by under 1e-6, so the draws' variance is taken as is."""
    mean = moments[0] / count
    var = (moments[1] - count * mean * mean) / (count - 1)
    return float(torch.max(torch.abs(torch.log(mass.to(var) * var))))


def replay(vg: Callable, seed: int, counter: int, walkers: Tensor,
           q_prev: Tensor, q_next: Tensor, eps: Tensor, mass: Tensor,
           counts, prec: Precision, band: float = 1e-4):
    """[len(walkers)] gaps of a sampling transition replayed at the step
    size, metric and leapfrog count given. A walker's gap is the largest
    |q_next - q_ref| over the dims, q_ref the reference's state after
    transition ``counter`` from ``q_prev``, over the transition's scale:
    the median over the walkers of the largest move a proposal makes (so
    a step size adapted to nothing hides no gap). Where the test's margin
    |log u + dH| is under ``band`` (1 + |H0|), a rounding's width, either
    decision is the reference's; where the count sits on a rounding edge
    (``counts`` holds more than one), either count."""
    dt = prec.dtype
    q_prev, q_next = q_prev.to(dt), q_next.to(dt)
    inv_mass = 1.0 / mass.to(dt)
    eps = eps.to(dt)
    u, g = vg(q_prev)
    best = None
    for n in counts:
        out = transition(vg, seed, counter, walkers, q_prev, u, g, eps,
                         inv_mass, n, prec)
        scale = torch.median(torch.amax(torch.abs(out["q1"] - q_prev),
                                        dim=1))
        moved = torch.amax(torch.abs(q_next - out["q1"]), dim=1) / scale
        stayed = torch.amax(torch.abs(q_next - q_prev), dim=1) / scale
        taken = torch.where(out["accepted"], moved, stayed)
        either = torch.abs(out["margin"]) < band * (1.0 + torch.abs(
            out["h0"]))
        gap = torch.where(either, torch.minimum(moved, stayed), taken)
        best = gap if best is None else torch.minimum(best, gap)
    return best
