"""The frozen yardstick of a fused transition's least time on one H100: a
copy of ``chip_smoke.py``'s counts as they stood when this benchmark was
defined, kept here so that no later change to the program moves it.

The least time is the larger of the bytes the transition must move (each
input read once, each output written once) at the HBM's rate and its
lane-instructions at the card's rate outside the tensor cores, a
multiply-add counted once and each transcendental function at the length
of its SASS sequence. The rates are NVIDIA's published peaks of the H100
SXM at 700 W; ``peaks.json`` holds them.
"""

from __future__ import annotations

import json
from pathlib import Path

_PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
HBM_BYTES_PER_S = _PEAKS["hbm_bytes_per_s"]
LANE_OPS_PER_S = _PEAKS["lane_ops_per_s_float32"]

# SASS lengths read with cuobjdump on an NVIDIA H100 80GB HBM3 at 700 W
SASS_EXPF = 10
SASS_LOGF = 26
SASS_LOG1PF = 28
SASS_DIV = 10
SASS_RCP = 10
SASS_SQRTF = 10
SASS_PHILOX = 59
SASS_SINCOSF = 32
SASS_ACCEPT = 76
UNIFORM_OPS = 4  # a uniform from a word: shift, convert, multiply, add


def bound_s(nbytes: float, ops: float) -> float:
    """Seconds: the larger of the bytes' and the instructions' time."""
    return max(nbytes / HBM_BYTES_PER_S, ops / LANE_OPS_PER_S)


def transition_bytes(w: int, d: int, cached: bool) -> int:
    """q in, q' and g' out, per walker u', accept_prob, energy_error (4
    bytes each) and the decision (1); with a cache (kernel B) the cached
    g and u in as well."""
    return 4 * w * d * (4 if cached else 3) + w * (17 if cached else 13)


def draw_ops(d: int) -> float:
    """Per walker: ceil(D / 4) Philox blocks of two Box-Muller pairs, p =
    sd n a dim, the Metropolis draw and the test."""
    pair = 2 * UNIFORM_OPS + SASS_LOGF + SASS_SQRTF + SASS_SINCOSF + 4
    return (-(-d // 4) * (SASS_PHILOX + 2 * pair) + d
            + SASS_ACCEPT + 6 + SASS_EXPF)


def b_ops(w: int, d: int, steps: int, gradient_ops: float) -> float:
    """Kernel B over W walkers: steps + 1 evaluations of the form and 3 D
    more a step, both kinetic energies and their scaling, the draws."""
    return w * ((steps + 1) * (gradient_ops + 3 * d) + 4 * d + 4
                + draw_ops(d))
