"""The hand-written CUDA kernels: wrappers beside their plain-torch versions
(the counterpart of the JAX package's ``ops/pallas_kernels.py``).

    A  fused_hmc_diag_quadratic   csrc/fused_hmc.cu  whole HMC transition
    B  fused_hmc_transition       csrc/fused_hmc.cu  whole HMC transition
    D  leapfrog_trajectory        csrc/leapfrog.cu   leapfrog trajectory
    E  nbody_accelerations_tiled  csrc/nbody.cu      N-body accelerations

B and D run the two eight-schools forms (the centred form in D up to
D = 12), the two funnel forms and the Gaussian mixture of up to 2
components one walker a thread up to D = 16, and the N-body form in 2 or 3
space dims up to D = 24, in csrc/thread_layout.cu (:func:`walker_layout`).

Each wrapper takes the plain version for tensors on the CPU and launches
the kernel for CUDA tensors; any other device, a bad dtype, shape or
layout, a failed build or a failed launch raises. ``wrapper.launches``
counts the kernel's launches.

The transition kernels take the leapfrog count ``num_steps`` as an int,
or as an int32 tensor ``[1]`` on q's device together with ``max_steps``:
the kernel then reads the count from device memory and clips it to
``[1, max_steps]``, so a caller that adapts the trajectory length on the
device (ChEES) never reads it back. The plain versions read the tensor on
the host.

The transition kernels' plain versions draw the same Philox bits
(``ops/philox.py``), so for the same seed and transition index they agree
to float rounding. Their shared arguments: ``seed`` (64-bit run seed) and
``counter`` (transition index) key the draws; ``walker_offset`` (0 unless
given) is the global index of q's row 0, the walker word of its draws, so
a process holding rows ``[o, o + W)`` of a sharded ensemble draws what
one launch on the whole ensemble draws for them; ``scalars`` is a float32
tensor ``[3]`` on q's device holding (step size, beta, potential scale);
``p_std`` and ``inv_mass`` are ``[D]``. With ``scale != 1`` forces and H
use ``scale * U`` while the returned (u, g) stay unscaled.

Kernels A and B also take a rung axis: q ``[R, W, D]`` is R independent
ensembles (a parallel-tempering ladder's rungs), ``seed`` a sequence of
their R Philox keys, ``scalars`` ``[R, 3]`` and ``p_std`` ``[R, D]`` each
rung's own, u ``[R, W]`` and g ``[R, W, D]``; ``inv_mass`` and the
potential's parameters are shared, and ``walker_offset`` is each rung's.
Every output gains the axis, and rung r's rows are the bits of the call on
rung r alone. On CUDA the rungs are one launch (``MAX_RUNGS`` at most: a
longer ladder is launched in blocks of that many, each counted); the plain
versions loop over the rungs.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import philox
from ._build import load_library

Tensor = torch.Tensor

# Kernels B and D keep one dim-group of four per lane of a warp.
MAX_GENERIC_DIMS = 128
# Parameter floats a device form may stage in shared memory (128 KiB).
MAX_FORM_FLOATS = 32768
# Kernels B and D with the Gaussian, logistic and linear forms (the tiled
# forms): walkers a lane group may own (the register tile of their
# products, csrc/forms.cuh), and the blocks of 256
# threads that fill the card: 128, all but 4 of an H100's 132 SMs, since
# walker counts are powers of two more often than multiples of 132 (at
# W = 8192, D = 32 tile 2 makes 128 blocks and takes 0.017 ms where tile 1
# with 256 blocks takes 0.025; tools/kernel_sweeps.py).
WALKER_TILES = (1, 2, 4)
TILED_FORMS = ("gaussian", "logistic", "linear")
# the tiled forms over rows of data (csrc/forms.cuh LogisticForm and
# LinearForm: the same shared-memory layout, the same tile chooser)
DATA_FORMS = ("logistic", "linear")
_BLOCK_THREADS = 256
_FILL_BLOCKS = 128
# rows of x a lane of the logistic form takes together (kLogisticRows)
LOGISTIC_ROWS = 4
# Kernels B ("B") and D ("D") run these forms one walker a thread
# (csrc/thread_layout.cu) up to THREAD_LAYOUT_DIMS[form, kernel] dims, T
# lanes a walker (csrc/forms.cuh) above: walker_layout. The centred
# eight-schools form's kernel D stops at 12: at D = 16 it took 0.0710 ms
# against the lane groups' 0.0655 (H100 80GB HBM3 at 700 W,
# tools/kernel_sweeps.py, PERF.md). The N-body form takes the thread layout
# in NBODY_THREAD_SPACE_DIMS space dims only, the mixture with up to
# MIXTURE_THREAD_COMPONENTS components (csrc/forms.cuh kMaxMixture). The
# coin form, separable, stays in the lane groups: one walker a thread was
# 2-41% slower at D = 2, 8 and 16. "thread" and "group" name the two
# layouts.
THREAD_FORMS = ("eight_schools_nc", "eight_schools", "funnel",
                "funnel_model", "nbody", "mixture")
THREAD_LAYOUT_DIMS = {("eight_schools_nc", "B"): 16,
                      ("eight_schools_nc", "D"): 16,
                      ("eight_schools", "B"): 16, ("eight_schools", "D"): 12,
                      ("funnel", "B"): 16, ("funnel", "D"): 16,
                      ("funnel_model", "B"): 16, ("funnel_model", "D"): 16,
                      ("nbody", "B"): 24, ("nbody", "D"): 24,
                      ("mixture", "B"): 16, ("mixture", "D"): 16}
NBODY_THREAD_SPACE_DIMS = (2, 3)
MIXTURE_THREAD_COMPONENTS = 2
LAYOUTS = ("thread", "group")
# All the shared memory a block may have on an H100 (227 KiB).
MAX_SHARED_BYTES = 232448
# device form -> (its id at the C entries, its parameter tensors' names)
# (csrc/forms.cuh with_form). Kernels B and D take every form; a potential
# with ``diag_quadratic`` is routed to kernel A before its form is looked at
# (hmc.variant_for), so B runs "diag" only where A cannot serve: with the
# proposal outputs.
FORM_IDS = {
    "gaussian": (0, ("mean", "precision")),
    "funnel": (1, ("params",)),
    "banana": (2, ("params",)),
    "mixture": (3, ("means", "log_weights", "inv_var")),
    "nbody": (4, ("mass", "consts")),
    "diag": (5, ("k_diag", "mean")),
    "logistic": (6, ("x", "y")),
    "eight_schools_nc": (7, ("y", "sigma", "consts")),
    # the example models' forms (models/device_forms.py): each the model's
    # potential with its normalising constant
    "linear": (8, ("x", "y", "consts")),
    "eight_schools": (9, ("y", "sigma", "consts")),
    "coin": (10, ("a", "b")),
    "funnel_model": (11, ("params", "consts")),
    "diag_model": (12, ("k_diag", "mean", "consts")),
}
_HALF_LOG_2PI = 0.9189385332046727
# Rungs one launch of kernels A and B sweeps at most (csrc/transition.cuh
# kMaxRungs; their keys travel in the launch's parameters)
MAX_RUNGS = 16


def _metropolis(seed: int, counter: int, h0: Tensor, h1: Tensor,
                beta: Tensor, threshold: float, walker_offset: int = 0):
    derr = beta * (h1 - h0)
    derr = torch.where(torch.isfinite(derr), derr, torch.inf)
    divergent = derr > threshold
    log_u = torch.log(philox.accept_uniforms(seed, counter, h0.shape[0],
                                             h0.device, walker_offset))
    accepted = (log_u < -derr) & ~divergent
    accept_prob = torch.where(divergent, 0.0,
                              torch.exp(torch.clamp_max(-derr, 0.0)))
    return derr, accepted, accept_prob


def _momenta(seed: int, counter: int, q: Tensor, p_std: Tensor,
             walker_offset: int = 0) -> Tensor:
    w, d = q.shape
    return p_std * philox.momentum_normals(seed, counter, w, d, q.device,
                                           walker_offset)


def _check_offset(walker_offset: int, num_walkers: int) -> int:
    """The walker words are uint32: rows ``walker_offset ..
    walker_offset + W - 1`` must fit."""
    if not 0 <= walker_offset <= (1 << 32) - num_walkers:
        raise ValueError(f"walker_offset must be in [0, 2^32 - W], got "
                         f"{walker_offset} with W={num_walkers}")
    return int(walker_offset)


def _rungs(seed, q: Tensor, scalars: Tensor, p_std: Tensor,
           **rows: Tensor) -> Optional[list]:
    """None for a call on one ensemble (q ``[W, D]``); for q ``[R, W, D]``
    the R rungs' Philox keys, once ``seed`` is checked to hold R of them,
    ``scalars`` to be ``[R, 3]``, ``p_std`` ``[R, D]`` and each of ``rows``
    (u ``[R, W]``, g ``[R, W, D]``) of its shape."""
    if q.ndim != 3:
        return None
    r, w, d = q.shape
    if min(r, w, d) < 1:
        raise ValueError(f"q must be a non-empty [R, W, D] tensor, got "
                         f"{tuple(q.shape)}")
    n = len(seed) if isinstance(seed, (list, tuple)) else None
    if n != r:
        raise ValueError(f"q of {r} rungs takes a list of {r} Philox keys, "
                         f"one a rung; got {'one key' if n is None else n}")
    want = {"scalars": (r, 3), "p_std": (r, d), "u": (r, w), "g": (r, w, d)}
    for name, t in {"scalars": scalars, "p_std": p_std, **rows}.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} of a call on {r} rungs has shape "
                             f"{tuple(t.shape)}, want {want[name]}")
    return [int(k) for k in seed]


def _stack_rungs(outs) -> tuple:
    """The rungs' output tuples as one tuple with the rung axis first."""
    return tuple(torch.stack(x) for x in zip(*outs))


def _rung_blocks(num_rungs: int):
    """The ``[first, last)`` rungs of each launch: ``MAX_RUNGS`` a
    launch."""
    return [(a, min(a + MAX_RUNGS, num_rungs))
            for a in range(0, num_rungs, MAX_RUNGS)]


def _rung_ptr(x: Tensor, rung: int) -> int:
    """The address of rung ``rung`` of ``x``, whose leading axis is the
    rungs' (a tensor of one ensemble is rung 0)."""
    return x.data_ptr() if rung == 0 else x[rung].data_ptr()


def _key_array(seeds) -> ctypes.Array:
    """The keys as the C entries take them: uint64 words."""
    return (ctypes.c_uint64 * len(seeds))(
        *(k & 0xFFFFFFFFFFFFFFFF for k in seeds))


def _check(q: Tensor, named: dict, shapes: dict) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the kernels take CPU or CUDA tensors, got "
                         f"{q.device}")
    if q.ndim not in (2, 3) or 0 in q.shape:
        raise ValueError(f"q must be a non-empty [W, D] or [R, W, D] "
                         f"tensor, got {tuple(q.shape)}")
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shapes[name]}")


def _outputs(q: Tensor):
    rows = q.shape[:-1]
    return (torch.empty_like(q), torch.empty_like(q),
            torch.empty(rows, dtype=q.dtype, device=q.device),
            torch.empty(rows, dtype=q.dtype, device=q.device),
            torch.empty(rows, dtype=torch.uint8, device=q.device),
            torch.empty(rows, dtype=q.dtype, device=q.device))


def _counted(num_steps, max_steps: Optional[int]) -> bool:
    """Whether the leapfrog count comes as a tensor; a tensor goes with
    ``max_steps``, an int without."""
    counted = isinstance(num_steps, Tensor)
    if counted and (max_steps is None or max_steps < 1):
        raise ValueError("a tensor num_steps needs max_steps >= 1")
    if not counted and max_steps is not None:
        raise ValueError("max_steps goes with a tensor num_steps")
    return counted


def _host_steps(num_steps, max_steps: Optional[int]) -> int:
    """The leapfrog count the plain versions run: an int as it is, a
    one-element tensor read on the host and clipped to ``[1, max_steps]``
    as the kernels clip it."""
    if not _counted(num_steps, max_steps):
        return int(num_steps)
    return min(max(int(num_steps.reshape(()).item()), 1), int(max_steps))


def _device_steps(num_steps, max_steps: Optional[int], q: Tensor):
    """``(pointer to the count or None, the int the kernel is given)`` of a
    launch: ``(None, num_steps)`` for an int, ``(its address, max_steps)``
    for an int32 tensor ``[1]`` on q's device."""
    if not _counted(num_steps, max_steps):
        return None, int(num_steps)
    if (num_steps.dtype != torch.int32 or num_steps.numel() != 1
            or num_steps.device != q.device):
        raise ValueError(
            f"a tensor num_steps must be one int32 on {q.device}, got "
            f"{tuple(num_steps.shape)} {num_steps.dtype} on "
            f"{num_steps.device}")
    return num_steps.data_ptr(), int(max_steps)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = load_library().pbbi_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


# ---------------------------------------------------------------------------
# Kernel A: diagonal-quadratic potentials
# ---------------------------------------------------------------------------


def _trajectory_bf16(trajectory_dtype) -> bool:
    """Whether kernel A runs its drift/kick chain in bfloat16: None or
    float32 keep it in float32, bfloat16 takes it; nothing else."""
    if trajectory_dtype in (None, torch.float32):
        return False
    if trajectory_dtype == torch.bfloat16:
        return True
    raise ValueError(f"trajectory_dtype must be None, torch.float32 or "
                     f"torch.bfloat16, got {trajectory_dtype!r}")


def fused_hmc_diag_quadratic_plain(
    seed: int, counter: int, q: Tensor, *, scalars: Tensor, p_std: Tensor,
    inv_mass: Tensor, k_diag: Tensor, mean: Tensor, num_steps,
    divergence_threshold: float = 1000.0, max_steps: Optional[int] = None,
    walker_offset: int = 0, trajectory_dtype=None,
):
    """One HMC transition for ``U = 0.5 sum_d k_d (q_d - mean_d)^2``.

    Returns ``(q', g', u', accept_prob, accepted, energy_error)``; u and g
    are computed from q (no cached values in), g' is the gradient of the
    selected state.

    ``trajectory_dtype=torch.bfloat16`` runs the drift/kick chain in
    bfloat16, as the TPU kernel's option of that name: q, the momentum
    after the first half kick, k, mean, dt * inv_mass and dt * scale are
    rounded to bfloat16, each operation of the L steps rounds to bfloat16
    (as torch's bfloat16 tensors round it), and the end point comes back
    to float32 for the last half kick. The momentum draw, both
    Hamiltonians and the Metropolis test stay in float32, so the test is
    exact for the map that was simulated.

    On q ``[R, W, D]`` (the rung axis, module docstring) it runs each rung
    in turn with its key, scalars and momentum std.
    """
    seeds = _rungs(seed, q, scalars, p_std)
    if seeds is not None:
        return _stack_rungs(fused_hmc_diag_quadratic_plain(
            key, counter, q[r], scalars=scalars[r], p_std=p_std[r],
            inv_mass=inv_mass, k_diag=k_diag, mean=mean, num_steps=num_steps,
            divergence_threshold=divergence_threshold, max_steps=max_steps,
            walker_offset=walker_offset, trajectory_dtype=trajectory_dtype)
            for r, key in enumerate(seeds))
    bf16 = _trajectory_bf16(trajectory_dtype)
    num_steps = _host_steps(num_steps, max_steps)
    walker_offset = _check_offset(walker_offset, q.shape[0])
    dt, beta, s = scalars[0], scalars[1], scalars[2]
    p0 = _momenta(seed, counter, q, p_std, walker_offset)
    qc0 = q - mean
    u0 = 0.5 * torch.sum(k_diag * qc0 * qc0, dim=1)
    h0 = 0.5 * torch.sum(p0 * p0 * inv_mass, dim=1) + s * u0
    dtim = dt * inv_mass
    ck = dt * s
    p = p0 - (0.5 * ck) * (k_diag * qc0)
    low = torch.bfloat16 if bf16 else q.dtype  # .to(q.dtype): no copy
    kt, mt, dtimt, ckt = (t.to(low) for t in (k_diag, mean, dtim, ck))
    q1, p = q.to(low), p.to(low)
    for _ in range(num_steps):
        q1 = q1 + p * dtimt
        p = p - ckt * (kt * (q1 - mt))
    q1, p = q1.to(q.dtype), p.to(q.dtype)
    qc1 = q1 - mean
    p = p + (0.5 * ck) * (k_diag * qc1)
    u1 = 0.5 * torch.sum(k_diag * qc1 * qc1, dim=1)
    h1 = 0.5 * torch.sum(p * p * inv_mass, dim=1) + s * u1
    derr, accepted, accept_prob = _metropolis(
        seed, counter, h0, h1, beta, divergence_threshold, walker_offset)
    q_sel = torch.where(accepted[:, None], q1, q)
    return (q_sel, k_diag * (q_sel - mean), torch.where(accepted, u1, u0),
            accept_prob, accepted, derr)


def fused_hmc_diag_quadratic(
    seed: int, counter: int, q: Tensor, *, scalars: Tensor, p_std: Tensor,
    inv_mass: Tensor, k_diag: Tensor, mean: Tensor, num_steps,
    divergence_threshold: float = 1000.0, max_steps: Optional[int] = None,
    walker_offset: int = 0, trajectory_dtype=None,
):
    """Kernel A. Replaces ``make_fused_hmc_diag_quadratic``
    (physicsbasedbayesianinference_tpu/ops/pallas_kernels.py:893), its
    ``dynamic_steps`` variant with a tensor ``num_steps`` (module
    docstring) and its ``trajectory_dtype`` (:900; bfloat16 up to D = 128,
    refused above); see :func:`fused_hmc_diag_quadratic_plain` for the
    contract. Any D; up to D = 128 each walker's q' and g' are stored once,
    in 16-byte accesses when D % 4 == 0 and the tensors' storage is 16-byte
    aligned. ``launches_by`` counts the launches by trajectory dtype. On
    q ``[R, W, D]`` it sweeps the R rungs in one launch (module
    docstring)."""
    seeds = _rungs(seed, q, scalars, p_std)
    if q.device.type == "cpu":
        return fused_hmc_diag_quadratic_plain(
            seed, counter, q, scalars=scalars, p_std=p_std,
            inv_mass=inv_mass, k_diag=k_diag, mean=mean,
            num_steps=num_steps, divergence_threshold=divergence_threshold,
            max_steps=max_steps, walker_offset=walker_offset,
            trajectory_dtype=trajectory_dtype)
    bf16 = _trajectory_bf16(trajectory_dtype)
    w, d = q.shape[-2:] if q.ndim in (2, 3) else (0, 0)
    if bf16 and d > MAX_GENERIC_DIMS:
        raise ValueError(f"kernel A takes a bfloat16 trajectory up to "
                         f"D={MAX_GENERIC_DIMS}, got D={d}")
    rung = q.shape[:-2]
    _check(q, {"q": q, "scalars": scalars, "p_std": p_std,
               "inv_mass": inv_mass, "k_diag": k_diag, "mean": mean},
           {"q": tuple(q.shape), "scalars": (*rung, 3), "p_std": (*rung, d),
            "inv_mass": (d,), "k_diag": (d,), "mean": (d,)})
    steps_ptr, steps = _device_steps(num_steps, max_steps, q)
    walker_offset = _check_offset(walker_offset, w)
    seeds = [seed] if seeds is None else seeds
    outs = _outputs(q)
    blocks = _rung_blocks(len(seeds))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = load_library()
        for a, b in blocks:
            at = functools.partial(_rung_ptr, rung=a)
            rc = lib.pbbi_fused_hmc_diag_quadratic(
                at(q), k_diag.data_ptr(), mean.data_ptr(),
                inv_mass.data_ptr(), at(p_std), at(scalars), *map(at, outs),
                steps_ptr, int(bf16), w, d, steps, divergence_threshold,
                b - a, _key_array(seeds[a:b]), counter & 0xFFFFFFFF,
                walker_offset, stream)
            _raise_on(rc, "fused_hmc_diag_quadratic")
    fused_hmc_diag_quadratic.launches += len(blocks)
    fused_hmc_diag_quadratic.launches_by[
        "bfloat16" if bf16 else "float32"] += len(blocks)
    q_out, g_out, u_out, acc, taken, derr = outs
    return q_out, g_out, u_out, acc, taken.view(torch.bool), derr


A_TRAJECTORIES = ("float32", "bfloat16")
fused_hmc_diag_quadratic.launches = 0  # type: ignore[attr-defined]
# the same launches by the dtype of the drift/kick chain
fused_hmc_diag_quadratic.launches_by = dict.fromkeys(  # type: ignore
    A_TRAJECTORIES, 0)


# ---------------------------------------------------------------------------
# Kernel B: potentials with a device form
# ---------------------------------------------------------------------------


def _param_shapes(device_form, d: int):
    """The shapes a form's parameters must have at dimension ``d``, and the
    count (mixture components, bodies) the kernel is told."""
    name, params = device_form
    if name == "gaussian":
        return {"mean": (d,), "precision": (d, d)}, 0
    if name == "diag":
        return {"k_diag": (d,), "mean": (d,)}, 0
    if name in ("funnel", "banana"):
        return {"params": (2,)}, 0
    if name == "mixture":
        k = params[0].shape[0]
        return {"means": (k, d), "log_weights": (k,), "inv_var": (1,)}, k
    if name == "logistic":
        n = params[1].shape[0]
        return {"x": (n, d - 1), "y": (n,)}, n
    if name in ("eight_schools_nc", "eight_schools"):
        j = params[0].shape[0]
        return {"y": (j,), "sigma": (j,), "consts": (1,)}, j
    if name == "linear":
        n = params[1].shape[0]
        return {"x": (n, d - 2), "y": (n,), "consts": (2,)}, n
    if name == "coin":
        return {"a": (d,), "b": (d,)}, 0
    if name == "funnel_model":
        return {"params": (2,), "consts": (1,)}, 0
    if name == "diag_model":
        return {"k_diag": (d,), "mean": (d,), "consts": (1,)}, 0
    n = params[0].shape[0]
    return {"mass": (n,), "consts": (2,)}, n


def logistic_shared_bytes(num_rows: int, num_dims: int,
                          tile: int = 1) -> int:
    """Dynamic shared memory of a block of kernels B and D with the
    logistic or the linear form at walker tile ``tile`` (csrc/forms.cuh
    LogisticForm, LinearForm): x with its column of ones, padded to a
    multiple of a chunk of ``LOGISTIC_ROWS`` T rows of 4 T + 4 floats, y,
    a buffer row of 4 T + 4 floats for each of the block's walkers, and
    each lane group's residual tile of a chunk's rows times ``tile``
    walkers, plus 4 floats."""
    t = threads_per_walker(num_dims)
    chunk = LOGISTIC_ROWS * t
    rows = -(-num_rows // chunk) * chunk
    form = -(-rows * (4 * t + 5) // 4) * 4
    groups = _BLOCK_THREADS // t
    return 4 * (form + groups * tile * (4 * t + 4)
                + groups * (chunk * tile + 4))


def _unsupported(device_form, num_dims: int, kernel: str) -> Optional[str]:
    name, params = device_form
    if name not in FORM_IDS:
        return (f"unknown device form {name!r}; want one of "
                f"{tuple(FORM_IDS)}")
    if len(params) != len(FORM_IDS[name][1]):
        return (f"device form {name!r} takes parameters "
                f"{FORM_IDS[name][1]}, got {len(params)}")
    if not 1 <= num_dims <= MAX_GENERIC_DIMS:
        return (f"the {kernel} takes D <= {MAX_GENERIC_DIMS}, "
                f"got D={num_dims}")
    if name == "banana" and num_dims != 2:
        return f"the banana form takes D=2, got D={num_dims}"
    if name == "nbody" and num_dims % params[0].shape[0]:
        return (f"D={num_dims} is not a multiple of the "
                f"{params[0].shape[0]} bodies")
    if (name in ("eight_schools_nc", "eight_schools")
            and num_dims != params[0].shape[0] + 2):
        return (f"the {name} form of {params[0].shape[0]} groups "
                f"takes D={params[0].shape[0] + 2}, got D={num_dims}")
    if name == "linear" and num_dims < 2:
        return f"the linear form takes D >= 2, got D={num_dims}"
    shapes, _ = _param_shapes(device_form, num_dims)
    floats = sum(math.prod(shape) for shape in shapes.values())
    if floats > MAX_FORM_FLOATS:
        return (f"the {name} form's {floats} parameter floats exceed "
                f"{MAX_FORM_FLOATS} in shared memory")
    if name in DATA_FORMS:
        # at walker tile 1, the least that logistic_tile falls back to
        return _logistic_too_large(params[1].shape[0], num_dims, 1)
    return None


def _logistic_too_large(num_rows: int, num_dims: int,
                        tile: int) -> Optional[str]:
    """Why a block of the logistic form at walker tile ``tile`` does not
    fit in shared memory, or None when it does."""
    need = logistic_shared_bytes(num_rows, num_dims, tile)
    if need <= MAX_SHARED_BYTES:
        return None
    return (f"the data form at N={num_rows}, D={num_dims}, tile {tile} "
            f"needs {need} bytes of shared memory a block, over "
            f"{MAX_SHARED_BYTES}")


def generic_unsupported(device_form, num_dims: int) -> Optional[str]:
    """Why kernel B cannot run ``device_form`` at ``num_dims``, or None
    when it can (the routing test of ``hmc.variant_for``)."""
    return _unsupported(device_form, num_dims, "generic fused kernel")


def leapfrog_unsupported(device_form, num_dims: int) -> Optional[str]:
    """Why kernel D cannot run ``device_form`` at ``num_dims``, or None
    when it can."""
    return _unsupported(device_form, num_dims, "leapfrog kernel")


def threads_per_walker(num_dims: int) -> int:
    """Lanes of a warp that own one walker in kernels B and D: the smallest
    power of two with a dim-group of four for each, at most 32."""
    groups = -(-num_dims // 4)
    t = 1
    while t < groups and t < 32:
        t *= 2
    return t


def walker_tile(num_walkers: int, num_dims: int) -> int:
    """Walkers a lane group owns in kernels B and D with a tiled form:
    the largest of 4, 2, 1 that still leaves ``_FILL_BLOCKS`` blocks, one
    for nearly every SM of the card; 1 where not even that does. A larger
    tile reads each operand (a row of the precision matrix, a row of x)
    once for more walkers, but makes fewer threads."""
    if num_walkers < 1 or num_dims < 1:
        raise ValueError(f"need at least one walker and one dim, got "
                         f"W={num_walkers}, D={num_dims}")
    per_block = _BLOCK_THREADS // threads_per_walker(num_dims)
    for tile in reversed(WALKER_TILES):
        if -(-num_walkers // (per_block * tile)) >= _FILL_BLOCKS:
            return tile
    return 1


def logistic_tile(num_walkers: int, num_rows: int, num_dims: int) -> int:
    """:func:`walker_tile` for the logistic form over ``num_rows`` rows,
    or the largest smaller tile whose block fits in shared memory
    (:func:`logistic_shared_bytes`); 1 where none does, which
    :func:`generic_unsupported` refuses."""
    tile = walker_tile(num_walkers, num_dims)
    while tile > 1 and logistic_shared_bytes(num_rows, num_dims,
                                             tile) > MAX_SHARED_BYTES:
        tile //= 2
    return tile


def walker_layout(form_name: str, num_dims: int, kernel: str,
                  space_dims: Optional[int] = None,
                  components: Optional[int] = None) -> str:
    """The layout kernel ``kernel`` ("B" or "D") runs the form
    ``form_name`` in at ``num_dims``, decided from these alone before any
    launch: "thread" (one walker a thread, csrc/thread_layout.cu) for the
    forms of ``THREAD_FORMS`` up to ``THREAD_LAYOUT_DIMS[form_name,
    kernel]`` dims (the N-body form in ``NBODY_THREAD_SPACE_DIMS`` space
    dims only, ``space_dims`` = D / bodies, which it needs; the mixture
    with at most ``MIXTURE_THREAD_COMPONENTS`` components, ``components``,
    which it needs), "group" (T lanes a walker,
    :func:`threads_per_walker`) for every other form and shape."""
    limit = THREAD_LAYOUT_DIMS.get((form_name, kernel), 0)
    if form_name == "nbody":
        if space_dims is None:
            raise ValueError("the nbody form's layout depends on its space "
                             "dims: pass space_dims")
        if space_dims not in NBODY_THREAD_SPACE_DIMS:
            limit = 0
    if form_name == "mixture":
        if components is None:
            raise ValueError("the mixture form's layout depends on its "
                             "components: pass components")
        if not 1 <= components <= MIXTURE_THREAD_COMPONENTS:
            limit = 0
    return "thread" if 1 <= num_dims <= limit else "group"


def form_layout(device_form, num_dims: int, kernel: str) -> str:
    """:func:`walker_layout` of a device form at ``num_dims`` (the N-body
    form's space dims from its masses, the mixture's components from its
    means)."""
    name, params = device_form
    space = (num_dims // params[0].shape[0] if name == "nbody" else None)
    components = params[0].shape[0] if name == "mixture" else None
    return walker_layout(name, num_dims, kernel, space, components)


def _layout_for(device_form, num_dims: int, kernel: str,
                layout: Optional[str]) -> str:
    """The layout a launch of kernel ``kernel`` takes: :func:`form_layout`'s
    unless the tests' hook forces one; "group" can be forced everywhere,
    "thread" only where the chooser takes it."""
    chosen = form_layout(device_form, num_dims, kernel)
    if layout is None:
        return chosen
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if layout == "thread" and chosen != "thread":
        raise ValueError(
            f"the {device_form[0]!r} form at D={num_dims} has no thread "
            f"layout in kernel {kernel} (THREAD_LAYOUT_DIMS: "
            f"{THREAD_LAYOUT_DIMS})")
    return layout


def _tile_for(device_form, num_walkers: int, num_dims: int,
              tile: Optional[int]) -> int:
    """The walker tile a launch takes: the chooser's unless one is forced;
    only the tiled forms take more than 1."""
    name, params = device_form
    if name not in TILED_FORMS:
        if tile not in (None, 1):
            raise ValueError(f"only the gaussian form, the logistic form and "
                             f"the linear form take a walker tile, got "
                             f"{tile} for {name!r}")
        return 1
    if tile is None:
        if name in DATA_FORMS:
            return logistic_tile(num_walkers, params[1].shape[0], num_dims)
        return walker_tile(num_walkers, num_dims)
    if tile not in WALKER_TILES:
        raise ValueError(f"tile must be one of {WALKER_TILES}, got {tile}")
    why = (_logistic_too_large(params[1].shape[0], num_dims, tile)
           if name in DATA_FORMS else None)
    if why:
        raise ValueError(why)
    return tile


def _diag_vg(k_diag, mean):
    def vg(q):
        qc = q - mean
        return 0.5 * torch.sum(k_diag * qc * qc, dim=1), k_diag * qc
    return vg


def _gaussian_vg(mean, prec):
    """``g_i = fma(d_j, P_ji, g_i)`` for j = 0 .. D-1 with d = q - mean:
    the kernels' matvec, one rounding per multiply-add. The product of two
    float32 values is exact in float64, so rounding the float64 sum to
    float32 differs from a float32 fma only where the float64 sum itself
    rounds onto a float32 tie (a double rounding). Float64 parameters stay
    in float64, rounded op by op."""
    prec64 = prec.double()

    def vg(q):
        d = q - mean
        d64 = d.double()
        g = torch.zeros_like(q)
        for j in range(q.shape[1]):
            g = (d64[:, j:j + 1] * prec64[j] + g.double()).to(q.dtype)
        return 0.5 * torch.sum(d * g, dim=1), g
    return vg


def _fma32(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """``fmaf(a, b, c)`` of float32 tensors (broadcast), rounded once as the
    card's fused multiply-add rounds it: the product is exact in float64,
    the float64 sum is taken to round-to-odd (from its exact error, by
    TwoSum) and then rounded to float32, which with 53 >= 24 + 2 bits gives
    the correctly rounded result with no double rounding."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)  # p + c = s + err exactly
    bits = s.view(torch.int64)
    # an inexact sum whose last bit is even moves one ulp toward p + c (an
    # infinite operand leaves err NaN and the sum as it is)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    inexact = (err != 0) & err.isfinite()
    bits = torch.where(inexact & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float64).to(torch.float32)


def _funnel_vg(fp):
    two_s2, half_dm1 = fp[0], fp[1]

    def vg(q):
        v, x = q[:, :1], q[:, 1:]
        sx = torch.zeros_like(v)
        for i in range(x.shape[1]):
            sx = sx + x[:, i:i + 1] * x[:, i:i + 1]
        ev = torch.exp(-v)
        gv = 2.0 * v / two_s2 + half_dm1 - 0.5 * ev * sx
        u = v * v / two_s2 + half_dm1 * v + 0.5 * ev * sx
        return u[:, 0], torch.cat([gv, ev * x], dim=1)
    return vg


def _banana_vg(ab):
    a, b = ab[0], ab[1]

    def vg(q):
        q0, q1 = q[:, 0], q[:, 1]
        t = q1 - q0 * q0
        g = torch.stack([-2.0 * (a - q0) - 4.0 * b * q0 * t, 2.0 * b * t],
                        dim=1)
        return (a - q0) * (a - q0) + b * (t * t), g
    return vg


def _mixture_vg(means, log_w, inv_var):
    def vg(q):
        d2 = torch.zeros(q.shape[0], means.shape[0], dtype=q.dtype,
                         device=q.device)
        for j in range(q.shape[1]):
            diff = q[:, j:j + 1] - means[:, j]
            d2 = d2 + diff * diff
        comp = log_w - 0.5 * inv_var * d2
        m = torch.amax(comp, dim=1, keepdim=True)
        ex = torch.exp(comp - m)
        s = torch.zeros_like(m)
        num = torch.zeros_like(q)
        for c in range(means.shape[0]):
            s = s + ex[:, c:c + 1]
            num = num + ex[:, c:c + 1] * (q - means[c])
        return -(m[:, 0] + torch.log(s[:, 0])), inv_var * num / s
    return vg


def _sqrt_rn(x: Tensor) -> Tensor:
    """The correctly rounded square root of float32 ``x``, as the card's
    ``sqrtf`` takes it: through float64, whose 53 bits round a float32
    root without a double-rounding error (the CPU's vectorised float32
    ``torch.sqrt`` is off by one ulp for some inputs)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _nbody_vg(mass, consts):
    """Every pair's ``inv = 1 / sqrt(d2 + eps^2)``, ``d2`` summed over the
    space dims in order, then per body the sums over its partners in
    increasing index order (csrc/forms.cuh NbodyForm, in either walker
    layout)."""
    big_g, eps2 = consts[0], consts[1]
    n = mass.shape[0]

    def vg(q):
        w, d = q.shape
        x = q.reshape(w, n, d // n)
        r = x[:, None, :, :] - x[:, :, None, :]  # r[:, i, j] = x_j - x_i
        d2 = torch.zeros(w, n, n, dtype=q.dtype, device=q.device)
        for c in range(d // n):
            d2 = d2 + r[..., c] * r[..., c]
        eye = torch.eye(n, dtype=torch.bool, device=q.device)
        inv = torch.where(eye, 0.0, 1.0 / _sqrt_rn(d2 + eps2))
        inv3 = inv * inv * inv
        acc = torch.zeros_like(x)
        row = torch.zeros(w, n, dtype=q.dtype, device=q.device)
        for j in range(n):
            acc = acc + (mass[j] * inv3[:, :, j])[..., None] * r[:, :, j]
            row = row + mass[j] * inv[:, :, j]
        total = torch.zeros(w, dtype=q.dtype, device=q.device)
        for i in range(n):
            total = total + mass[i] * row[:, i]
        g = -mass[:, None] * (big_g * acc)
        return -0.5 * big_g * total, g.reshape(w, d)
    return vg


def _segment_sum(lanes: Tensor) -> Tensor:
    """The kernels' sum over a walker's T lanes, ``lanes`` ``[W, T]`` (T a
    power of two): an xor butterfly, offsets T/2 .. 1. Contiguous, as the
    kernels take a cached u."""
    idx = torch.arange(lanes.shape[1], device=lanes.device)
    off = lanes.shape[1] >> 1
    while off:
        lanes = lanes + lanes[:, idx ^ off]
        off >>= 1
    return lanes[:, 0].contiguous()


def _lane_partials(terms: Tensor, t: int) -> Tensor:
    """``terms`` ``[W, K]`` summed as T lanes sum them, lane l taking terms
    l, l + T, ... in turn: ``[W, T]``."""
    w, k = terms.shape
    padded = -(-k // t) * t
    if padded > k:
        terms = torch.cat([terms, terms.new_zeros(w, padded - k)], 1)
    terms = terms.reshape(w, padded // t, t)
    partial = terms.new_zeros(w, t)
    for c in range(terms.shape[1]):
        partial = partial + terms[:, c]
    return partial


def _logistic_vg(x, y):
    """Bayesian logistic regression over ``x`` ``[N, D - 1]``, ``y``
    ``[N]``, q = (w, b), as kernels B and D evaluate it (csrc/forms.cuh
    LogisticForm): ``z_n = fma(x_nk, q_k, z_n)`` over the dims k in index
    order, the gradient's ``acc_k = fma(r_n, x_nk, acc_k)`` over the rows n
    in index order (each multiply-add rounded once, :func:`_fma32`), and
    the value's likelihood terms summed as the walker's T lanes take the rows
    (lane l: rows l, l + T, ...). Neither the walker tile nor the row tile
    changes an order."""
    n = y.shape[0]

    def vg(q):
        w, d = q.shape
        t = threads_per_walker(d)
        xa = torch.cat([x, x.new_ones(n, 1)], dim=1)  # b's column of ones
        z = q.new_zeros(w, n)
        for k in range(d):
            z = _fma32(xa[:, k], q[:, k:k + 1], z)
        r = 1.0 / (1.0 + torch.exp(-z)) - y
        acc = torch.zeros_like(q)
        for i in range(n):
            acc = _fma32(r[:, i:i + 1], xa[i], acc)
        lik = (torch.clamp_min(z, 0.0)
               + torch.log1p(torch.exp(-torch.abs(z)))) - y * z
        # filled on q's device: no host-to-device copy
        const = torch.full((), _HALF_LOG_2PI, dtype=q.dtype,
                           device=q.device) * float(d)
        u = (0.5 * _dim_sum(q * q, t)
             + _segment_sum(_lane_partials(lik, t))) + const
        return u, q + acc
    return vg


def _eight_schools_vg(y, sigma, consts):
    """Non-centred eight schools, q = (mu, log tau, theta [J]), as kernels B
    and D evaluate it in both layouts (csrc/forms.cuh EightSchoolsForm):
    the reciprocals ``r = 1 / sigma`` taken once, each school's terms as
    products with them, the J terms in index order, and 1 / 25, 1 / 50
    and 1 / 5 as products by their float32 roundings."""
    j = y.shape[0]
    r = 1.0 / sigma

    def vg(q):
        mu, lt, th = q[:, 0], q[:, 1], q[:, 2:]
        tau = torch.exp(lt)
        s1, s2, st, sz = (torch.zeros_like(mu) for _ in range(4))
        es = []
        for i in range(j):
            z = (y[i] - (mu + tau * th[:, i])) * r[i]
            e = z * r[i]
            s1 = s1 + e
            s2 = s2 + e * th[:, i]
            st = st + th[:, i] * th[:, i]
            sz = sz + z * z
            es.append(e)
        t = tau * 0.2
        g = torch.cat([
            (mu * 0.04 - s1)[:, None],
            (((2.0 * (t * t)) / (1.0 + t * t) - 1.0) - tau * s2)[:, None],
            th - tau[:, None] * torch.stack(es, dim=1)], dim=1)
        u = (((((mu * mu) * 0.02 + torch.log1p(t * t)) - lt) + 0.5 * st)
             + 0.5 * sz + consts[0])
        return u, g
    return vg


def _dim_sum(terms: Tensor, t: int) -> Tensor:
    """``terms`` ``[W, D]`` summed over the dims as a walker's T lanes sum
    them: lane l adds its dims 4 l .. 4 l + 3 in order, then the
    butterfly."""
    w, d = terms.shape
    t4 = torch.cat([terms, terms.new_zeros(w, 4 * t - d)],
                   1).reshape(w, t, 4)
    part = terms.new_zeros(w, t)
    for e in range(4):
        part = part + t4[:, :, e]
    return _segment_sum(part)


def _linear_vg(x, y, consts):
    """Bayesian linear regression over ``x`` ``[N, D - 2]``, ``y`` ``[N]``,
    q = (w, b, log noise), as kernels B and D evaluate it (csrc/forms.cuh
    LinearForm): z as :func:`_logistic_vg` takes it over the columns of x,
    a column of ones and one of zeros (s = log noise adds nothing to z),
    the residuals ``r = z - y``, the gradient's ``acc_k = fma(r_n e^-2s,
    x_nk, acc_k)`` over the rows in index order, and the sums of ``r^2``
    (the value's and the noise scale's gradient's) as the walker's T lanes
    take the rows. ``consts`` = (1 / prior_scale^2, the normalising
    constant)."""
    n = y.shape[0]
    ip, const = consts[0], consts[1]

    def vg(q):
        w, d = q.shape
        t = threads_per_walker(d)
        xa = torch.cat([x, x.new_ones(n, 1), x.new_zeros(n, 1)], dim=1)
        z = q.new_zeros(w, n)
        for k in range(d):
            z = _fma32(xa[:, k], q[:, k:k + 1], z)
        s = q[:, d - 1]
        iv, sig2 = torch.exp(-2.0 * s), torch.exp(2.0 * s)
        r = z - y
        e = r * iv[:, None]
        acc = torch.zeros_like(q)
        for i in range(n):
            acc = _fma32(e[:, i:i + 1], xa[i], acc)
        s2 = _segment_sum(_lane_partials(r * r, t))
        g = q * ip + acc
        g[:, d - 1] = ((sig2 - 1.0) + float(n)) - iv * s2
        wb = torch.cat([q[:, :d - 1], q.new_zeros(w, 1)], 1)
        u = (((((0.5 * ip) * _dim_sum(wb * wb, t) + 0.5 * sig2) - s)
              + float(n) * s) + (0.5 * iv) * s2) + const
        return u, g
    return vg


def _eight_schools_centred_vg(y, sigma, consts):
    """Centred eight schools, q = (mu, log tau, theta [J]), as kernels B and
    D evaluate it in both layouts (csrc/forms.cuh
    EightSchoolsCentredForm): ``r = 1 / sigma`` taken once, 1 / tau as
    ``exp(-log tau)``, each school's terms as products with them, the J
    terms in index order, 1 / 25, 1 / 50 and 1 / 5 as products."""
    j = y.shape[0]
    r = 1.0 / sigma

    def vg(q):
        mu, lt, th = q[:, 0], q[:, 1], q[:, 2:]
        tau, itau = torch.exp(lt), torch.exp(-lt)
        s1, s2, sz = (torch.zeros_like(mu) for _ in range(3))
        gt = []
        for i in range(j):
            z = (th[:, i] - mu) * itau
            o = (y[i] - th[:, i]) * r[i]
            s1 = s1 + z
            s2 = s2 + z * z
            sz = sz + o * o
            gt.append(z * itau - o * r[i])
        t = tau * 0.2
        g = torch.cat([
            (mu * 0.04 - s1 * itau)[:, None],
            ((((2.0 * (t * t)) / (1.0 + t * t) - 1.0) + float(j))
             - s2)[:, None],
            torch.stack(gt, dim=1)], dim=1)
        u = ((((((mu * mu) * 0.02 + torch.log1p(t * t)) - lt)
               + float(j) * lt) + 0.5 * s2) + 0.5 * sz) + consts[0]
        return u, g
    return vg


def _coin_vg(a, b):
    """Independent coins with flat priors on logit scale, ``U = sum_k a_k
    softplus(-x_k) + b_k softplus(x_k)`` with a = heads + 1, b = tails +
    1, as kernels B and D take it (csrc/forms.cuh CoinForm): one ``e =
    exp(-|x|)`` a dim, the gradient ``(b - a e) / (1 + e)`` for x >= 0 and
    ``(b e - a) / (1 + e)`` below, the term ``(a + b) log1p(e) + a max(-x,
    0) + b max(x, 0)``, the terms summed as the lanes take them."""
    def vg(q):
        e = torch.exp(-torch.abs(q))
        g = torch.where(q >= 0.0, b - a * e, b * e - a) / (1.0 + e)
        terms = (((a + b) * torch.log1p(e) + a * torch.clamp_min(-q, 0.0))
                 + b * torch.clamp_min(q, 0.0))
        return _dim_sum(terms, threads_per_walker(q.shape[1])), g
    return vg


def _funnel_model_vg(fp, consts):
    """The funnel form plus a constant: the funnel model of the DSL."""
    funnel = _funnel_vg(fp)

    def vg(q):
        u, g = funnel(q)
        return u + consts[0], g
    return vg


def _diag_model_vg(k_diag, mean, consts):
    """The diagonal form plus a constant (the funnel model under
    reparam="auto"); the value's sum over dims as kernel B's lanes take
    it."""
    def vg(q):
        qc = q - mean
        u = 0.5 * _dim_sum(k_diag * qc * qc, threads_per_walker(q.shape[1]))
        return u + consts[0], k_diag * qc
    return vg


_PLAIN_FORMS = {"gaussian": _gaussian_vg, "funnel": _funnel_vg,
                "banana": _banana_vg, "mixture": _mixture_vg,
                "nbody": _nbody_vg, "diag": _diag_vg,
                "logistic": _logistic_vg,
                "eight_schools_nc": _eight_schools_vg,
                "linear": _linear_vg,
                "eight_schools": _eight_schools_centred_vg,
                "coin": _coin_vg, "funnel_model": _funnel_model_vg,
                "diag_model": _diag_model_vg}


def device_value_and_grad(device_form):
    """Plain-torch ``q:[W, D] -> (U, grad)`` of a device form: the function
    kernels B and D evaluate, with their sums over dimensions, components
    and bodies taken in index order as the kernels take them."""
    name, params = device_form
    if name not in _PLAIN_FORMS:
        raise ValueError(f"unknown device form {name!r}; want one of "
                         f"{tuple(FORM_IDS)}")
    return _PLAIN_FORMS[name](*params)


def fused_hmc_transition_plain(
    device_form, seed: int, counter: int, q: Tensor, u: Tensor, g: Tensor,
    *, scalars: Tensor, p_std: Tensor, inv_mass: Tensor, num_steps,
    divergence_threshold: float = 1000.0, max_steps: Optional[int] = None,
    emit_proposal: bool = False, walker_offset: int = 0,
):
    """One HMC transition for the potential named by ``device_form``, from
    cached unscaled ``(u, g)``. Returns ``(q', u', g', accept_prob,
    accepted, energy_error)`` and, with ``emit_proposal``, the trajectory's
    endpoint with its momentum flipped, ``(q1, -p1)``, for every walker
    whatever its decision. On q ``[R, W, D]`` (the rung axis, module
    docstring) it runs each rung in turn with its key, scalars and momentum
    std."""
    seeds = _rungs(seed, q, scalars, p_std, u=u, g=g)
    if seeds is not None:
        return _stack_rungs(fused_hmc_transition_plain(
            device_form, key, counter, q[r], u[r], g[r], scalars=scalars[r],
            p_std=p_std[r], inv_mass=inv_mass, num_steps=num_steps,
            divergence_threshold=divergence_threshold, max_steps=max_steps,
            emit_proposal=emit_proposal, walker_offset=walker_offset)
            for r, key in enumerate(seeds))
    num_steps = _host_steps(num_steps, max_steps)
    walker_offset = _check_offset(walker_offset, q.shape[0])
    vg = device_value_and_grad(device_form)
    dt, beta, s = scalars[0], scalars[1], scalars[2]
    p0 = _momenta(seed, counter, q, p_std, walker_offset)
    h0 = 0.5 * torch.sum(p0 * p0 * inv_mass, dim=1) + s * u
    dtim = dt * inv_mass
    ck = dt * s
    p = p0 - (0.5 * ck) * g
    q1, u1, g1 = q, u, g
    for _ in range(num_steps):
        q1 = q1 + p * dtim
        u1, g1 = vg(q1)
        p = p - ck * g1
    p = p + (0.5 * ck) * g1
    h1 = 0.5 * torch.sum(p * p * inv_mass, dim=1) + s * u1
    derr, accepted, accept_prob = _metropolis(
        seed, counter, h0, h1, beta, divergence_threshold, walker_offset)
    sel = accepted[:, None]
    out = (torch.where(sel, q1, q), torch.where(accepted, u1, u),
           torch.where(sel, g1, g), accept_prob, accepted, derr)
    return out + (q1, -p) if emit_proposal else out


def fused_hmc_transition(
    device_form, seed: int, counter: int, q: Tensor, u: Tensor, g: Tensor,
    *, scalars: Tensor, p_std: Tensor, inv_mass: Tensor, num_steps,
    divergence_threshold: float = 1000.0, tile: Optional[int] = None,
    max_steps: Optional[int] = None, emit_proposal: bool = False,
    walker_offset: int = 0, _layout: Optional[str] = None,
):
    """Kernel B. Replaces ``make_fused_hmc_transition``
    (physicsbasedbayesianinference_tpu/ops/pallas_kernels.py:373) and, as
    one layout serves every D here, its walker-packed variant
    ``make_fused_hmc_packed`` (:576), with their ``dynamic_steps`` (a
    tensor ``num_steps``, module docstring) and ``emit_proposal``; see
    :func:`fused_hmc_transition_plain` and :func:`generic_unsupported` for
    what it takes. ``tile`` forces a tiled form's walker tile
    (:func:`walker_tile` or :func:`logistic_tile` of the shape unless
    given); the result does not depend on it. The walker layout is
    :func:`walker_layout`'s; ``_layout``, a hook for the tests and the
    tools, forces one, and the two layouts give the same bits.
    ``launches_by`` counts the launches by variant, ``launches_by_layout``
    by layout. On q ``[R, W, D]`` it sweeps the R rungs in one launch of
    either layout (module docstring)."""
    seeds = _rungs(seed, q, scalars, p_std, u=u, g=g)
    if q.device.type == "cpu":
        if tile is not None:
            _tile_for(device_form, *q.shape[-2:], tile)
        if _layout is not None:
            _layout_for(device_form, q.shape[-1], "B", _layout)
        return fused_hmc_transition_plain(
            device_form, seed, counter, q, u, g, scalars=scalars,
            p_std=p_std, inv_mass=inv_mass, num_steps=num_steps,
            divergence_threshold=divergence_threshold, max_steps=max_steps,
            emit_proposal=emit_proposal, walker_offset=walker_offset)
    name, params = device_form
    w, d = q.shape[-2:] if q.ndim in (2, 3) else (0, 0)
    why = generic_unsupported(device_form, d)
    if why is not None:
        raise ValueError(why)
    form_id, names = FORM_IDS[name]
    shapes, count = _param_shapes(device_form, d)
    named = dict(zip(names, params))
    rung = q.shape[:-2]
    _check(q, {"q": q, "u": u, "g": g, **named, "scalars": scalars,
               "p_std": p_std, "inv_mass": inv_mass},
           {"q": (*rung, w, d), "u": (*rung, w), "g": (*rung, w, d),
            **shapes, "scalars": (*rung, 3), "p_std": (*rung, d),
            "inv_mass": (d,)})
    tile = _tile_for(device_form, w, d, tile)
    layout = _layout_for(device_form, d, "B", _layout)
    steps_ptr, steps = _device_steps(num_steps, max_steps, q)
    walker_offset = _check_offset(walker_offset, w)
    seeds = [seed] if seeds is None else seeds
    param_ptrs = [t.data_ptr() for t in params]
    param_ptrs += [None] * (3 - len(param_ptrs))
    q_out, g_out, u_out, acc, taken, derr = _outputs(q)
    proposal = ((torch.empty_like(q), torch.empty_like(q)) if emit_proposal
                else ())
    blocks = _rung_blocks(len(seeds))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = load_library()
        entry = (lib.pbbi_fused_hmc_transition_threads if layout == "thread"
                 else lib.pbbi_fused_hmc_transition)
        for a, b in blocks:
            at = functools.partial(_rung_ptr, rung=a)
            rc = entry(
                form_id, *param_ptrs, count, at(q), at(u), at(g),
                inv_mass.data_ptr(), at(p_std), at(scalars),
                *map(at, (q_out, u_out, g_out, acc, taken, derr)),
                *(map(at, proposal) if proposal else (None, None)),
                steps_ptr, w, d, steps, tile, divergence_threshold, b - a,
                _key_array(seeds[a:b]), counter & 0xFFFFFFFF, walker_offset,
                stream)
            _raise_on(rc, f"fused_hmc_transition[{name}]")
    fused_hmc_transition.launches += len(blocks)
    fused_hmc_transition.launches_by[
        _variant_name(steps_ptr is not None, emit_proposal)] += len(blocks)
    fused_hmc_transition.launches_by_layout[layout] += len(blocks)
    return (q_out, u_out, g_out, acc, taken.view(torch.bool), derr,
            *proposal)


def _variant_name(counted: bool, proposal: bool) -> str:
    return (("counted" if counted else "fixed")
            + ("+proposal" if proposal else ""))


B_VARIANTS = tuple(_variant_name(c, p) for c in (False, True)
                   for p in (False, True))
fused_hmc_transition.launches = 0  # type: ignore[attr-defined]
# the same launches by the kernel's variant: the count fixed or read from
# device memory, with or without the proposal outputs
fused_hmc_transition.launches_by = dict.fromkeys(  # type: ignore
    B_VARIANTS, 0)
# the same launches by walker layout
fused_hmc_transition.launches_by_layout = dict.fromkeys(  # type: ignore
    LAYOUTS, 0)


# ---------------------------------------------------------------------------
# Kernel D: the leapfrog trajectory alone
# ---------------------------------------------------------------------------


def leapfrog_trajectory_plain(
    device_form, q: Tensor, p: Tensor, *, step_size, num_steps: int,
    inv_mass, grad: Optional[Tensor] = None,
    potential_energy: Optional[Tensor] = None,
):
    """``num_steps`` kick-drift-kick steps of every walker under the
    potential named by ``device_form``; returns ``(q', p', u', g')``.

    Each step is ``p -= dt/2 g; q += dt p inv_mass; (u, g) at q; p -= dt/2
    g``, as the TPU kernel's loop. The cached ``(potential_energy, grad)``
    at q is used when both are given; otherwise g is evaluated at q."""
    vg = device_value_and_grad(device_form)
    dt = step_size
    if grad is None or potential_energy is None:
        u, g = vg(q)
    else:
        u, g = potential_energy, grad
    for _ in range(num_steps):
        p = p - (0.5 * dt) * g
        q = q + dt * p * inv_mass
        u, g = vg(q)
        p = p - (0.5 * dt) * g
    return q, p, u, g


def leapfrog_trajectory(
    device_form, q: Tensor, p: Tensor, *, step_size: Tensor, num_steps: int,
    inv_mass: Tensor, grad: Optional[Tensor] = None,
    potential_energy: Optional[Tensor] = None, tile: Optional[int] = None,
    _layout: Optional[str] = None,
):
    """Kernel D. Replaces ``make_pallas_leapfrog``
    (physicsbasedbayesianinference_tpu/ops/pallas_kernels.py:140); see
    :func:`leapfrog_trajectory_plain` for the contract and
    :func:`leapfrog_unsupported` for the forms and shapes it takes.

    On CUDA: float32 ``q``, ``p`` ``[W, D]``, ``step_size`` a one-element
    float32 tensor on the device (read there, never on the host),
    ``inv_mass`` ``[D]``. Uses the cached ``(potential_energy, grad)``
    when given (both or neither), where the TPU kernel recomputed them at
    q; u' is the form's value at the final q. ``tile`` forces a tiled
    form's walker tile and ``_layout`` the walker layout, as in
    :func:`fused_hmc_transition`; ``launches_by_layout`` counts the
    launches by layout."""
    if q.device.type == "cpu":
        if tile is not None:
            _tile_for(device_form, *q.shape, tile)
        if _layout is not None:
            _layout_for(device_form, q.shape[-1], "D", _layout)
        return leapfrog_trajectory_plain(
            device_form, q, p, step_size=step_size, num_steps=num_steps,
            inv_mass=inv_mass, grad=grad, potential_energy=potential_energy)
    name, params = device_form
    w, d = q.shape if q.ndim == 2 else (0, 0)
    why = leapfrog_unsupported(device_form, d)
    if why is not None:
        raise ValueError(why)
    cached = grad is not None
    if cached != (potential_energy is not None):
        raise ValueError("pass grad and potential_energy together, or "
                         "neither")
    if not isinstance(step_size, Tensor) or step_size.numel() != 1:
        raise ValueError("kernel D takes one step size, as a one-element "
                         "tensor on the device")
    step = step_size.reshape(1)
    form_id, names = FORM_IDS[name]
    shapes, count = _param_shapes(device_form, d)
    named = {"q": q, "p": p, **dict(zip(names, params)), "step": step,
             "inv_mass": inv_mass}
    shapes.update(q=(w, d), p=(w, d), step=(1,), inv_mass=(d,))
    if cached:
        named.update(u=potential_energy, g=grad)
        shapes.update(u=(w,), g=(w, d))
    _check(q, named, shapes)
    tile = _tile_for(device_form, w, d, tile)
    layout = _layout_for(device_form, d, "D", _layout)
    param_ptrs = [t.data_ptr() for t in params]
    param_ptrs += [None] * (3 - len(param_ptrs))
    q_out, p_out, g_out = (torch.empty_like(q) for _ in range(3))
    u_out = torch.empty(w, dtype=q.dtype, device=q.device)
    cache_ptrs = ((potential_energy.data_ptr(), grad.data_ptr()) if cached
                  else (None, None))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = load_library()
        entry = (lib.pbbi_leapfrog_trajectory_threads if layout == "thread"
                 else lib.pbbi_leapfrog_trajectory)
        rc = entry(
            form_id, *param_ptrs, count, q.data_ptr(), p.data_ptr(),
            *cache_ptrs,
            *map(Tensor.data_ptr, (inv_mass, step, q_out, p_out, u_out,
                                   g_out)),
            w, d, num_steps, tile, stream)
    _raise_on(rc, f"leapfrog_trajectory[{name}]")
    leapfrog_trajectory.launches += 1
    leapfrog_trajectory.launches_by_layout[layout] += 1
    return q_out, p_out, u_out, g_out


leapfrog_trajectory.launches = 0  # type: ignore[attr-defined]
leapfrog_trajectory.launches_by_layout = dict.fromkeys(  # type: ignore
    LAYOUTS, 0)


# ---------------------------------------------------------------------------
# Kernel E: all-pairs gravitational accelerations
# ---------------------------------------------------------------------------

# float elements of one [rows, N] pair block of the plain version (64 MiB
# in float32 per temporary)
_PLAIN_PAIR_BLOCK = 1 << 24
_NBODY_DTYPES = {torch.float32: 0, torch.float64: 1}
# kernel E's layout (csrc/nbody.cu): partial sums a lane keeps, the most
# lanes that share a target, and the threads that fill an H100 to half its
# 132 x 2048 (2^17, so that N = 16384 takes 8 lanes)
_NBODY_UNROLL = 4
_NBODY_MAX_SPLIT = 32
_NBODY_FILL_THREADS = 1 << 17
# Kernel E against its plain version, per body and component:
#     |a_kernel - a_plain| <= (NBODY_BOUND_C sqrt(N) + NBODY_BOUND_TERM) u S_i
# (see nbody_abs_sum).
NBODY_BOUND_C = 4.0
NBODY_BOUND_TERM = 8.0


def nbody_bound(x: Tensor, mass: Tensor, *, g_const: float,
                softening: float) -> Tensor:
    """The bound above for these bodies, ``[N]`` in float64."""
    n = x.shape[0]
    u = torch.finfo(x.dtype).eps / 2
    return (NBODY_BOUND_C * n**0.5 + NBODY_BOUND_TERM) * u * nbody_abs_sum(
        x, mass, g_const=g_const, softening=softening)


def nbody_split(n: int) -> int:
    """Lanes of a warp that share one target body in kernel E at ``n``
    bodies: the smallest power of two in 1..32 with ``n * split`` threads
    enough to fill the card (32 up to N = 4096, 8 at N = 16384, 1 from
    N = 2^17 on)."""
    if n < 1:
        raise ValueError(f"need at least one body, got {n}")
    split = 1
    while split < _NBODY_MAX_SPLIT and n * split < _NBODY_FILL_THREADS:
        split *= 2
    return split


def _check_split(split: int) -> int:
    if not (1 <= split <= _NBODY_MAX_SPLIT and split & (split - 1) == 0):
        raise ValueError(f"split must be a power of two in 1.."
                         f"{_NBODY_MAX_SPLIT}, got {split}")
    return split


def _sum_in_kernel_order(terms: Tensor, split: int) -> Tensor:
    """Sum ``terms`` ``[rows, N, 3]`` over the sources as kernel E does at
    ``split`` lanes per target: lane s, partial sum u takes the sources
    s + split * u + 4 * split * i for i = 0, 1, ... in turn (whatever the
    tile size, a multiple of 4 * split); the 4 partial sums are joined left
    to right, and the lanes by an xor butterfly (offsets split/2 .. 1)."""
    rows, n, _ = terms.shape
    stride = _NBODY_UNROLL * split
    padded = -(-n // stride) * stride
    if padded > n:
        terms = torch.cat([terms, terms.new_zeros(rows, padded - n, 3)], 1)
    # source j = stride * i + split * u + s
    terms = terms.reshape(rows, padded // stride, _NBODY_UNROLL, split, 3)
    partial = terms.new_zeros(rows, _NBODY_UNROLL, split, 3)
    for i in range(terms.shape[1]):
        partial = partial + terms[:, i]
    lanes = partial[:, 0]
    for u in range(1, _NBODY_UNROLL):
        lanes = lanes + partial[:, u]
    idx = torch.arange(split, device=terms.device)
    off = split >> 1
    while off:
        lanes = lanes + lanes[:, idx ^ off]
        off >>= 1
    return lanes[:, 0]


def nbody_accelerations_tiled_plain(x: Tensor, mass: Optional[Tensor], *,
                                    g_const: float, softening: float,
                                    split: Optional[int] = None,
                                    sources=None) -> Tensor:
    """``a_i = G sum_{j != i} m_j r_ij / (|r_ij|^2 + eps^2)^{3/2}`` with
    ``r_ij = x_j - x_i``, for ``x`` ``[N, 3]``: the pairs of a block of
    target rows at a time, so that N = 16384 fits in memory. Each term is
    rounded op by op with an exact square root and division (kernel E fuses
    its multiply-adds and takes one reciprocal square root). The sum over
    the sources is a torch reduction, or, with ``split``, runs in kernel
    E's order at that many lanes per target (:func:`nbody_split`).

    ``sources=(x_src, m_src)`` (``[N_src, 3]``, ``[N_src]``) are the bodies
    j, and ``mass`` is not read: the accelerations of the targets ``x``
    from a block of sources, the tile of the ring sweep
    (``parallel/ring.py``). No pair is then skipped by its index; a pair at
    r^2 <= 0 has weight zero (the JAX ring's ``_block_accel`` rule, and the
    kernel's), and every other self-pair term is exactly zero, so with the
    targets as sources the result is the one-set result's bits."""
    x_src, m_src = (x, mass) if sources is None else sources
    n_src = x_src.shape[0]
    rows = max(1, _PLAIN_PAIR_BLOCK // n_src)
    soft2 = float(softening) ** 2
    out = torch.empty_like(x)
    cols = torch.arange(n_src, device=x.device)
    if split is not None:
        _check_split(split)
    for start in range(0, x.shape[0], rows):
        stop = min(x.shape[0], start + rows)
        r = x_src[None, :, :] - x[start:stop, None, :]  # r[i, j] = x_j - x_i
        r2 = (r[..., 0] * r[..., 0] + r[..., 1] * r[..., 1]
              + r[..., 2] * r[..., 2] + soft2)
        if sources is None:
            zero = cols[None, :] == torch.arange(
                start, stop, device=x.device)[:, None]
        else:
            zero = r2 <= 0.0
        inv = torch.where(zero, 0.0,
                          1.0 / torch.sqrt(torch.where(zero, 1.0, r2)))
        terms = (m_src[None, :] * (inv * inv * inv))[..., None] * r
        total = (torch.sum(terms, dim=1) if split is None
                 else _sum_in_kernel_order(terms, split))
        out[start:stop] = g_const * total
    return out


def nbody_abs_sum(x: Tensor, mass: Tensor, *, g_const: float,
                  softening: float) -> Tensor:
    """``S_i = |G| sum_{j != i} |m_j| |r_ij| / (|r_ij|^2 + eps^2)^{3/2}``
    in float64, ``[N]``: the sum of the magnitudes of a_i's terms, the
    scale of the tolerance between kernel E and its plain version
    (:func:`nbody_bound`). With u the dtype's unit roundoff, per body and
    component

        |a_kernel - a_plain| <= (C sqrt(N) + K) u S_i,   C = 4, K = 8.

    ``C sqrt(N)``: two summation orders of N terms differ by a random walk
    of roundings, about u sqrt(N) S_i, and C covers the largest of 3N
    components. ``K``: the two sides also round each term differently. The
    kernel fuses the multiply-adds of r^2 (3 roundings where the plain
    version has 5) and takes 1 / r as one reciprocal square root, in
    float32 an approximate one of relative error up to 2.14 u (2^-22.9),
    in float64 one of up to 2 u, against the u + u of an exact square root
    and division; these enter the weight m / r^3 three times over. A term
    that carries most of S_i (a close neighbour, or N = 2) brings that
    difference into a_i whole: over 200 random systems of 2 bodies the
    worst was 7.2 u S_i, over the 5.7 u S_i that C sqrt(N) alone allows
    there (at N = 3: 7.1 against 6.9; from N = 4 on C sqrt(N) alone held at
    every size checked; ``tools/kernel_sweeps.py``). K = 8 is that 7.2
    with a margin; from a few hundred bodies on it is small beside
    C sqrt(N)."""
    x, mass = x.double(), mass.double().abs()
    n = x.shape[0]
    rows = max(1, _PLAIN_PAIR_BLOCK // n)
    soft2 = float(softening) ** 2
    out = torch.empty(n, dtype=torch.float64, device=x.device)
    cols = torch.arange(n, device=x.device)
    for start in range(0, n, rows):
        stop = min(n, start + rows)
        r = x[None, :, :] - x[start:stop, None, :]
        d2 = torch.sum(r * r, dim=-1)
        self_pair = cols[None, :] == torch.arange(
            start, stop, device=x.device)[:, None]
        terms = mass[None, :] * torch.sqrt(d2) / (d2 + soft2) ** 1.5
        out[start:stop] = torch.sum(torch.where(self_pair, 0.0, terms), 1)
    return abs(g_const) * out


def _check_bodies(name: str, x: Tensor, mass: Tensor, like: Tensor) -> None:
    if x.device != like.device or x.dtype != like.dtype or x.ndim != 2 \
            or x.shape[0] < 1 or x.shape[1] != 3:
        raise ValueError(f"{name} must be a non-empty [N, 3] {like.dtype} "
                         f"tensor on {like.device}, got {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    n = x.shape[0]
    if mass is None or mass.device != x.device or mass.dtype != x.dtype or \
            tuple(mass.shape) != (n,):
        raise ValueError(
            f"the masses of {name} must be [{n}] {x.dtype} on {x.device}, "
            f"got " + ("None" if mass is None else
                       f"{tuple(mass.shape)} {mass.dtype} on {mass.device}"))
    if not (x.is_contiguous() and mass.is_contiguous()):
        raise ValueError(f"{name} and its masses must be contiguous")


def nbody_accelerations_tiled(x: Tensor, mass: Optional[Tensor], *,
                              g_const: float, softening: float,
                              split: Optional[int] = None,
                              sources=None) -> Tensor:
    """Kernel E. Replaces ``nbody_accelerations_pallas``
    (physicsbasedbayesianinference_tpu/ops/pallas_kernels.py:252); see
    :func:`nbody_accelerations_tiled_plain` for the contract. ``x``
    ``[N, 3]`` and ``mass`` ``[N]``, contiguous, both float32 or both
    float64; ``softening`` is eps, added as eps^2 to r^2; ``split`` lanes
    share a target (:func:`nbody_split` of N unless given). A body at the
    origin with eps = 0 gets a finite acceleration: a pair at r^2 = 0 has
    weight zero. Two launches on the same input give the same bits.
    ``sources=(x_src, m_src)``: the source-block form, the targets ``x``
    pulled by those bodies (``mass`` is not read and may be None); with the
    targets as sources it gives the one-set launch's bits.
    ``launches_by`` counts the launches of each form."""
    if x.device.type == "cpu":
        return nbody_accelerations_tiled_plain(
            x, mass, g_const=g_const, softening=softening, split=split,
            sources=sources)
    if x.device.type != "cuda":
        raise ValueError(f"kernel E takes CPU or CUDA tensors, got "
                         f"{x.device}")
    if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] != 3:
        raise ValueError(f"x must be a non-empty [N, 3] tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _NBODY_DTYPES:
        raise ValueError(f"kernel E takes float32 or float64, got "
                         f"{x.dtype}")
    n = x.shape[0]
    if sources is None:
        _check_bodies("x", x, mass, x)
        x_src, m_src = x, mass
    else:
        x_src, m_src = sources
        _check_bodies("x_src", x_src, m_src, x)
    split = nbody_split(n) if split is None else _check_split(split)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = load_library().pbbi_nbody_accelerations(
            _NBODY_DTYPES[x.dtype], x.data_ptr(), n, x_src.data_ptr(),
            m_src.data_ptr(), x_src.shape[0], out.data_ptr(), split,
            float(softening), float(g_const), stream)
    _raise_on(rc, "nbody_accelerations_tiled")
    nbody_accelerations_tiled.launches += 1
    nbody_accelerations_tiled.launches_by[
        "one_set" if sources is None else "source_block"] += 1
    return out


E_FORMS = ("one_set", "source_block")
nbody_accelerations_tiled.launches = 0  # type: ignore[attr-defined]
# the same launches by form: the bodies as their own sources, or a block
# of sources beside the targets
nbody_accelerations_tiled.launches_by = dict.fromkeys(  # type: ignore
    E_FORMS, 0)


KERNELS = (fused_hmc_diag_quadratic, fused_hmc_transition,
           leapfrog_trajectory, nbody_accelerations_tiled)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    fused_hmc_diag_quadratic.launches_by = dict.fromkeys(A_TRAJECTORIES, 0)
    fused_hmc_transition.launches_by = dict.fromkeys(B_VARIANTS, 0)
    fused_hmc_transition.launches_by_layout = dict.fromkeys(LAYOUTS, 0)
    leapfrog_trajectory.launches_by_layout = dict.fromkeys(LAYOUTS, 0)
    nbody_accelerations_tiled.launches_by = dict.fromkeys(E_FORMS, 0)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
