"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with
ctypes (plain C interface; no PyTorch headers, so a build takes seconds).

Every ``.cu`` source is compiled to an object by its own ``nvcc``, all at
once, and the objects are linked into one library. It is built at first
use into ``_build/`` beside the package sources (listed in ``.gitignore``).
Its file name carries a hash of every source, headers included, and of the
flags, so an edited source rebuilds. A missing ``nvcc`` or a failed build
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# compiled (one object each) ...
CU_SOURCES = ("fused_hmc.cu", "leapfrog.cu", "nbody.cu")
# ... and every file the library depends on, for its hash
SOURCES = CU_SOURCES + ("forms.cuh", "philox.cuh")
# --fmad=false: no multiply-add contraction, so the kernels round op by op
# as their plain torch versions do and agree with them to 1e-5 even on
# sensitive trajectories (the banana's valley, the funnel's neck). It costs
# up to a tenth of the kernels' time (tools/fmad_cost.py measures both).
# The flag leaves a named multiply-add alone: nbody.cu, held to a bound and
# not to its plain version's rounding, names its own (fma), and so does the
# Gaussian form's matvec (forms.cuh, fmaf), whose plain version rounds each
# multiply-add once as well.
# -split-compile 0: nvcc optimises a source's kernels on all the host's
# cores; fused_hmc.cu holds some 100 instantiations of kernel B (8 forms,
# the Gaussian's and the logistic form's 3 walker tiles, the 16-byte path or
# not, the count fixed or on the device, with or without the proposal); at
# some 80 it built in 25 s with it against 55 s without, on the 8 cores of
# an H100 host with CUDA 12.9.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--fmad=false",
              "-split-compile", "0")

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_double
# W, D, L, threshold, seed, transition index, walker offset, stream
_TAIL = [_I, _I, _I, _F, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
         _P]
_SIGNATURES = {
    # 13 pointers: q, k, mean, inv_mass, p_std, scalars, 6 outputs, the
    # device step count (or null)
    "pbbi_fused_hmc_diag_quadratic": [_P] * 13 + _TAIL,
    # form id, 3 parameter pointers, parameter count, then 15 pointers:
    # q, u, g, inv_mass, p_std, scalars, 6 outputs, the 2 proposal outputs
    # (or null), the device step count (or null); W, D, L, walker tile and
    # the rest of the tail
    "pbbi_fused_hmc_transition": ([_I] + [_P] * 3 + [_I] + [_P] * 15 + [_I]
                                  + _TAIL),
    # form id, 3 parameter pointers, parameter count, then 10 pointers:
    # q, p, u, g, inv_mass, step, 4 outputs; W, D, L, walker tile, stream
    "pbbi_leapfrog_trajectory": ([_I] + [_P] * 3 + [_I] + [_P] * 10
                                 + [_I, _I, _I, _I, _P]),
    # dtype code, targets x and N, sources x and mass and their count,
    # out, lanes per target, softening, G, stream
    "pbbi_nbody_accelerations": [_I, _P, _I, _P, _P, _I, _P, _I, _D, _D, _P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built")


def _digest(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path(flags=NVCC_FLAGS) -> Path:
    return BUILD_DIR / f"libpbbi_kernels_{_digest(flags)}.so"


def _run_all(cmds) -> None:
    """Run the commands at once; raise with every failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(flags=NVCC_FLAGS) -> Path:
    """Compile the sources with ``flags`` unless this exact build exists;
    return its path."""
    out = library_path(flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    stem = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{stem}.{Path(src).stem}.o" for src in CU_SOURCES]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        _run_all([[nvcc, *flags, "-c", "-o", str(obj), str(CSRC / src)]
                  for src, obj in zip(CU_SOURCES, objs)])
        _run_all([[nvcc, *flags, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library built with ``NVCC_FLAGS``, bound."""
    return bind(build())


def bind(path: Path) -> ctypes.CDLL:
    """Load a built library and set every entry's ctypes signature."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pbbi_error_string.argtypes = [ctypes.c_int]
    lib.pbbi_error_string.restype = ctypes.c_char_p
    return lib
