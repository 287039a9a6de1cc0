"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with
ctypes (plain C interface; no PyTorch headers, so a build takes seconds).

The library is built at first use into ``_build/`` beside the package
sources (listed in ``.gitignore``). Its file name carries a hash of the
sources and flags, so an edited source rebuilds. A missing ``nvcc`` or a
failed build raises; there is no fallback.
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
SOURCES = ("fused_hmc.cu", "philox.cuh")
# --fmad=false: no multiply-add contraction, so the kernels round op by op
# as their plain torch versions do and agree with them to 1e-5 even on
# sensitive trajectories (the banana's valley, the funnel's neck). It costs
# up to a tenth of the kernels' time (tools/fmad_cost.py measures both).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_I, _I, _I, _F, ctypes.c_uint64, ctypes.c_uint32, _P]
_SIGNATURES = {
    # 12 pointers: q, k, mean, inv_mass, p_std, scalars, then 6 outputs
    "pbbi_fused_hmc_diag_quadratic": [_P] * 12 + _TAIL,
    # form id, 3 parameter pointers, parameter count, then 12 pointers:
    # q, u, g, inv_mass, p_std, scalars, 6 outputs
    "pbbi_fused_hmc_transition": [_I] + [_P] * 3 + [_I] + [_P] * 12 + _TAIL,
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
        "fused CUDA kernels cannot be built")


def _digest(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path(flags=NVCC_FLAGS) -> Path:
    return BUILD_DIR / f"libpbbi_fused_{_digest(flags)}.so"


def build(flags=NVCC_FLAGS) -> Path:
    """Compile the sources with ``flags`` unless this exact build exists;
    return its path."""
    out = library_path(flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *flags, "-o", str(tmp),
           str(CSRC / "fused_hmc.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
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
