"""Host-side parsing of the reference's N-body initial-condition text (port
of the JAX package's ``native.py``, its parser only).

The C++ tokenizer ``csrc/pbbi_io.cpp`` at the repository root (shared with
the JAX package, unchanged) is compiled at first use with the system C++
compiler into this package's ``_build/`` directory (listed in
``.gitignore``) and loaded with ctypes. On a host without a C++ compiler
the numpy tokenizer parses the same format. Neither is a device kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

from .ops._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "pbbi_io.cpp")
_DOUBLES = ctypes.POINTER(ctypes.c_double)


def _build() -> Optional[str]:
    """The compiled tokenizer's path (built unless this source's build
    exists), or None where no C++ compiler can build it."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = BUILD_DIR / f"libpbbi_io_{digest}.so"
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    for cc in ("c++", "g++"):
        try:
            subprocess.run([cc, "-O3", "-shared", "-fPIC", _SRC, "-o",
                            str(tmp)], check=True, capture_output=True,
                           timeout=120)
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired):
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
        return str(out)
    tmp.unlink(missing_ok=True)
    return None


@functools.lru_cache(maxsize=None)
def get_lib() -> Optional[ctypes.CDLL]:
    """The bound tokenizer library, or None (the numpy tokenizer runs)."""
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.pbbi_nbody_header.restype = ctypes.c_long
    lib.pbbi_nbody_header.argtypes = [ctypes.c_char_p, _DOUBLES, _DOUBLES]
    lib.pbbi_nbody_parse.restype = ctypes.c_int
    lib.pbbi_nbody_parse.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                     _DOUBLES, _DOUBLES, _DOUBLES]
    return lib


def parse_nbody_text(text: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                         float, float]:
    """Parse the reference IC format -> (mass[N], x[N,3], v[N,3], tmax, dt),
    float64: header ``N tmax dt``, then N masses, N position rows and N
    velocity rows."""
    lib = get_lib()
    if lib is not None:
        raw = text.encode()
        tmax, dt = ctypes.c_double(), ctypes.c_double()
        n = lib.pbbi_nbody_header(raw, ctypes.byref(tmax), ctypes.byref(dt))
        if n < 0:
            raise ValueError("truncated N-body input: missing header")
        mass = np.empty(n, np.float64)
        pos = np.empty((n, 3), np.float64)
        vel = np.empty((n, 3), np.float64)
        rc = lib.pbbi_nbody_parse(raw, n, mass.ctypes.data_as(_DOUBLES),
                                  pos.ctypes.data_as(_DOUBLES),
                                  vel.ctypes.data_as(_DOUBLES))
        if rc != 0:
            raise ValueError(
                f"truncated N-body input: N={n} needs {3 + 7 * n} tokens")
        return mass, pos, vel, tmax.value, dt.value
    tokens = text.split()
    if len(tokens) < 3:
        raise ValueError("truncated N-body input: missing header")
    n = int(tokens[0])
    tmax_f, dt_f = float(tokens[1]), float(tokens[2])
    need = 3 + 7 * n
    if len(tokens) < need:
        raise ValueError(
            f"truncated N-body input: N={n} needs {need} tokens, got "
            f"{len(tokens)}")
    vals = np.asarray(tokens[3:need], dtype=np.float64)
    return (vals[:n], vals[n:4 * n].reshape(n, 3),
            vals[4 * n:].reshape(n, 3), tmax_f, dt_f)
