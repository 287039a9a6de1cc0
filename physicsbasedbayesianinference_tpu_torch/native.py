"""Host-side IO (port of the JAX package's ``native.py``): the parser of
the reference's N-body initial-condition text, and the streaming sample
store (:class:`SampleSink`, :func:`read_samples`).

``csrc/pbbi_io.cpp`` at the repository root (shared with the JAX package,
unchanged) is compiled at first use with the system C++ compiler into this
package's ``_build/`` directory (listed in ``.gitignore``) and loaded with
ctypes. On a host without a C++ compiler a numpy tokenizer parses the same
format and a numpy writer writes the same sample files. None of it is a
device kernel.

The sample file is the JAX package's: a 32-byte header of eight uint32
(magic ``0x50424249``, version 1, walkers, dims, rows as two 32-bit
halves, two zeros), then ``[rows, dims]`` float32, so a file written by
either package reads back bitwise in the other.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np
import torch

from .ops._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "pbbi_io.cpp")
_DOUBLES = ctypes.POINTER(ctypes.c_double)
_FLOATS = ctypes.POINTER(ctypes.c_float)
_MAGIC = 0x50424249


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
    lib.pbbi_sink_open.restype = ctypes.c_void_p
    lib.pbbi_sink_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.c_int64]
    lib.pbbi_sink_append.restype = ctypes.c_int64
    lib.pbbi_sink_append.argtypes = [ctypes.c_void_p, _FLOATS,
                                     ctypes.c_int64]
    lib.pbbi_sink_close.restype = ctypes.c_int
    lib.pbbi_sink_close.argtypes = [ctypes.c_void_p]
    lib.pbbi_sink_info.restype = ctypes.c_int64
    lib.pbbi_sink_info.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_int64)]
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


class SampleSink:
    """Append-only float32 sample store: ``append`` a ``[..., num_dims]``
    chunk (a numpy array or a tensor on any device), ``close`` (or leave
    the ``with`` block) to finish the header. The compiled writer when the
    library builds, else the numpy writer."""

    def __init__(self, path: str, num_walkers: int, num_dims: int):
        self.path = path
        self.num_walkers = int(num_walkers)
        self.num_dims = int(num_dims)
        self.num_rows = 0
        self._lib = get_lib()
        self._handle = self._f = None
        if self._lib is not None:
            self._handle = self._lib.pbbi_sink_open(
                path.encode(), self.num_walkers, self.num_dims)
            if not self._handle:
                raise OSError(f"cannot open sink {path}")
        else:
            self._f = open(path, "wb")
            self._write_header()

    def _write_header(self):
        head = np.zeros(8, np.uint32)
        head[:6] = (_MAGIC, 1, self.num_walkers, self.num_dims,
                    self.num_rows & 0xFFFFFFFF, self.num_rows >> 32)
        self._f.seek(0)
        self._f.write(head.tobytes())

    def append(self, chunk) -> int:
        """Append ``chunk`` ``[..., num_dims]``; returns the total rows."""
        if isinstance(chunk, torch.Tensor):  # one copy to the host
            chunk = chunk.detach().cpu().numpy()
        arr = np.ascontiguousarray(
            np.asarray(chunk), dtype=np.float32).reshape(-1, self.num_dims)
        if self._handle is not None:
            rows = self._lib.pbbi_sink_append(
                self._handle, arr.ctypes.data_as(_FLOATS), arr.shape[0])
            if rows < 0:
                raise OSError("sink write failed")
            self.num_rows = rows
        else:
            self._f.seek(0, os.SEEK_END)
            self._f.write(arr.tobytes())
            self.num_rows += arr.shape[0]
        return self.num_rows

    def close(self):
        if self._handle is not None:
            rc = self._lib.pbbi_sink_close(self._handle)
            self._handle = None
            if rc != 0:
                raise OSError("sink close failed")
        elif self._f is not None:
            self._write_header()
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_samples(path: str) -> np.ndarray:
    """A sample file -> ``[num_rows, num_dims]`` float32, memory-mapped."""
    head = np.fromfile(path, dtype=np.uint32, count=8)
    if head.shape[0] < 8 or head[0] != _MAGIC:
        raise ValueError(f"{path} is not a PBBI sample file")
    num_dims = int(head[3])
    num_rows = int(head[4]) | (int(head[5]) << 32)
    return np.memmap(path, dtype=np.float32, mode="r", offset=32,
                     shape=(num_rows, num_dims))
