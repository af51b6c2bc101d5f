"""ctypes wrapper for the independent C++ cost oracle (native/refcost.cc).

The port's own copy of ``sassy_tpu/refcost.py``: a third, independently
written implementation of the end-cost semantics (the role of the
reference's edlib cross-check, the reference's evals/src/benchsuite/
edlib.rs), used by the port's differential tests and the edlib columns of
``sassy_tpu_torch.evals.bench_suite``.

The source is read, never written: it is compiled with g++ into
``build/sassy_tpu_torch/librefcost_<hash>.so`` (``gxx.build``), never with
``make -C native``, which rewrites the JAX package's
``native/librefcost.so``. Without a compiler ``load`` returns None, and so
do ``end_costs`` and ``edit_distance``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from . import gxx

_ALPHABETS = {"iupac": 0, "dna": 1, "ascii": 2, "ascii_ci": 3}

SOURCE = Path(__file__).resolve().parents[1] / "native" / "refcost.cc"
FLAGS = ("-O2", "-fPIC", "-shared")

_LIBS: dict = {}


def build() -> Path:
    """The library's path, compiled unless this source is built already.
    Raises ``RuntimeError`` when g++ is missing or fails."""
    return gxx.build("librefcost", [SOURCE], FLAGS)


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the shared library; None if unavailable."""
    try:
        path = str(build())
    except (OSError, RuntimeError):
        return None
    lib = _LIBS.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        lib.refcost_end_costs.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int, ctypes.c_float, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.refcost_end_costs.restype = ctypes.c_int
        lib.refcost_edit_distance.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
        ]
        lib.refcost_edit_distance.restype = ctypes.c_int64
        _LIBS[path] = lib
    return lib


def _alphabet_id(profile) -> int:
    name = profile.name
    if name == "ascii" and not getattr(profile, "case_sensitive", True):
        return _ALPHABETS["ascii_ci"]
    return _ALPHABETS[name]


def _u8(seq) -> np.ndarray:
    return np.ascontiguousarray(np.frombuffer(bytes(seq), dtype=np.uint8))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def end_costs(
    profile,
    pattern: bytes | np.ndarray,
    text: bytes | np.ndarray,
    alpha: float | None = None,
    max_overhang: int | None = None,
) -> np.ndarray | None:
    """Independent end-cost row D[m][0..n] over RAW characters (not engine
    codes). None if the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    p, t = _u8(pattern), _u8(text)
    out = np.zeros(len(t) + 1, dtype=np.int64)
    rc = lib.refcost_end_costs(
        _ptr(p), len(p), _ptr(t), len(t), _alphabet_id(profile),
        ctypes.c_float(-1.0 if alpha is None else alpha),
        -1 if max_overhang is None else max_overhang,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    return out


def edit_distance(profile, a: bytes, b: bytes) -> int | None:
    lib = load()
    if lib is None:
        return None
    pa, pb = _u8(a), _u8(b)
    return int(lib.refcost_edit_distance(_ptr(pa), len(pa), _ptr(pb), len(pb),
                                         _alphabet_id(profile)))
