"""ctypes bridge to the native C++ interior-point QP oracle.

The reference's exact solver is CPLEX (``qpcpp/src/solvers/CPLEX.cpp``),
which is proprietary and absent here. ``native/qp_oracle.cpp`` is the
stand-in: a dense Mehrotra predictor-corrector IPM in float64 that solves
the same box-row QPs to ~1e-9, used to measure the batched solvers' control
deviation (BASELINE.json target: <1e-3) and as a CPU reference in tests.

The shared library is compiled on first use and cached next to the source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[3] / "native"
_SRC = _NATIVE_DIR / "qp_oracle.cpp"
_SO = _NATIVE_DIR / "libqp_oracle.so"

_lib = None


def _build() -> None:
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
           "-o", str(_SO), str(_SRC)]
    subprocess.run(cmd, check=True, capture_output=True)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if (not _SO.exists()) or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _build()
    lib = ctypes.CDLL(str(_SO))
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.qp_solve.restype = ctypes.c_int
    lib.qp_solve.argtypes = [ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp, dp, dp]
    lib.qp_solve_batch.restype = ctypes.c_int
    lib.qp_solve_batch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   dp, dp, dp, dp, dp, dp, ip]
    _lib = lib
    return lib


def _as_c(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def solve_oracle(P, q, A, lb, ub) -> Tuple[np.ndarray, int, np.ndarray]:
    """Solve one QP exactly. Returns (x [n], status, info [iter, mu, res]).

    status: 0 optimal, 1 max-iter, 2 numerical failure.
    """
    lib = _load()
    P = np.ascontiguousarray(P, dtype=np.float64)
    q = np.ascontiguousarray(q, dtype=np.float64)
    A = np.ascontiguousarray(A, dtype=np.float64)
    lb = np.ascontiguousarray(lb, dtype=np.float64)
    ub = np.ascontiguousarray(ub, dtype=np.float64)
    n, m = q.shape[0], lb.shape[0]
    x = np.zeros(n)
    info = np.zeros(3)
    st = lib.qp_solve(n, m, _as_c(P), _as_c(q), _as_c(A), _as_c(lb), _as_c(ub),
                      _as_c(x), _as_c(info))
    return x, int(st), info


def solve_oracle_batch(P, q, A, lb, ub) -> Tuple[np.ndarray, np.ndarray]:
    """Batched exact solve: P [B,n,n], q [B,n], A [B,m,n], lb/ub [B,m].

    Returns (x [B,n], status [B]).
    """
    lib = _load()
    P = np.ascontiguousarray(P, dtype=np.float64)
    q = np.ascontiguousarray(q, dtype=np.float64)
    A = np.ascontiguousarray(A, dtype=np.float64)
    lb = np.ascontiguousarray(lb, dtype=np.float64)
    ub = np.ascontiguousarray(ub, dtype=np.float64)
    B, n = q.shape
    m = lb.shape[1]
    x = np.zeros((B, n))
    status = np.zeros(B, dtype=np.int32)
    lib.qp_solve_batch(B, n, m, _as_c(P), _as_c(q), _as_c(A), _as_c(lb),
                       _as_c(ub), _as_c(x),
                       status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return x, status
