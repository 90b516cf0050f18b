"""Native (C++) host-side components, loaded via ctypes.

A copy of ``mgbtpu/native``: the shared library builds lazily on first use
with the host C++ compiler into ``build/mgbtpu_torch`` (see
``_config.BUILD_DIR``), and every entry point has a pure-Python fallback,
so the package works without a toolchain. Disable with MGBTPU_NO_NATIVE=1.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from .._config import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB = None
_TRIED = False


def _build():
    src = os.path.join(_DIR, "rs_amg.cpp")
    out = os.path.join(BUILD_DIR, "librs_amg.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a private name and rename: concurrent test workers may
    # race to build the same library
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def get_lib():
    """The native library, or None when unavailable/disabled."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("MGBTPU_NO_NATIVE"):
        return None
    try:
        path = _build()
        lib = ctypes.CDLL(path)
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.rs_level.restype = ctypes.c_long
    lib.rs_level.argtypes = [
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_double,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_long,
    ]
    _LIB = lib
    return _LIB


def rs_level_native(A, theta: float):
    """One Ruge-Stuben level via the native library.

    A: scipy CSR (square). Returns P (csr) or None if native is unavailable
    or produced no coarsening.
    """
    import scipy.sparse as sp

    lib = get_lib()
    if lib is None:
        return None
    A = sp.csr_matrix(A)
    n = A.shape[0]
    indptr = A.indptr.astype(np.int64)
    indices = A.indices.astype(np.int64)
    data = A.data.astype(np.float64)
    cap = max(int(A.nnz) + n, 16)
    p_indptr = np.zeros(n + 1, dtype=np.int64)
    p_indices = np.zeros(cap, dtype=np.int64)
    p_data = np.zeros(cap, dtype=np.float64)
    nC = lib.rs_level(n, indptr, indices, data, float(theta),
                      p_indptr, p_indices, p_data, cap)
    if nC == -1:  # insufficient capacity; retry bigger
        cap *= 4
        p_indices = np.zeros(cap, dtype=np.int64)
        p_data = np.zeros(cap, dtype=np.float64)
        nC = lib.rs_level(n, indptr, indices, data, float(theta),
                          p_indptr, p_indices, p_data, cap)
    if nC <= 0:
        return None
    nnz = p_indptr[n]
    return sp.csr_matrix((p_data[:nnz], p_indices[:nnz], p_indptr),
                         shape=(n, int(nC)))
