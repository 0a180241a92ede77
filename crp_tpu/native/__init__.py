"""ctypes loader for the native host-side hot paths (fastops.cpp).

Builds the shared library on first use with g++ (cached next to the source,
or in $CRP_TPU_NATIVE_CACHE); every entry point has a pure-numpy fallback in
the calling module, so environments without a toolchain still work —
``AVAILABLE`` tells callers which path is active.  Disable with
``CRP_TPU_NO_NATIVE=1``.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile

import numpy as np

logger = logging.getLogger("crp_tpu")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastops.cpp")

_lib = None
AVAILABLE = False


def _build() -> str | None:
    cache_dir = os.environ.get("CRP_TPU_NATIVE_CACHE", _HERE)
    so_path = os.path.join(cache_dir, "libcrpfast.so")
    if os.path.exists(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(_SRC):
        return so_path
    try:
        build_path = so_path
        try:
            open(build_path, "ab").close()
        except OSError:
            build_path = os.path.join(tempfile.gettempdir(), "libcrpfast.so")
        subprocess.run(
            ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", _SRC, "-o", build_path],
            check=True, capture_output=True, timeout=120,
        )
        return build_path
    except (OSError, subprocess.SubprocessError) as e:
        logger.info("native fastops unavailable (%s); using numpy fallbacks", e)
        return None


def _load():
    global _lib, AVAILABLE
    if _lib is not None or os.environ.get("CRP_TPU_NO_NATIVE") == "1":
        return _lib
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    i64 = ctypes.c_int64
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.crp_comm_size.argtypes = [i64, i64, p_i64, p_i32, p_i64, p_i64]
    lib.crp_coo2csr.argtypes = [i64, i64, p_i64, p_i64, p_f64, p_i64, p_i32, p_f64]
    lib.crp_mtx_stat.restype = ctypes.c_int
    lib.crp_mtx_stat.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(i64)] * 3 + [
        ctypes.POINTER(ctypes.c_int)
    ] * 2
    lib.crp_mtx_read.restype = i64
    lib.crp_mtx_read.argtypes = [
        ctypes.c_char_p, i64, ctypes.c_int, ctypes.c_int, p_i64, p_i64, p_f64,
    ]
    lib.crp_ggp_partition.restype = ctypes.c_int
    lib.crp_ggp_partition.argtypes = [
        i64, p_i64, p_i32, i64, ctypes.c_double, p_i32,
    ]
    _lib = lib
    AVAILABLE = True
    return _lib


def comm_size(ncol, nnz_bounds, colidx, x_displs):
    """Native exact comm-size counting; returns (comm_sizes, total) or None."""
    lib = _load()
    if lib is None:
        return None
    nblk = len(nnz_bounds) - 1
    out = np.zeros(nblk, dtype=np.int64)
    lib.crp_comm_size(
        int(ncol), nblk,
        np.ascontiguousarray(nnz_bounds, dtype=np.int64),
        np.ascontiguousarray(colidx, dtype=np.int32),
        np.ascontiguousarray(x_displs, dtype=np.int64),
        out,
    )
    return out, int(out.sum())


def coo2csr(nrow, ncol, rows, cols, vals):
    """Native COO -> sorted CSR; returns (rowptr, colidx, csrval) or None."""
    lib = _load()
    if lib is None:
        return None
    nnz = len(rows)
    rowptr = np.zeros(nrow + 1, dtype=np.int64)
    colidx = np.zeros(nnz, dtype=np.int32)
    csrval = np.zeros(nnz, dtype=np.float64)
    lib.crp_coo2csr(
        int(nrow), nnz,
        np.ascontiguousarray(rows, dtype=np.int64),
        np.ascontiguousarray(cols, dtype=np.int64),
        np.ascontiguousarray(vals, dtype=np.float64),
        rowptr, colidx, csrval,
    )
    return rowptr, colidx, csrval


def ggp_partition(rowptr, colidx, nparts, imbalance=1.05):
    """Native greedy graph-growing K-way partition; returns the (nrow,)
    int32 part vector or None."""
    lib = _load()
    if lib is None:
        return None
    nrow = len(rowptr) - 1
    part = np.zeros(max(nrow, 1), dtype=np.int32)
    lib.crp_ggp_partition(
        int(nrow),
        np.ascontiguousarray(rowptr, dtype=np.int64),
        np.ascontiguousarray(colidx, dtype=np.int32),
        int(nparts), float(imbalance), part,
    )
    return part[:nrow]


def mtx_read(path):
    """Native .mtx reader; returns (nrow, ncol, rows, cols, vals) or None."""
    lib = _load()
    if lib is None:
        return None
    i64 = ctypes.c_int64
    nrow, ncol, nnz = i64(), i64(), i64()
    symm, field = ctypes.c_int(), ctypes.c_int()
    rc = lib.crp_mtx_stat(
        path.encode(), ctypes.byref(nrow), ctypes.byref(ncol),
        ctypes.byref(nnz), ctypes.byref(symm), ctypes.byref(field),
    )
    if rc != 0:
        return None
    cap = nnz.value * (2 if symm.value else 1)
    rows = np.zeros(max(cap, 1), dtype=np.int64)
    cols = np.zeros(max(cap, 1), dtype=np.int64)
    vals = np.zeros(max(cap, 1), dtype=np.float64)
    n = lib.crp_mtx_read(
        path.encode(), nnz.value, symm.value, field.value, rows, cols, vals
    )
    if n < 0:
        return None
    return int(nrow.value), int(ncol.value), rows[:n], cols[:n], vals[:n]
