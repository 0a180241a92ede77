"""Local-kernel selection shared by the engines.

The engines are agnostic to the local SpMM implementation (the reference has
the same seam: MKL vs cuSPARSE, ``src/rowpara_spmm.c:386-413``).  A kernel
kind packs per-shard compact CSR into stacked device arrays at init and
returns a per-shard compute closure used inside shard_map.

Kinds:
  * "segsum" — gather + sorted segment-sum in plain XLA (exact everywhere)
  * "ell"    — ELL slot scan (bounded-nnz/row matrices; O(m*n) memory)
  * "triton" — the Pallas CSR kernel for NVIDIA GPUs (``spmm_triton.py``)
  * "dd"     — double-float (two-fp32) kernels: fp64-class accuracy from
               fp32 arithmetic; B/C travel packed as (rows, 2n) fp32

This is the only module that looks at the JAX backend: it decides what
``kernel="auto"`` means and refuses a GPU-only kernel elsewhere.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from .spmm_jnp import DeviceCSR, pack_device_csr, spmm_segment_sum
from .spmm_ell import pack_ell, spmm_ell

# kernel="auto" on a CUDA GPU, per value dtype: the faster of segsum and the
# Triton kernel end to end on an H100 at the banded and power-law shapes
# (times in PERF.md).  Every other backend runs segsum.
GPU_AUTO = {
    np.dtype(np.float32): "triton",
    np.dtype(np.float64): "triton",
}


class UnsupportedSparsity(ValueError):
    """The dd segmented-scan kernel refuses a shard too large to compile."""


def resolve_auto_kernel(dtype) -> str:
    """What ``kernel="auto"`` runs for ``dtype`` on the current backend.

    The reference's local-SpMM seam picks MKL on the host and cuSPARSE
    under ``USE_CUDA`` (``src/rowpara_spmm.c:386-413``); here the GPU gets
    the kernel measured fastest for the dtype, everything else ``segsum``.
    float64 always runs natively (never the ``dd`` emulation).
    """
    import jax

    if jax.default_backend() == "gpu":
        return GPU_AUTO.get(np.dtype(dtype), "segsum")
    return "segsum"


def pack_local_kernel(
    shards: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
    max_m: int,
    dtype,
    kind: str = "segsum",
    *,
    interpret: bool = False,
) -> tuple[tuple[np.ndarray, ...], Callable]:
    """Pack shards [(rowptr, compact_colidx, val), ...] for kernel ``kind``.

    Returns (stacked host arrays, local_fn) where ``local_fn(arrays, rB)``
    computes the shard's C block of shape (max_m, n); each element of
    ``arrays`` has leading shard axis already stripped.

    ``interpret`` runs the ``triton`` kind through the Pallas interpreter;
    it exists for the CPU tests and no engine sets it.
    """
    if kind == "segsum":
        nnz_pad = max(max(int(r[-1] - r[0]) for r, _, _ in shards), 1)
        rows, cols, vals = [], [], []
        for rowptr, cc, v in shards:
            r, c, vv = pack_device_csr(
                rowptr, cc, v.astype(dtype), nnz_pad, nrow=max_m
            )
            rows.append(r); cols.append(c); vals.append(vv)
        arrays = (np.stack(rows), np.stack(cols), np.stack(vals))

        def local_fn(arrs, rB):
            return spmm_segment_sum(DeviceCSR(arrs[0], arrs[1], arrs[2], max_m), rB)

        return arrays, local_fn

    if kind == "ell":
        L = _max_row_nnz(shards)
        cols, vals = [], []
        for rowptr, cc, v in shards:
            c, vv = pack_ell(rowptr, cc, v.astype(dtype), max_m, L=L)
            cols.append(c); vals.append(vv)
        arrays = (np.stack(cols), np.stack(vals))

        def local_fn(arrs, rB):
            return spmm_ell(arrs[0], arrs[1], rB)

        return arrays, local_fn

    if kind == "triton":
        return _pack_triton(shards, max_m, dtype, interpret)

    if kind == "dd":
        return _pack_dd(shards, max_m)

    raise ValueError(f"unknown local SpMM kernel kind {kind!r}")


def _max_row_nnz(shards) -> int:
    return max(
        max((int(np.diff(r).max()) if len(r) > 1 else 0) for r, _, _ in shards),
        1,
    )


def _pack_triton(shards, max_m, dtype, interpret):
    """Stack per-shard schedules for :func:`spmm_triton.spmm_csr_triton`:
    the row order and tail segments of :func:`spmm_triton.pack_rows`
    (tails padded with empty segments on row 0), and the nonzeros padded to
    a common length plus the tail kernel's ``BK`` overhang."""
    import jax

    from . import spmm_triton as st

    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "kernel='triton' needs a CUDA GPU; on this backend use "
            "kernel='segsum' or 'auto'"
        )
    nnz_pad = max(int(r[-1] - r[0]) for r, _, _ in shards) + st.BK
    scheds, cols, vals = [], [], []
    for rowptr, cc, v in shards:
        scheds.append(st.pack_rows(rowptr, max_m, block_m=st.block_rows(dtype)))
        nnz = int(rowptr[-1] - rowptr[0])
        c = np.zeros(nnz_pad, np.int32)
        c[:nnz] = cc
        cols.append(c)
        vv = np.zeros(nnz_pad, dtype)
        vv[:nnz] = v
        vals.append(vv)
    n_tail = max(len(sc[3]) for sc in scheds)
    arrays = tuple(np.stack([sc[i] for sc in scheds]) for i in range(3))
    for i in range(3, 6):
        seg = np.zeros((len(shards), n_tail), np.int32)
        for k, sc in enumerate(scheds):
            seg[k, : len(sc[i])] = sc[i]
        arrays += (seg,)
    arrays += (np.stack(cols), np.stack(vals))

    def local_fn(arrs, rB):
        return st.spmm_csr_triton(*arrs, rB, nrow=max_m, interpret=interpret)

    return arrays, local_fn


def _pack_dd(shards, max_m):
    """Double-float packs: per-row ELL accumulation for bounded degree, the
    segmented scan otherwise (raises ``UnsupportedSparsity`` past
    ``CRP_TPU_DD_SEGSUM_MAX_NNZ`` nonzeros per shard)."""
    from .spmm_dd import (
        pack_coo_dd, pack_ell_dd, spmm_ell_dd, spmm_segsum_dd,
    )

    L = _max_row_nnz(shards)
    if L <= 128:
        # bounded degree: per-row sequential accumulation (L unrolled
        # passes) — the segmented scan's log2(nnz) full-width levels blow
        # compile memory at millions of nonzeros
        cols, vhs, vls = [], [], []
        for rowptr, cc, v in shards:
            c, vh, vl = pack_ell_dd(
                rowptr, cc, np.asarray(v, np.float64), max_m, L=L
            )
            cols.append(c); vhs.append(vh); vls.append(vl)
        arrays = (np.stack(cols), np.stack(vhs), np.stack(vls))

        def local_fn(arrs, rB_packed):
            return spmm_ell_dd(arrs[0], arrs[1], arrs[2], rB_packed)

        return arrays, local_fn

    nnz_pad = max(max(int(r[-1] - r[0]) for r, _, _ in shards), 0) + 1
    cap = int(os.environ.get("CRP_TPU_DD_SEGSUM_MAX_NNZ", 4 << 20))
    if nnz_pad > cap:
        raise UnsupportedSparsity(
            f"dd segmented scan infeasible at {nnz_pad - 1} nnz per "
            f"shard (> CRP_TPU_DD_SEGSUM_MAX_NNZ={cap}): the unrolled "
            f"scan's full-width levels exceed compile budgets; shard the "
            f"matrix further or run float64 natively"
        )
    packs = [
        pack_coo_dd(rowptr, cc, np.asarray(v, np.float64), nnz_pad, max_m)
        for rowptr, cc, v in shards
    ]
    arrays = tuple(
        np.stack([p[i] for p in packs]) for i in range(5)
    )  # row_ids, cols, val_hi, val_lo, row_last

    def local_fn(arrs, rB_packed):
        return spmm_segsum_dd(*arrs, rB_packed)

    return arrays, local_fn
