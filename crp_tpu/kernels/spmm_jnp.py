"""Local CSR x dense SpMM — portable XLA path.

This is the baseline local kernel replacing the reference's
``mkl_sparse_d_mm`` call (``src/rowpara_spmm.c:398-407``): a gather of B rows
by column index followed by a sorted segment-sum over rows.  It runs on every
backend (CPU fp64 for the <=1e-12 acceptance tests, GPU fp32/fp64).  XLA on
the GPU fuses the gather and the multiply into one sorted scatter-add: the
``(nnz, n)`` gather is never written to device memory.

Shape discipline for XLA: nnz is padded to a static size at plan time; padded
entries carry ``row_id = nrow`` (out-of-range -> dropped by the scatter-add)
and ``col = 0`` with ``val = 0``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class DeviceCSR(NamedTuple):
    """Padded COO-ish device representation of a local CSR shard.

    ``row_ids`` are sorted (CSR order), padding rows point at ``nrow`` (one
    past the last segment) so they vanish in the segment sum.
    """

    row_ids: jax.Array  # (nnz_pad,) int32, sorted; pad = nrow
    colidx: jax.Array   # (nnz_pad,) int32; pad = 0
    val: jax.Array      # (nnz_pad,) dtype; pad = 0
    nrow: int           # static


def pack_device_csr(
    rowptr: np.ndarray,
    colidx: np.ndarray,
    val: np.ndarray,
    nnz_pad: int,
    nrow: int | None = None,
    dtype=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side packing of one CSR shard into padded (row_ids, colidx, val)."""
    nrow = (len(rowptr) - 1) if nrow is None else nrow
    nnz = int(rowptr[-1]) - int(rowptr[0])
    dtype = dtype or val.dtype
    row_ids = np.full(nnz_pad, nrow, dtype=np.int32)
    cols = np.zeros(nnz_pad, dtype=np.int32)
    vals = np.zeros(nnz_pad, dtype=dtype)
    row_ids[:nnz] = np.repeat(
        np.arange(len(rowptr) - 1, dtype=np.int32), np.diff(rowptr)
    )
    cols[:nnz] = colidx
    vals[:nnz] = val
    return row_ids, cols, vals


def spmm_segment_sum(a: DeviceCSR, b: jax.Array) -> jax.Array:
    """``C[m, n] = sum_nnz val * B[col]`` scattered by row, shapes static."""
    gathered = jnp.take(b, a.colidx, axis=0, fill_value=0)  # (nnz_pad, n)
    contrib = a.val[:, None].astype(b.dtype) * gathered
    return jax.ops.segment_sum(
        contrib, a.row_ids, num_segments=a.nrow, indices_are_sorted=True
    )
