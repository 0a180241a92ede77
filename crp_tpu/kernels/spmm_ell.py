"""Local SpMM — ELL slot-scan path.

Second portable kernel flavour: the shard's CSR is padded row-wise to ELL
(fixed L slots per row) at plan time; the kernel scans over slots, each step
doing one B-row gather of shape (m, n) and a fused multiply-accumulate.
Peak memory stays O(m*n), and the access pattern is a row-gather of
contiguous n-element lines.

Best for matrices with bounded nnz/row (FEM/banded); power-law hub rows blow
up L — the engines keep the segment-sum path as the portable default and
run the Pallas CSR kernel (``spmm_triton.py``) on a GPU.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def pack_ell(
    rowptr: np.ndarray,
    colidx: np.ndarray,
    val: np.ndarray,
    nrow_pad: int,
    L: int | None = None,
    col_pad: int = 0,
    dtype=None,
) -> tuple[np.ndarray, np.ndarray]:
    """CSR -> padded ELL (cols, vals), shapes (nrow_pad, L).

    Padding slots carry ``col = col_pad`` and ``val = 0``.
    """
    nrow = len(rowptr) - 1
    counts = np.diff(rowptr) if nrow else np.zeros(0, dtype=np.int64)
    max_row = int(counts.max()) if nrow else 0
    L = max_row if L is None else L
    if L < max_row:
        raise ValueError(f"ELL slots L={L} < max nnz/row {max_row}")
    L = max(L, 1)
    dtype = dtype or val.dtype
    cols = np.full((nrow_pad, L), col_pad, dtype=np.int32)
    vals = np.zeros((nrow_pad, L), dtype=dtype)
    # slot index of each nnz within its row
    slot = np.arange(len(colidx)) - np.repeat(rowptr[:-1], counts)
    rows = np.repeat(np.arange(nrow), counts)
    cols[rows, slot] = colidx
    vals[rows, slot] = val
    return cols, vals


def spmm_ell(cols: jax.Array, vals: jax.Array, b: jax.Array) -> jax.Array:
    """``C[m, n] = sum_l vals[:, l, None] * B[cols[:, l]]`` via lax.scan."""

    def body(c, slot):
        col_l, val_l = slot
        c = c + val_l[:, None].astype(b.dtype) * jnp.take(
            b, col_l, axis=0, fill_value=0
        )
        return c, None

    init = jnp.zeros((cols.shape[0], b.shape[1]), dtype=b.dtype)
    c, _ = jax.lax.scan(body, init, (cols.T, vals.T))
    return c
