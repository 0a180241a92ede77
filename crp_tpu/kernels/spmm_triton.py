"""Local CSR x dense SpMM — a Pallas kernel for NVIDIA GPUs (Triton route).

The reference's GPU seam is one cuSPARSE ``csrmm`` per rank
(``deprecated/src/cuda_proxy.cu:122-182``).  CSR x dense is far below the
GPU's flop/byte ridge: each nonzero does 2 flops per gathered B element, so
the only lever is the bytes moved and the instructions spent moving them.
``segsum`` (``spmm_jnp.py``) scatter-adds every product into C with atomics;
this kernel keeps each C tile in registers and writes it once.

Rows are binned by length at pack time: a stable sort, longest first, on the
length rounded down to a quarter octave.  The ``BM`` rows of one block then
have lengths within 19% of each other, and rows of near-equal length (a
banded matrix) keep their matrix order, which keeps the B rows they gather
close together in the L2 cache.  One program owns one block and a
``TN``-wide slice of the columns.  Each step of its loop takes the next
``U`` nonzeros of each of its rows: masked loads of column ids and values,
``U`` gathers of ``(BM, TN)`` B rows in flight, and multiply-adds into a
``(BM, TN)`` accumulator — elementwise only, no cross-lane reduction.  The
accumulator is kept in the data's own precision (fp32 for fp32, fp64 for
fp64).  No matrix product is involved, so TF32 never arises.

Power-law hub rows would serialise one program over their whole length, so
a block walks at most ``SEG`` nonzeros of each row.  What a row holds past
that is cut into tail segments of at most ``SEG`` nonzeros, which a second
kernel sums and adds into C with atomics.  Rows that fit in ``SEG`` are
written with a plain store, so their sums are deterministic.

``interpret=True`` runs the same kernels through the Pallas interpreter on
the CPU; the tests use it.  The engines never do.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# Launch geometry, chosen on an H100 (SXM, 700 W) at the banded (11.4M nnz)
# and scrambled power-law (10.8M nnz) shapes with n = 256; PERF.md has the
# sweep.
BK = 32      # nonzeros a tail program loads per step
SEG = 256    # nonzeros of a row the head kernel walks; the rest is tail
U = 2        # nonzeros per row per head-kernel step


def block_rows(dtype) -> int:
    """Rows per program: 16 for 4-byte data, 8 for 8-byte data."""
    return 8 if np.dtype(dtype).itemsize == 8 else 16


def tile_n(n: int, dtype) -> int:
    """Power-of-two column slice per program: up to 128 lanes of fp32, 64 of
    fp64."""
    cap = 64 if np.dtype(dtype).itemsize == 8 else 128
    return max(16, min(cap, 1 << max(int(n) - 1, 0).bit_length()))


def pack_rows(rowptr: np.ndarray, nrow: int, *, block_m: int,
              seg: int = SEG):
    """Host-side schedule for :func:`spmm_csr_triton` from a CSR ``rowptr``
    (``len(rowptr) - 1 <= nrow``; rows past it are empty).

    Returns int32 arrays ``(perm, start, length, seg_row, seg_start,
    seg_end)``: rows in binned order (see the module docstring) padded to a
    multiple of ``block_m`` (pad rows carry id ``nrow`` and length 0), each
    row's first nonzero and its length capped at ``seg``, and the tail
    segments of rows longer than ``seg`` (possibly none).
    """
    rowptr = np.asarray(rowptr, dtype=np.int64) - int(rowptr[0])
    lens = np.zeros(nrow, np.int64)
    lens[: len(rowptr) - 1] = np.diff(rowptr)
    starts = np.full(nrow, rowptr[-1], np.int64)
    starts[: len(rowptr) - 1] = rowptr[:-1]
    octave4 = np.floor(4 * np.log2(np.maximum(lens, 1))).astype(np.int64)
    perm = np.argsort(-np.where(lens > 0, octave4, -1), kind="stable")
    n_pad = -(-max(nrow, 1) // block_m) * block_m
    out_perm = np.full(n_pad, nrow, np.int32)
    out_perm[:nrow] = perm
    out_start = np.zeros(n_pad, np.int32)
    out_start[:nrow] = starts[perm]
    out_len = np.zeros(n_pad, np.int32)
    out_len[:nrow] = np.minimum(lens[perm], seg)

    long_rows = np.flatnonzero(lens > seg)
    n_tail = -(-(lens[long_rows] - seg) // seg)
    seg_row = np.repeat(long_rows, n_tail)
    k = np.arange(len(seg_row)) - np.repeat(np.cumsum(n_tail) - n_tail, n_tail)
    seg_start = starts[seg_row] + seg * (k + 1)
    seg_end = np.minimum(seg_start + seg, starts[seg_row] + lens[seg_row])
    return (out_perm, out_start, out_len, seg_row.astype(np.int32),
            seg_start.astype(np.int32), seg_end.astype(np.int32))


def _gather_b(b_ref, cols, lanes, valid):
    """``B[cols, lanes]`` as one ``(len(cols), len(lanes))`` masked gather;
    both indices are passed as full arrays, which the Triton lowering and
    the interpreter read alike."""
    shape = (cols.shape[0], lanes.shape[0])
    return plt.load(
        b_ref.at[jnp.broadcast_to(cols[:, None], shape),
                 jnp.broadcast_to(lanes[None, :], shape)],
        mask=jnp.broadcast_to(valid[:, None], shape), other=0,
    )


def _head_kernel(perm_ref, start_ref, len_ref, cols_ref, vals_ref, b_ref,
                 c_ref, *, BM, TN):
    blk, j = pl.program_id(0), pl.program_id(1)
    rows = perm_ref[pl.ds(blk * BM, BM)]
    start = start_ref[pl.ds(blk * BM, BM)]
    length = len_ref[pl.ds(blk * BM, BM)]
    lanes = j * TN + jnp.arange(TN)
    acc_dtype = c_ref.dtype

    def step(k, acc):
        # the k-th group of U nonzeros of every row: U gathers in flight
        for u in range(U):
            valid = k * U + u < length
            idx = start + k * U + u
            cols = plt.load(cols_ref.at[idx], mask=valid, other=0)
            vals = plt.load(vals_ref.at[idx], mask=valid, other=0)
            bt = _gather_b(b_ref, cols, lanes, valid)
            acc = acc + vals[:, None].astype(acc_dtype) * bt.astype(acc_dtype)
        return acc

    acc = jax.lax.fori_loop(0, (jnp.max(length) + U - 1) // U, step,
                            jnp.zeros((BM, TN), acc_dtype))
    shape = (BM, TN)
    plt.store(
        c_ref.at[jnp.broadcast_to(rows[:, None], shape),
                 jnp.broadcast_to(lanes[None, :], shape)],
        acc,
        mask=jnp.broadcast_to((rows < c_ref.shape[0])[:, None], shape),
    )


def _tail_kernel(seg_row_ref, seg_start_ref, seg_end_ref, cols_ref, vals_ref,
                 b_ref, c_in_ref, c_ref, *, TN):
    del c_in_ref  # aliased to c_ref
    s, j = pl.program_id(0), pl.program_id(1)
    start, end = seg_start_ref[s], seg_end_ref[s]
    lanes = j * TN + jnp.arange(TN)
    acc_dtype = c_ref.dtype

    def step(i, acc):
        idx = start + i * BK
        valid = idx + jnp.arange(BK) < end
        cols = plt.load(cols_ref.at[pl.ds(idx, BK)], mask=valid, other=0)
        vals = plt.load(vals_ref.at[pl.ds(idx, BK)], mask=valid, other=0)
        bt = _gather_b(b_ref, cols, lanes, valid)
        prod = vals[:, None].astype(acc_dtype) * bt.astype(acc_dtype)
        return acc + jnp.sum(prod, axis=0)

    acc = jax.lax.fori_loop(0, (end - start + BK - 1) // BK, step,
                            jnp.zeros((TN,), acc_dtype))
    plt.atomic_add(c_ref, (seg_row_ref[s], pl.ds(j * TN, TN)), acc)


@functools.partial(jax.jit, static_argnames=("nrow", "interpret"))
def spmm_csr_triton(perm, start, length, seg_row, seg_start, seg_end,
                    cols, vals, b, *, nrow: int, interpret: bool = False):
    """``C[nrow, n] = A @ B`` for one CSR shard scheduled by
    :func:`pack_rows` with ``block_m = block_rows(b.dtype)``.

    ``cols``/``vals`` are the shard's CSR column ids and values followed by
    at least ``BK`` slots of padding (so every tail chunk load stays in
    bounds).  B's column count is padded up to the tile width here and C
    trimmed back.
    """
    n = b.shape[1]
    block_m = block_rows(b.dtype)
    TN = tile_n(n, b.dtype)
    n_pad = -(-n // TN) * TN
    if n_pad != n:
        b = jnp.pad(b, ((0, 0), (0, n_pad - n)))
    vals = vals.astype(b.dtype)
    params = dict(
        backend="triton",
        interpret=interpret,
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
    )
    out_shape = jax.ShapeDtypeStruct((nrow, n_pad), b.dtype)
    c = pl.pallas_call(
        functools.partial(_head_kernel, BM=block_m, TN=TN),
        out_shape=out_shape,
        grid=(perm.shape[0] // block_m, n_pad // TN),
        name="spmm_csr_head",
        **params,
    )(perm, start, length, cols, vals, b)
    if seg_row.shape[0]:
        c = pl.pallas_call(
            functools.partial(_tail_kernel, TN=TN),
            out_shape=out_shape,
            grid=(seg_row.shape[0], n_pad // TN),
            input_output_aliases={6: 0},
            name="spmm_csr_tail",
            **params,
        )(seg_row, seg_start, seg_end, cols, vals, b, c)
    return c[:, :n] if n_pad != n else c
