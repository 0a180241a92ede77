"""Overlapped ring SpMM: B-row exchange fused with partial local compute.

The reference overlaps nothing inside exec (only two init-time
``MPI_Iallgatherv``'s, ``src/para2d_spmm.c:81-83``); comm/compute overlap
between devices is the new-design requirement called out in SURVEY.md
section 7.

Decomposition: split each shard's local A by the *owner* of the referenced
B row.  The self part (typically the bulk for banded/reordered matrices)
multiplies against the shard's own B block and depends on no communication,
so XLA runs it concurrently with the ring transfers; each remote shift's
partial SpMM consumes that shift's receive buffer directly — no scatter into
a unified rB, no barrier between transfers, and shift ``s+1``'s
collective-permute is independent of shift ``s``'s compute, so the scheduler
pipelines transfer ``s+1`` under compute ``s``.

    C_i  =  A_{i,self} @ B_i  +  sum_s  A_{i,(i-s)%p} @ recv_s

The self part uses the engine's configured local kernel; remote shifts use
a padded COO segment-sum whose column indices address the shift's receive
slots.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .exchange import BExchangePlan


@dataclasses.dataclass
class RingSpmmPack:
    """Host-side per-shift A subsets + self-part kernel arrays."""

    p: int
    S: int                     # receive slots per shift (== plan.S)
    R: int                     # padded nnz per (shard, shift)
    max_m: int
    # stacked over shards: shift arrays, dim1 = shift-1 (s = 1..p-1)
    step_rows: np.ndarray      # (p, p-1, R) int32 local C row; pad max_m
    step_cols: np.ndarray      # (p, p-1, R) int32 slot in shift recvbuf; pad 0
    step_vals: np.ndarray      # (p, p-1, R) dtype; pad 0
    self_arrays: tuple         # stacked kernel arrays for the self part
    self_fn: object            # local_fn(self_arrays_slice, b_loc) -> (max_m, n)
    self_kind: str             # kernel kind used for the self part


def build_ring_spmm(
    shards: list,              # per-shard CSR views (rowptr/colidx/val, global cols)
    plan: BExchangePlan,
    B_row_displs: np.ndarray,
    max_m: int,
    dtype,
    kernel_kind: str = "segsum",
) -> RingSpmmPack:
    """Split each shard's A by B-row owner and pack for the overlapped exec.

    ``shards[i]`` must expose ``rowptr``/``colidx``/``val`` with *global*
    column indices; ``plan`` is the exchange plan built from the same shards
    (its ``pair_rows[i][j]`` fix the receive slot order per shift).
    """
    from ..kernels.dispatch import pack_local_kernel

    B_row_displs = np.asarray(B_row_displs, dtype=np.int64)
    p = plan.p
    self_shards = []
    per_shift = []  # per shard: list over s=1..p-1 of (rows, slots, vals)
    R = 1
    for i, sh in enumerate(shards):
        nrow = len(sh.rowptr) - 1
        cols = np.asarray(sh.colidx, dtype=np.int64)
        vals = np.asarray(sh.val)
        rows = np.repeat(np.arange(nrow, dtype=np.int64), np.diff(sh.rowptr))
        owner = np.searchsorted(B_row_displs, cols, side="right") - 1

        mask = owner == i
        self_rowptr = np.zeros(nrow + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows[mask], minlength=nrow), out=self_rowptr[1:])
        self_shards.append((
            self_rowptr,
            (cols[mask] - B_row_displs[i]).astype(np.int32),
            vals[mask],
        ))

        shifts = []
        for s in range(1, p):
            j = (i - s) % p
            m = owner == j
            slot = np.searchsorted(plan.pair_rows[i][j], cols[m]).astype(np.int32)
            shifts.append((rows[m].astype(np.int32), slot, vals[m]))
            R = max(R, int(m.sum()))
        per_shift.append(shifts)

    step_rows = np.full((p, max(p - 1, 1), R), max_m, dtype=np.int32)
    step_cols = np.zeros((p, max(p - 1, 1), R), dtype=np.int32)
    step_vals = np.zeros((p, max(p - 1, 1), R), dtype=np.dtype(dtype))
    for i in range(p):
        for k, (r, c, v) in enumerate(per_shift[i]):
            nz = len(r)
            step_rows[i, k, :nz] = r
            step_cols[i, k, :nz] = c
            step_vals[i, k, :nz] = v

    self_arrays, self_fn = pack_local_kernel(
        self_shards, max_m, dtype, kernel_kind
    )

    return RingSpmmPack(
        p=p, S=plan.S, R=R, max_m=max_m,
        step_rows=step_rows, step_cols=step_cols, step_vals=step_vals,
        self_arrays=self_arrays, self_fn=self_fn, self_kind=kernel_kind,
    )


def ring_spmm(
    b_loc: jax.Array,          # (max_k_pad, n) owned B rows (padded)
    send_idx: jax.Array,       # (p, S) this shard's rows to send per peer
    self_arrays: tuple,        # this shard's self-part kernel arrays
    self_fn,                   # local_fn for the self part
    step_rows: jax.Array,      # (p-1, R)
    step_cols: jax.Array,      # (p-1, R)
    step_vals: jax.Array,      # (p-1, R)
    max_m: int,
    axis_name: str,
) -> jax.Array:
    """Device-side overlapped exec; runs inside shard_map, returns (max_m, n)."""
    p, S = send_idx.shape
    me = jax.lax.axis_index(axis_name)
    # no comm dependence -> overlaps the ring
    c = self_fn(self_arrays, b_loc)
    for s in range(1, p):
        dst = (me + s) % p
        sendbuf = jnp.take(
            b_loc, jnp.take(send_idx, dst, axis=0, fill_value=0), axis=0,
            fill_value=0,
        )
        recvbuf = jax.lax.ppermute(
            sendbuf, axis_name, [(i, (i + s) % p) for i in range(p)]
        )
        contrib = (
            step_vals[s - 1][:, None].astype(b_loc.dtype)
            * jnp.take(recvbuf, step_cols[s - 1], axis=0, fill_value=0)
        )
        c = c + jax.ops.segment_sum(
            contrib, step_rows[s - 1], num_segments=max_m,
            indices_are_sorted=True,
        )
    return c
