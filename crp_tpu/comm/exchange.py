"""Sparsity-aware B-row halo exchange.

The structural heart of the reference's 1D engine (``rp_spmm_init`` steps
1-5, ``src/rowpara_spmm.c:46-184``): each shard pulls exactly the B rows its
A columns reference, from the shards that own them.  The reference exchanges
the needed-row index lists at init with ``MPI_Alltoall(v)``; here the planner
holds the global sparsity pattern, so all send/recv row lists are computed
host-side in one pass, and the exec-time exchange is a single padded
``lax.all_to_all`` over the mesh axis (or a ``ppermute`` ring) driven by
static index arrays.

Raggedness note (SURVEY.md section 7 "hard parts"): per-pair row counts are
irregular, XLA shapes are not.  We pad every (src, dst) pair to the max pair
count ``S``.  The audit therefore tracks both the *logical* volume (exact
rows, matches the reference's ``rB_recv_size``) and the *physical* padded
volume actually moved over the interconnect.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class BExchangePlan:
    """Host-side plan; device arrays are the stacked per-shard index tables."""

    p: int                    # shards along the exchange axis
    glb_n_axis: str           # mesh axis name ("pm" group-column axis)
    rB_nrow: np.ndarray       # (p,) compacted receive-buffer rows per shard
    rB_nrow_max: int
    S: int                    # max rows on any (src, dst) pair
    self_max: int
    # logical (unpadded) volumes, elements of B rows (x n when reported)
    rB_recv_rows: np.ndarray  # (p,) rows received from OTHER shards (reference rB_recv_size)
    # stacked index tables, shape (p, ...) — to be sharded over the axis
    send_idx: np.ndarray      # (p, p, S) local B row index to send; pad 0
    recv_dst: np.ndarray      # (p, p, S) compact rB destination; pad rB_nrow_max (dropped)
    self_src: np.ndarray      # (p, self_max) local B row; pad 0
    self_dst: np.ndarray      # (p, self_max) compact rB dst; pad rB_nrow_max (dropped)
    rowmap: list              # per-shard global-B-row -> compact index (np arrays)
    pair_rows: list           # pair_rows[i][j] = sorted global B rows i recvs from j

    @property
    def total_recv_rows(self) -> int:
        return int(self.rB_recv_rows.sum())

    @property
    def physical_rows(self) -> int:
        """Padded rows actually moved: p*p*S per all_to_all round."""
        return self.p * self.p * self.S

    @property
    def physical_rows_ring(self) -> int:
        """Padded rows moved by the p2p ring: p-1 shifts of S rows per shard."""
        return self.p * (self.p - 1) * self.S


def build_b_exchange(
    shard_colidx: list[np.ndarray],
    B_row_displs: np.ndarray,
    reidx: bool = True,
) -> BExchangePlan:
    """Build the exchange plan from each shard's referenced global B rows.

    ``shard_colidx[i]`` are the (not necessarily unique) global column
    indices of shard i's local A; ``B_row_displs`` is the (p+1,) ownership
    partition of B rows.  ``reidx`` mirrors ``RP_SPMM_REIDX``
    (``src/rowpara_spmm.c:81-86``): compact never-referenced rows out of the
    receive buffer; with it off, the buffer spans the contiguous
    [min, max] referenced window.
    """
    B_row_displs = np.asarray(B_row_displs, dtype=np.int64)
    p = len(shard_colidx)
    # every referenced B row must have an owner — rows outside the
    # ownership range would otherwise be silently dropped (wrong results)
    for i, cols in enumerate(shard_colidx):
        if len(cols) and (
            int(np.min(cols)) < int(B_row_displs[0])
            or int(np.max(cols)) >= int(B_row_displs[-1])
        ):
            raise ValueError(
                f"shard {i} references B rows outside the ownership range "
                f"[{B_row_displs[0]}, {B_row_displs[-1]}): cols span "
                f"[{np.min(cols)}, {np.max(cols)}]. The B_row_displs "
                f"partition must cover all referenced rows (for square "
                f"matrices extend the last row-block boundary to k)."
            )
    refs = []       # per shard: sorted unique referenced global rows
    rowmaps = []    # per shard: map from referenced global row -> compact idx
    rB_nrow = np.zeros(p, dtype=np.int64)
    win_start = np.zeros(p, dtype=np.int64)
    for i, cols in enumerate(shard_colidx):
        ref = np.unique(np.asarray(cols, dtype=np.int64))
        refs.append(ref)
        if reidx:
            rB_nrow[i] = ref.shape[0]
        else:
            win_start[i] = ref[0] if ref.shape[0] else 0
            rB_nrow[i] = (ref[-1] - ref[0] + 1) if ref.shape[0] else 0
        rowmaps.append(None)  # filled below once dst indexing is fixed

    def dst_of(i: int, rows: np.ndarray) -> np.ndarray:
        """Compact rB index of global rows for shard i."""
        if reidx:
            return np.searchsorted(refs[i], rows).astype(np.int64)
        return (rows - win_start[i]).astype(np.int64)

    rB_nrow_max = int(rB_nrow.max()) if p else 0

    # per-pair row lists: pair[i][j] = global rows shard i receives from owner j
    recv_rows = [
        [
            refs[i][
                (refs[i] >= B_row_displs[j]) & (refs[i] < B_row_displs[j + 1])
            ]
            for j in range(p)
        ]
        for i in range(p)
    ]
    pair_cnt = np.array(
        [[len(recv_rows[i][j]) if i != j else 0 for j in range(p)] for i in range(p)],
        dtype=np.int64,
    )
    S = int(pair_cnt.max()) if p > 1 else 0
    self_cnt = np.array([len(recv_rows[i][i]) for i in range(p)], dtype=np.int64)
    self_max = int(self_cnt.max()) if p else 0

    send_idx = np.zeros((p, p, max(S, 1)), dtype=np.int32)
    recv_dst = np.full((p, p, max(S, 1)), rB_nrow_max, dtype=np.int32)
    self_src = np.zeros((p, max(self_max, 1)), dtype=np.int32)
    self_dst = np.full((p, max(self_max, 1)), rB_nrow_max, dtype=np.int32)
    for i in range(p):
        for j in range(p):
            if i == j:
                continue
            rows = recv_rows[i][j]
            c = len(rows)
            if c:
                # shard j sends these rows (local index) in slot destined to i
                send_idx[j, i, :c] = rows - B_row_displs[j]
                recv_dst[i, j, :c] = dst_of(i, rows)
        rows = recv_rows[i][i]
        c = len(rows)
        if c:
            self_src[i, :c] = rows - B_row_displs[i]
            self_dst[i, :c] = dst_of(i, rows)

    return BExchangePlan(
        p=p,
        glb_n_axis="pm",
        rB_nrow=rB_nrow,
        rB_nrow_max=rB_nrow_max,
        S=max(S, 1),
        self_max=max(self_max, 1),
        rB_recv_rows=pair_cnt.sum(axis=1),
        send_idx=send_idx,
        recv_dst=recv_dst,
        self_src=self_src,
        self_dst=self_dst,
        rowmap=refs if reidx else [win_start[i] for i in range(p)],
        pair_rows=recv_rows,
    )


def exchange_b(
    b_loc: jax.Array,        # (max_k, n) this shard's owned B rows (padded)
    send_idx: jax.Array,     # (p, S) rows to send to each peer
    recv_dst: jax.Array,     # (p, S) compact destinations for rows from each peer
    self_src: jax.Array,     # (self_max,)
    self_dst: jax.Array,     # (self_max,)
    rB_nrow_max: int,
    axis_name: str,
) -> jax.Array:
    """Device-side exchange: gather -> all_to_all -> drop-scatter -> self-copy.

    Runs inside ``shard_map``; all index tables are this shard's slices.
    Returns the compacted receive buffer rB of shape (rB_nrow_max, n).
    """
    p, S = send_idx.shape
    n = b_loc.shape[1]
    sendbuf = jnp.take(b_loc, send_idx.reshape(-1), axis=0, fill_value=0)
    sendbuf = sendbuf.reshape(p * S, n)
    recvbuf = jax.lax.all_to_all(
        sendbuf, axis_name, split_axis=0, concat_axis=0, tiled=True
    )
    rB = jnp.zeros((rB_nrow_max, n), dtype=b_loc.dtype)
    # NB: padded destination slots all alias rB_nrow_max and rely on
    # mode="drop", so unique_indices must NOT be asserted here.
    rB = rB.at[recv_dst.reshape(-1)].set(recvbuf, mode="drop")
    rB = rB.at[self_dst].set(
        jnp.take(b_loc, self_src, axis=0, fill_value=0), mode="drop"
    )
    return rB


def exchange_b_ring(
    b_loc: jax.Array,        # (max_k, n) this shard's owned B rows (padded)
    send_idx: jax.Array,     # (p, S) rows to send to each peer
    recv_dst: jax.Array,     # (p, S) compact destinations for rows from each peer
    self_src: jax.Array,     # (self_max,)
    self_dst: jax.Array,     # (self_max,)
    rB_nrow_max: int,
    axis_name: str,
) -> jax.Array:
    """p2p-ring exchange: one distance-``s`` ``ppermute`` per shift.

    The counterpart of the reference's nonblocking p2p ring
    (``RP_SPMM_P2P=1``, ``src/rowpara_spmm.c:275-303``): at shift ``s`` every
    shard sends its planned rows directly to the peer ``s`` ranks ahead and
    receives from the peer ``s`` ranks behind.  The shifts are unrolled and
    mutually independent, so XLA issues the collective-permutes
    asynchronously and the scatters overlap the later transfers.  Physical
    volume is ``(p-1) * S`` rows per shard (vs ``p * S`` for all_to_all).
    """
    p, S = send_idx.shape
    me = jax.lax.axis_index(axis_name)
    rB = jnp.zeros((rB_nrow_max, b_loc.shape[1]), dtype=b_loc.dtype)
    # padded dst slots alias the plan's rB_nrow_max row: dropped when rB has
    # exactly that many rows, else land on a row no real A column references
    rB = rB.at[self_dst].set(
        jnp.take(b_loc, self_src, axis=0, fill_value=0), mode="drop"
    )
    for s in range(1, p):
        dst = (me + s) % p
        src = (me - s) % p
        sendbuf = jnp.take(
            b_loc, jnp.take(send_idx, dst, axis=0, fill_value=0), axis=0,
            fill_value=0,
        )
        recvbuf = jax.lax.ppermute(
            sendbuf, axis_name, [(i, (i + s) % p) for i in range(p)]
        )
        rB = rB.at[jnp.take(recv_dst, src, axis=0, fill_value=rB_nrow_max)].set(
            recvbuf, mode="drop"
        )
    return rB
