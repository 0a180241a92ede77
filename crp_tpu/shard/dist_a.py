"""Distributed-A ingestion — the ``rd_Ai``/``rd_Av`` + Allgatherv-A path.

The reference's v1 engine accepts A *already distributed*: each rank owns a
contiguous row range (``src_A_srow``/``src_A_nrow`` with an absolute
``src_A_rowptr`` and its ``colidx``/``val`` slices,
``deprecated/src/crpspmm.c:63-71``).  Init allgathers only the O(m) metadata
(global rowptr, per-row colidx [min,max] ranges,
``crpspmm.c:90-131``); the O(nnz) payload moves with collectives:
``mat_redist`` engines ``rd_Ai``/``rd_Av`` reshard colidx/val as 1 x nnz row
vectors from user nnz ranges to per-(pi,pj) internal nnz subranges
(``crpspmm.c:240-265``), then an ``MPI_Allgatherv`` over ``comm_row``
assembles each row panel on every rank of its grid row
(``crpspmm.c:559-584``).  The v2 engine replicates plan-layout A blocks the
same way (``src/para2d_spmm.c:47-100``).

JAX version: the nnz vectors are 1 x nnz ``BlockDist`` blocks moved
by the generic :class:`~crp_tpu.shard.redist.RedistEngine` (one padded
``all_to_all``), and the panel assembly is a ``jax.lax.all_gather`` along
the ``pn`` mesh axis inside ``shard_map``.  A never needs to exist as a
host-global CSR: per-device blocks go in, the device-side collectives
assemble each row panel, and only the (already replicated) panel a kernel
pack needs is staged to host — the same per-rank footprint the reference
has.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..sparse.csr import CSRMatrix
from ..utils.blocks import uniform_displs
from .redist import BlockDist, RedistEngine


@dataclasses.dataclass
class DistCSR:
    """A distributed as ``p`` contiguous row-range blocks.

    Mirrors the v1 init arguments (``deprecated/src/crpspmm.c:63-71``):
    block ``i`` owns global rows ``[row_displs[i], row_displs[i+1])`` with an
    *absolute* rowptr slice (global nnz offsets, length ``nrows_i + 1``) and
    its colidx/val slices.  ``colidxs``/``vals`` entries may be numpy arrays
    or device-resident jax arrays.
    """

    m: int
    k: int
    row_displs: np.ndarray       # (p+1,)
    rowptrs: list                # block i: (nrows_i + 1,) absolute offsets
    colidxs: list                # block i: (nnz_i,)
    vals: list                   # block i: (nnz_i,)

    def __post_init__(self) -> None:
        self.row_displs = np.asarray(self.row_displs, dtype=np.int64)
        assert len(self.rowptrs) == self.p
        assert len(self.colidxs) == self.p and len(self.vals) == self.p

    @property
    def p(self) -> int:
        return len(self.row_displs) - 1

    # dimension aliases so engines can treat CSRMatrix / DistCSR uniformly
    @property
    def nrow(self) -> int:
        return self.m

    @property
    def ncol(self) -> int:
        return self.k

    @classmethod
    def from_global(cls, a: CSRMatrix, row_displs: np.ndarray) -> "DistCSR":
        """Scatter a host-global CSR into per-block slices (test helper,
        the ``scatter_csr_rows`` analog, ``examples/test_utils.c:57-119``)."""
        row_displs = np.asarray(row_displs, dtype=np.int64)
        p = len(row_displs) - 1
        rowptrs, colidxs, vals = [], [], []
        for i in range(p):
            r0, r1 = int(row_displs[i]), int(row_displs[i + 1])
            s, e = int(a.rowptr[r0]), int(a.rowptr[r1])
            rowptrs.append(np.asarray(a.rowptr[r0 : r1 + 1], dtype=np.int64))
            colidxs.append(np.asarray(a.colidx[s:e], dtype=np.int32))
            vals.append(np.asarray(a.val[s:e]))
        return cls(a.nrow, a.ncol, row_displs, rowptrs, colidxs, vals)

    # ------------------------------------------------- O(m) metadata assembly
    def global_rowptr(self) -> np.ndarray:
        """(m+1,) global rowptr — the Allgatherv-rowptr analog
        (``deprecated/src/crpspmm.c:90-105``); O(m) ints, never O(nnz)."""
        out = np.empty(self.m + 1, dtype=np.int64)
        for i in range(self.p):
            r0, r1 = int(self.row_displs[i]), int(self.row_displs[i + 1])
            out[r0:r1] = np.asarray(self.rowptrs[i][:-1])
        out[self.m] = int(np.asarray(self.rowptrs[-1][-1]))
        return out

    def row_col_ranges(self) -> np.ndarray:
        """(m, 2) per-row [min colidx, max colidx] — the A_cidx_se allgather
        (``deprecated/src/crpspmm.c:107-131``).  Computed per shard from the
        first/last nnz of each row (colidx sorted per row); device-resident
        colidx only ships these 2 ints per row to host."""
        out = np.empty((self.m, 2), dtype=np.int64)
        out[:, 0] = self.k
        out[:, 1] = -1
        for i in range(self.p):
            r0, r1 = int(self.row_displs[i]), int(self.row_displs[i + 1])
            rp = np.asarray(self.rowptrs[i], dtype=np.int64)
            base = int(rp[0])
            counts = np.diff(rp)
            nonempty = counts > 0
            firsts = (rp[:-1] - base)[nonempty]
            lasts = (rp[1:] - base)[nonempty] - 1
            ci = self.colidxs[i]
            if isinstance(ci, jax.Array):
                # one device gather, O(nrow) host traffic
                lo = np.asarray(jnp.take(ci, jnp.asarray(firsts)))
                hi = np.asarray(jnp.take(ci, jnp.asarray(lasts)))
            else:
                ci = np.asarray(ci)
                lo, hi = ci[firsts], ci[lasts]
            out[r0:r1][nonempty, 0] = lo
            out[r0:r1][nonempty, 1] = hi
        return out

    def row_col_ranges_v1(self) -> np.ndarray:
        """Per-row ranges with the v1 empty-row quirk
        (``CSRMatrix.row_col_ranges_v1``): empty rows read their
        neighbours' first/last columns.  Computed per shard from local
        arrays exactly as the reference does before the allgather
        (``deprecated/src/crpspmm.c:111-117``); local out-of-bounds reads
        (empty rows at shard edges) are clipped within the shard."""
        out = np.empty((self.m, 2), dtype=np.int64)
        for i in range(self.p):
            r0, r1 = int(self.row_displs[i]), int(self.row_displs[i + 1])
            rp = np.asarray(self.rowptrs[i], dtype=np.int64)
            base = int(rp[0])
            loc_nnz = int(rp[-1]) - base
            if loc_nnz == 0:
                out[r0:r1, 0] = self.k
                out[r0:r1, 1] = -1
                continue
            firsts = np.minimum(rp[:-1] - base, loc_nnz - 1)
            lasts = np.maximum(rp[1:] - 1 - base, 0)
            ci = self.colidxs[i]
            if isinstance(ci, jax.Array):
                lo = np.asarray(jnp.take(ci, jnp.asarray(firsts)))
                hi = np.asarray(jnp.take(ci, jnp.asarray(lasts)))
            else:
                ci = np.asarray(ci)
                lo, hi = ci[firsts], ci[lasts]
            out[r0:r1, 0] = lo
            out[r0:r1, 1] = hi
        return out

    @property
    def nnz(self) -> int:
        return int(np.asarray(self.rowptrs[-1][-1]))


def _stack_on_devices(arrays, mesh, maxw, dtype) -> jax.Array:
    """Per-device 1D payloads -> one (p, 1, maxw) array sharded over the
    flattened mesh, each block placed directly on its owner device."""
    devs = mesh.devices.reshape(-1)
    p = len(arrays)
    axes = tuple(mesh.axis_names)
    sharding = NamedSharding(
        mesh, P(axes if len(axes) > 1 else axes[0], None, None)
    )
    pieces = []
    for i in range(p):
        x = jnp.asarray(arrays[i], dtype=dtype).reshape(1, 1, -1)
        if x.shape[2] < maxw:
            x = jnp.pad(x, ((0, 0), (0, 0), (0, maxw - x.shape[2])))
        pieces.append(jax.device_put(x, devs[i]))
    return jax.make_array_from_single_device_arrays(
        (p, 1, maxw), sharding, pieces
    )


def _allgather_pn(x: jax.Array, mesh, pm: int, pn: int) -> jax.Array:
    """(pm*pn, 1, w) chunks -> (pm, pn, pn, w): every device of grid row i
    holds all pn chunks of panel i (the ``MPI_Allgatherv`` over ``comm_row``,
    ``deprecated/src/crpspmm.c:571-578``)."""
    w = x.shape[2]

    def local(xl):
        return jax.lax.all_gather(xl[0, 0, 0], "pn")[None, None]

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P("pm", "pn", None, None),
        out_specs=P("pm", "pn", None, None),
        check_vma=False,
    )
    return jax.jit(fn)(x.reshape(pm, pn, 1, w))


def ingest_dist_a(
    dist: DistCSR,
    m_split_idx: np.ndarray,
    pm: int,
    pn: int,
    mesh: jax.sharding.Mesh,
    val_dtype=np.float64,
) -> tuple[list[CSRMatrix], int, int]:
    """Reshard + replicate distributed A into host row-panel CSRs.

    The device-side path of ``crpspmm_engine_exec`` steps 1
    (``deprecated/src/crpspmm.c:559-584``), run once at init since A is
    constant across execs:

      1. ``rd_Ai``/``rd_Av``: move colidx/val (1 x nnz blocks) from the
         user's nnz ranges to internal per-(pi,pj) subranges — panel i's nnz
         split uniformly over its pn column ranks
         (``calc_block_spos_size``-style, ``crpspmm.c:242-249``);
      2. ``all_gather`` along pn assembles the whole panel on each device of
         grid row i;
      3. one replica per panel is staged to host for kernel packing.

    Returns ``(panels, nelem_A_rd, nelem_A_agv)`` with the audit counters
    summed over ranks exactly as the reference's
    (``crpspmm.c:448-456``: per-rank ``rd_A_nnz`` / ``loc_A_nnz``).
    """
    p = dist.p
    assert p == pm * pn, (p, pm, pn)
    grp = dist.global_rowptr()
    m_split_idx = np.asarray(m_split_idx, dtype=np.int64)
    assert len(m_split_idx) == pm + 1

    # panel nnz ranges + per-(i,j) internal subranges
    panel_s = grp[m_split_idx[:-1]]
    panel_e = grp[m_split_idx[1:]]
    panel_nnz = (panel_e - panel_s).astype(np.int64)
    dst_blocks = np.zeros((p, 4), dtype=np.int64)
    sub_displs = []
    for i in range(pm):
        d = uniform_displs(int(panel_nnz[i]), pn)
        sub_displs.append(d)
        for j in range(pn):
            r = i * pn + j
            dst_blocks[r] = (0, panel_s[i] + d[j], 1, d[j + 1] - d[j])

    src_blocks = np.zeros((p, 4), dtype=np.int64)
    for i in range(p):
        r0, r1 = int(dist.row_displs[i]), int(dist.row_displs[i + 1])
        src_blocks[i] = (0, grp[r0], 1, grp[r1] - grp[r0])

    src_bd = BlockDist(src_blocks)
    dst_bd = BlockDist(dst_blocks)
    rd_Ai = RedistEngine(src_bd, dst_bd, mesh, dtype=np.int32)
    rd_Av = RedistEngine(src_bd, dst_bd, mesh, dtype=val_dtype)

    src_maxw = src_bd.max_w
    x_ci = _stack_on_devices(dist.colidxs, mesh, src_maxw, np.int32)
    x_v = _stack_on_devices(dist.vals, mesh, src_maxw, val_dtype)
    ci_int = rd_Ai.exec_device(x_ci)   # (p, 1, dst_maxw)
    v_int = rd_Av.exec_device(x_v)

    dst_maxw = dst_bd.max_w
    if pn > 1:
        ci_rep = _allgather_pn(ci_int, mesh, pm, pn)  # (pm, pn, pn, w)
        v_rep = _allgather_pn(v_int, mesh, pm, pn)
    else:
        ci_rep = ci_int.reshape(pm, 1, 1, dst_maxw)
        v_rep = v_int.reshape(pm, 1, 1, dst_maxw)

    # stage one replica per panel to host and rebuild the panel CSR
    panels = []
    for i in range(pm):
        d = sub_displs[i]
        ci_chunks = np.asarray(ci_rep[i, 0])   # (pn, dst_maxw)
        v_chunks = np.asarray(v_rep[i, 0])
        ci = np.concatenate(
            [ci_chunks[j, : d[j + 1] - d[j]] for j in range(pn)]
        )
        v = np.concatenate([v_chunks[j, : d[j + 1] - d[j]] for j in range(pn)])
        r0, r1 = int(m_split_idx[i]), int(m_split_idx[i + 1])
        rp = grp[r0 : r1 + 1] - grp[r0]
        panels.append(CSRMatrix(r1 - r0, dist.k, rp, ci, v))

    nelem_A_rd = int(panel_nnz.sum())          # sum of per-rank rd_A_nnz
    nelem_A_agv = 0 if pn == 1 else int(panel_nnz.sum() * pn)
    return panels, nelem_A_rd, nelem_A_agv


def replicate_a0(
    dist: DistCSR,
    a0_rowptr: np.ndarray,
    pm: int,
    pn: int,
    mesh: jax.sharding.Mesh,
    val_dtype=np.float64,
) -> list[CSRMatrix]:
    """v2-style A replication: blocks already in the plan's A0 1D layout
    (device ``i*pn+j`` owns block ``i*pn+j``) are all-gathered along pn so
    every device of grid row i holds panel i — the two overlapped
    ``MPI_Iallgatherv`` of ``para2d_spmm_init`` (``src/para2d_spmm.c:47-100``).
    Returns the pm host panel CSRs for kernel packing."""
    p = dist.p
    assert p == pm * pn, (p, pm, pn)
    a0 = np.asarray(a0_rowptr, dtype=np.int64)
    assert np.array_equal(a0, dist.row_displs), "blocks must be in A0 layout"
    grp = dist.global_rowptr()
    blk_nnz = grp[a0[1:]] - grp[a0[:-1]]
    maxw = int(max(blk_nnz.max(), 1))
    x_ci = _stack_on_devices(dist.colidxs, mesh, maxw, np.int32)
    x_v = _stack_on_devices(dist.vals, mesh, maxw, val_dtype)
    if pn > 1:
        ci_rep = _allgather_pn(x_ci, mesh, pm, pn)
        v_rep = _allgather_pn(x_v, mesh, pm, pn)
    else:
        ci_rep = x_ci.reshape(pm, 1, 1, maxw)
        v_rep = x_v.reshape(pm, 1, 1, maxw)

    panels = []
    for i in range(pm):
        ci_chunks = np.asarray(ci_rep[i, 0])
        v_chunks = np.asarray(v_rep[i, 0])
        lens = [int(blk_nnz[i * pn + j]) for j in range(pn)]
        ci = np.concatenate([ci_chunks[j, : lens[j]] for j in range(pn)])
        v = np.concatenate([v_chunks[j, : lens[j]] for j in range(pn)])
        r0, r1 = int(a0[i * pn]), int(a0[(i + 1) * pn])
        rp = grp[r0 : r1 + 1] - grp[r0]
        panels.append(CSRMatrix(r1 - r0, dist.k, rp, ci, v))
    return panels
