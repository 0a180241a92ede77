"""SpMM with trainable A values (``op(B_shards, vals) -> C_shards``).

The reference treats the sparse matrix as static data: its drivers build
A once and only B varies per exec (``examples/test_rp_spmm.c:9-14``).
:class:`~crp_tpu.engine.autodiff.DifferentiableSpmm` mirrors that — its
VJP flows to B only.  GNN workloads that TRAIN edge weights (GAT-style
attention, learnable adjacency rescaling) additionally need

  * the forward ``C = A(v) @ B`` to take the nonzero values ``v`` as a
    traced input, and
  * the gradient ``dL/dv`` — a sampled dense-dense product (SDDMM):
    ``dv[q] = dot(dC[row_q, :], B[col_q, :])`` at A's sparsity pattern.

``C`` is linear in both ``B`` and ``v``, so both cotangents are exact:

  * ``dB = A(v)^T @ dC`` — a full planned engine over ``A^T`` (the same
    construction as ``DifferentiableSpmm``), with the transposed engine's
    packed value slots REBOUND per call through a host-precomputed
    nnz permutation (``CSRMatrix.transpose``'s stable counting sort,
    ``sparse/csr.py``): A^T's t-th nonzero is A's ``argsort(colidx)[t]``.
  * ``dv`` — an SDDMM over the SAME sparsity-aware exchanged B the
    forward consumed: the engine's B-row exchange (``comm/exchange.py``,
    the ``MPI_Alltoallv`` analog of ``src/rowpara_spmm.c:152-165``)
    already lands every referenced B row on the owning shard, and the
    packed segsum slot arrays (rows, cols) double as the SDDMM gather
    maps.  The per-slot dot products are computed in fixed-size chunks
    under ``lax.scan`` so peak memory is O(chunk x n), not O(nnz x n).

Only the ``segsum`` kernel form is supported: it is the one whose packed
representation keeps one value SLOT per nonzero (``pack_device_csr``),
making value substitution a pure array swap — the engine's jitted exec
already takes the packed arrays as arguments, so no engine surgery is
needed.

Layout: slot q of shard i is global nonzero ``a.rowptr[displs[i]] + q``
(``CSRMatrix.row_slice`` keeps CSR order and the nnz-balanced row blocks
are contiguous in nnz), so gradients w.r.t. values are assembled by
static per-shard slices — no scatter.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..config import SpmmConfig
from .autodiff import _repad_rows
from .rowpara import RowParaSpmm


def _exec_with_vals(eng: RowParaSpmm, vals_shards, b_shards):
    """Run the engine's fused exec with the packed value slots replaced."""
    rows, cols, packed_vals = eng.d_kernel
    args = (rows, cols, vals_shards.astype(packed_vals.dtype))
    if eng._identity_exchange:
        return eng._exec_jit(*args, b_shards)
    return eng._exec_jit(
        *args,
        eng.d_send_idx, eng.d_recv_dst, eng.d_self_src, eng.d_self_dst,
        b_shards,
    )


def _exchanged_b(eng: RowParaSpmm, b_shards):
    """The per-shard received-B buffer the local kernel consumes (rB)."""
    if eng._identity_exchange:
        return b_shards
    return eng._exchange_jit(
        eng.d_send_idx, eng.d_recv_dst, eng.d_self_src, eng.d_self_dst,
        b_shards,
    )


class ValueParameterizedSpmm:
    """``op(B_shards, vals) -> C_shards`` with gradients to B AND vals.

    Parameters mirror :class:`RowParaSpmm`.  ``vals`` is the global
    (nnz,) nonzero-value vector in A's CSR order; A's PATTERN stays
    static (plans, exchange, packing are all pattern-only).  ``sddmm``
    is also exposed standalone — it is the GAT attention primitive
    (sampled X @ Y^T at A's pattern).
    """

    CHUNK = 2048  # SDDMM slots per scan step (peak mem ~ 2*CHUNK*n*4 B)

    def __init__(
        self,
        a,
        A_row_displs,
        B_row_displs,
        glb_n: int,
        mesh=None,
        config: Optional[SpmmConfig] = None,
        dtype=np.float32,
    ) -> None:
        import dataclasses

        config = config or SpmmConfig(kernel="segsum", dtype="float32")
        if config.kernel == "auto":
            config = dataclasses.replace(config, kernel="segsum")
        if config.kernel != "segsum":
            raise ValueError(
                "ValueParameterizedSpmm requires kernel='segsum' (the one "
                "value-slot-per-nonzero packed form); got "
                f"{config.kernel!r}"
            )
        if config.overlap:
            raise ValueError(
                "overlap=1 splits values into per-ring-step partitions; "
                "use the plain exchange for value-parameterized exec"
            )
        if config.bc_layout:
            raise ValueError("ValueParameterizedSpmm takes row-major B")
        self.dtype = np.dtype(dtype)
        self.fwd = RowParaSpmm(
            a, A_row_displs, B_row_displs, glb_n,
            mesh=mesh, config=config, dtype=dtype,
        )
        self.bwd = RowParaSpmm(
            a.transpose(), self.fwd.B_row_displs, self.fwd.A_row_displs,
            glb_n, mesh=self.fwd.mesh, config=config, dtype=dtype,
        )
        assert self.fwd.kernel_kind == "segsum", self.fwd.kernel_kind
        assert self.bwd.kernel_kind == "segsum", self.bwd.kernel_kind

        self.nnz = int(a.nnz)
        p = self.fwd.p
        fd = self.fwd.A_row_displs
        # slot q of fwd shard i <-> global nonzero fwd_rng[i][0] + q
        self._fwd_rng = [
            (int(a.rowptr[int(fd[i])]), int(a.rowptr[int(fd[i + 1])]))
            for i in range(p)
        ]
        self._fwd_nnz_pad = int(self.fwd.d_kernel[0].shape[1])

        # bwd slot q of shard i <-> A^T nonzero t = at.rowptr[td[i]] + q
        # <-> A nonzero order[t] (transpose's stable counting sort)
        order = np.argsort(np.asarray(a.colidx), kind="stable")
        at_rowptr = np.zeros(a.ncol + 1, dtype=np.int64)
        np.cumsum(
            np.bincount(np.asarray(a.colidx), minlength=a.ncol),
            out=at_rowptr[1:],
        )
        td = self.bwd.A_row_displs
        bwd_nnz_pad = int(self.bwd.d_kernel[0].shape[1])
        gat = np.full((p, bwd_nnz_pad), self.nnz, dtype=np.int32)
        for i in range(p):
            lo = int(at_rowptr[min(int(td[i]), a.ncol)])
            hi = int(at_rowptr[min(int(td[i + 1]), a.ncol)])
            gat[i, : hi - lo] = order[lo:hi]
        self._d_bwd_gather = jax.device_put(
            gat,
            NamedSharding(self.fwd.mesh, P(self.fwd.axis, None)),
        )

        # SDDMM gather maps: the packed segsum slot arrays, zero-padded
        # up to a CHUNK multiple and pre-folded into (p, S, CHUNK)
        ch = self.CHUNK
        np2 = max(-(-self._fwd_nnz_pad // ch) * ch, ch)
        rows, cols = self.fwd.d_kernel[0], self.fwd.d_kernel[1]
        pad = ((0, 0), (0, np2 - self._fwd_nnz_pad))
        self._rows3 = jnp.pad(
            rows, pad, constant_values=self.fwd.max_m
        ).reshape(p, np2 // ch, ch)
        self._cols3 = jnp.pad(cols, pad).reshape(p, np2 // ch, ch)

        fwd_eng, bwd_eng = self.fwd, self.bwd
        in_rows, bwd_in = self.fwd.max_k, self.bwd.max_k
        obj = self

        @jax.custom_vjp
        def op(bs, vals):
            return _exec_with_vals(fwd_eng, obj._stack_fwd_vals(vals), bs)

        def op_fwd(bs, vals):
            return op(bs, vals), (bs, vals)

        def op_bwd(res, dc):
            bs, vals = res
            vext = jnp.concatenate(
                [vals.astype(obj.dtype), jnp.zeros((1,), obj.dtype)]
            )
            db = _exec_with_vals(
                bwd_eng,
                jnp.take(vext, obj._d_bwd_gather, axis=0),
                _repad_rows(dc, bwd_in),
            )
            dvals = obj._sddmm_shards(dc, _exchanged_b(fwd_eng, bs))
            return _repad_rows(db, in_rows), dvals.astype(vals.dtype)

        op.defvjp(op_fwd, op_bwd)
        self.op = op

    # ----------------------------------------------------------- internals
    def _stack_fwd_vals(self, vals):
        """Global (nnz,) values -> the fwd engine's (p, nnz_pad) slots."""
        np_ = self._fwd_nnz_pad
        parts = []
        for s, e in self._fwd_rng:
            seg = vals[s:e].astype(self.dtype)
            parts.append(jnp.pad(seg, (0, np_ - (e - s))))
        return jnp.stack(parts)

    def _sddmm_shards(self, dc, rb):
        """Per-slot dot(dC[row], rB[col]) -> global (nnz,) in A order."""
        mask_lim = dc.shape[1]

        def step(_, rc):
            r, c = rc  # (p, CHUNK) each
            gd = jnp.take_along_axis(
                dc, r[:, :, None], axis=1, mode="clip"
            ).astype(jnp.float32)
            gb = jnp.take_along_axis(
                rb, c[:, :, None], axis=1, mode="clip"
            ).astype(jnp.float32)
            valid = (r < mask_lim).astype(jnp.float32)
            return None, jnp.sum(gd * gb, axis=-1) * valid

        _, ys = jax.lax.scan(
            step, None,
            (self._rows3.transpose(1, 0, 2), self._cols3.transpose(1, 0, 2)),
        )
        slot = ys.transpose(1, 0, 2).reshape(self._rows3.shape[0], -1)
        # shard i's real slots are the contiguous global ids [s, e)
        return jnp.concatenate(
            [slot[i, : e - s] for i, (s, e) in enumerate(self._fwd_rng)]
        )

    # ----------------------------------------------------------------- host
    def shard_b(self, b: np.ndarray):
        return self.fwd.shard_b(b)

    def unshard_c(self, c_shards) -> np.ndarray:
        return self.fwd.unshard_c(c_shards)

    def unshard_db(self, db_shards) -> np.ndarray:
        from ..shard.layout import unshard_dense_rows

        db = unshard_dense_rows(np.asarray(db_shards), self.fwd.B_row_displs)
        return db[: int(self.fwd.B_row_displs[-1])]

    # ------------------------------------------------------------- GAT/SDDMM
    def sddmm(self, x_shards, y_shards) -> jax.Array:
        """Sampled ``X @ Y^T`` at A's pattern: ``out[q] = dot(X[row_q, :],
        Y[col_q, :])`` for each nonzero q, returned as a global (nnz,)
        vector in A's CSR order.

        ``x_shards`` is row-sharded like C (A's row blocks, ``shard_b``-
        style stacking at ``max_m`` rows); ``y_shards`` like B (ownership
        blocks).  Y rows cross shard boundaries through the engine's
        planned sparsity-aware exchange — the same comm volume as one
        SpMM exec's B exchange, which is minimal for the pattern.  This
        is the GAT attention-score primitive (and the dv of the VJP).
        """
        return self._sddmm_shards(x_shards, _exchanged_b(self.fwd, y_shards))
