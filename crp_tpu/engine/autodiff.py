"""Differentiable sparse x dense SpMM (``jax.custom_vjp`` over the engines).

The reference is a standalone compute library — its drivers call
``*_spmm_exec`` and stop (``examples/test_rp_spmm.c:9-14``).  A JAX
framework composes with JAX's functional transforms instead: GNN-style
training multiplies activations by a *static* sparse adjacency every step
and needs gradients to flow through that product under ``jax.grad``/``jit``.

``C = A @ B`` is linear in B, so the VJP with respect to B is exact and
cheap: ``dB = A^T @ dC``.  Both directions run full planned engines —
sparsity-aware B-row exchange plus the local kernels — with ``A`` and
``A^T`` planned/packed once at init (``CSRMatrix.transpose`` is an O(nnz)
host counting sort).  Gradients with respect to A's values are not defined
(A is static data, matching the reference's usage; densifying dA would be
the wrong tool for a communication-reduced framework).

Layout note: the op consumes/produces the engines' stacked padded shard
form (the same arrays ``shard_b``/``exec_device`` use), so it can sit
inside a larger jitted computation without host round-trips.  The forward
C-shard layout (A row blocks) and the backward engine's input layout agree
block-for-block; trailing rows the backward layout adds (empty A rows the
nnz-balanced partition leaves out, ``src/spmat_part.c:20-33``) are padded
with zeros, which is exact — those C rows are identically zero.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SpmmConfig
from .rowpara import RowParaSpmm


def _repad_rows(x, rows: int):
    """Slice or zero-pad the per-shard row axis of (p, r, n) to ``rows``."""
    if x.shape[1] == rows:
        return x
    if x.shape[1] > rows:
        return x[:, :rows, :]
    return jnp.pad(x, ((0, 0), (0, rows - x.shape[1]), (0, 0)))


class DifferentiableSpmm:
    """``op(B_shards) -> C_shards`` with a custom VJP (dB = A^T @ dC).

    Parameters mirror :class:`RowParaSpmm`; the transposed engine reuses
    the same mesh and config.  The ``dd`` kind (which repacks B as hi/lo
    halves) and ``bc_layout`` (which changes the logical orientation) are
    rejected — their data layouts are not the plain (p, rows, n) shard
    form gradients flow through.
    """

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
        config = config or SpmmConfig(dtype="float32")
        if config.kernel == "dd":
            raise ValueError(
                "DifferentiableSpmm supports the plain-B kernel paths "
                "(auto/segsum/ell/triton); kernel='dd' repacks B"
            )
        if config.bc_layout:
            raise ValueError("DifferentiableSpmm takes row-major (k, n) B")
        self.fwd = RowParaSpmm(
            a, A_row_displs, B_row_displs, glb_n,
            mesh=mesh, config=config, dtype=dtype,
        )
        # A^T planned over the SAME mesh: its row blocks are the forward
        # B ownership (so dB lands in B's layout) and its B ownership is
        # the forward A row blocks (so it consumes dC's layout directly).
        self.bwd = RowParaSpmm(
            a.transpose(), self.fwd.B_row_displs, self.fwd.A_row_displs,
            glb_n, mesh=self.fwd.mesh, config=config, dtype=dtype,
        )
        in_rows = self.fwd.max_k        # shard_b pad height
        bwd_in = self.bwd.max_k         # backward receive-buffer height
        fwd_eng, bwd_eng = self.fwd, self.bwd

        @jax.custom_vjp
        def op(bs):
            return fwd_eng.exec_device(bs)

        def op_fwd(bs):
            return fwd_eng.exec_device(bs), None

        def op_bwd(_, dc):
            db = bwd_eng.exec_device(_repad_rows(dc, bwd_in))
            return (_repad_rows(db, in_rows),)

        op.defvjp(op_fwd, op_bwd)
        self.op = op

    # ---------------------------------------------------------------- host
    def shard_b(self, b: np.ndarray):
        return self.fwd.shard_b(b)

    def unshard_c(self, c_shards) -> np.ndarray:
        return self.fwd.unshard_c(c_shards)

    def unshard_db(self, db_shards) -> np.ndarray:
        """(p, rows, n) dB shards -> global (k, n) host gradient."""
        from ..shard.layout import unshard_dense_rows

        db = unshard_dense_rows(np.asarray(db_shards), self.fwd.B_row_displs)
        return db[: int(self.fwd.B_row_displs[-1])]
