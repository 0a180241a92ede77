"""2D (pm x pn) SpMM engine.

Counterpart of ``para2d_spmm`` (``src/para2d_spmm.{h,c}``): the
planner's ``pm x pn`` grid maps onto a 2D device mesh; A row panels are
replicated along the ``pn`` axis, B/C are row-partitioned over ``pm`` (by the
plan's nnz-aware boundaries) and column-partitioned over ``pn``; each of the
``pn`` column groups runs the 1D sparsity-aware B-row exchange along ``pm``
and the local SpMM kernel.

Replication of A happens at engine init.  The reference does it with two
overlapped ``MPI_Iallgatherv`` calls (``src/para2d_spmm.c:47-100``); here the
planner holds the global matrix, so init places each row panel's CSR arrays
with a sharding that is *replicated over pn* — XLA materializes the broadcast
along the pn axis at placement time.  The replication cost is still reported
in the audit exactly as the reference does (``src/para2d_spmm.c:102-109``).

Exec is one jitted shard_map over ('pm', 'pn'):
exchange-B along pm -> local SpMM, identically in every column group.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P


from ..config import SpmmConfig, engine_dtype
from ..comm.exchange import build_b_exchange, exchange_b, exchange_b_ring
from ..comm.ring import build_ring_spmm, ring_spmm
from ..kernels.dispatch import pack_local_kernel, resolve_auto_kernel
from ..plan.planner2d import Plan2D, NNZ_COST_FACTOR
from ..shard.layout import make_mesh_2d
from ..utils.timers import Timer
from .stats import format_stat_table


class Para2dSpmm:
    """init(A, plan)/exec(B)->C on a pm x pn mesh."""

    def __init__(
        self,
        a,                    # global CSRMatrix
        plan: Plan2D,
        mesh: Optional[jax.sharding.Mesh] = None,
        config: Optional[SpmmConfig] = None,
        dtype=None,  # default: SpmmConfig.dtype
    ) -> None:
        self.config = config or SpmmConfig()
        if self.config.bc_layout:
            raise ValueError(
                "BC_layout=1 is a RowParaSpmm feature (the reference's "
                "rp_spmm seam); this engine takes row-major (k, n)/(m, n)"
            )
        self.plan = plan
        self.pm, self.pn = plan.pm, plan.pn
        self.glb_n = plan.n
        self.dtype = engine_dtype(dtype, self.config)
        self.mesh = mesh if mesh is not None else make_mesh_2d(self.pm, self.pn)
        self.timer = Timer()
        t0 = Timer()
        self._t_build = Timer()
        with t0.phase("init"):
            self._build(a)
        self.t_init = t0.t["init"]
        tb = self._t_build
        self.init_breakdown = {
            k: round(tb.t.get(k, 0.0), 4) for k in ("plan", "pack", "upload")
        }

    # ------------------------------------------------------------------ init
    @classmethod
    def from_dist_a(
        cls,
        dist,                 # shard.dist_a.DistCSR in the plan's A0 layout
        plan: Plan2D,
        mesh: Optional[jax.sharding.Mesh] = None,
        config: Optional[SpmmConfig] = None,
        dtype=None,
    ) -> "Para2dSpmm":
        """Init from *distributed* A: device ``i*pn+j`` owns A0 block
        ``i*pn+j`` (the layout ``scatter_csr_rows`` produces,
        ``examples/test_utils.c:57-119``); panels are assembled with a
        device-side ``all_gather`` along pn — the two overlapped
        ``MPI_Iallgatherv`` of ``para2d_spmm_init``
        (``src/para2d_spmm.c:47-100``).  Never builds a host-global A."""
        self = cls.__new__(cls)
        self.config = config or SpmmConfig()
        if self.config.bc_layout:
            raise ValueError(
                "BC_layout=1 is a RowParaSpmm feature (the reference's "
                "rp_spmm seam); this engine takes row-major (k, n)/(m, n)"
            )
        self.plan = plan
        self.pm, self.pn = plan.pm, plan.pn
        self.glb_n = plan.n
        self.dtype = engine_dtype(dtype, self.config)
        self.mesh = mesh if mesh is not None else make_mesh_2d(self.pm, self.pn)
        self.timer = Timer()
        t0 = Timer()
        self._t_build = Timer()
        with t0.phase("init"):
            from ..shard.dist_a import replicate_a0

            panels = replicate_a0(
                dist, plan.A0_rowptr, self.pm, self.pn, self.mesh,
                val_dtype=self.dtype,
            )
            # rA_cost audit comes from the LAST rank's block nnz
            # (src/para2d_spmm.c:102-109)
            last_blk_nnz = int(np.asarray(dist.rowptrs[-1][-1])) - int(
                np.asarray(dist.rowptrs[-1][0])
            )
            self._build_from_panels(panels, last_blk_nnz)
        self.t_init = t0.t["init"]
        tb = self._t_build
        self.init_breakdown = {
            k: round(tb.t.get(k, 0.0), 4) for k in ("plan", "pack", "upload")
        }
        return self

    def _build(self, a) -> None:
        plan = self.plan
        panels = [
            a.row_slice(int(plan.AC_rowptr[i]), int(plan.AC_rowptr[i + 1]))
            for i in range(self.pm)
        ]
        last_blk_nnz = int(
            a.rowptr[plan.A0_rowptr[-1]] - a.rowptr[plan.A0_rowptr[-2]]
        )
        self._build_from_panels(panels, last_blk_nnz)

    def _build_from_panels(self, panels, last_blk_nnz: int) -> None:
        plan = self.plan
        pm, pn = self.pm, self.pn

        # Replicated-A row panels (one per pm row, shared by the pn group)
        self.max_m = max(max(p_.nrow for p_ in panels), 1)

        # B ownership must cover every column of A; the planner's B_rowptr
        # copies the nnz-balanced row blocks verbatim for m == k (reference
        # spmat_part.c:175-178), which exclude trailing empty rows — extend
        # internally (plan arrays stay reference-identical for the oracle)
        self._B_displs = np.asarray(plan.B_rowptr, dtype=np.int64).copy()
        if int(self._B_displs[-1]) < plan.k:
            self._B_displs[-1] = plan.k

        reidx = bool(self.config.rb_reidx)
        with self._t_build.phase("plan"):
            self.xplan = build_b_exchange(
                [p_.colidx for p_ in panels], self._B_displs, reidx=reidx
            )
        kind = self.config.kernel
        if kind == "auto":
            kind = resolve_auto_kernel(self.dtype)
        self.overlap = bool(self.config.overlap)
        self.is_dd = kind == "dd"
        if self.is_dd and self.overlap:
            raise ValueError(
                "kernel='dd' is incompatible with overlap=1: the per-shift "
                "partial SpMM is plain fp32 and would lose the dd accuracy"
            )
        self.max_k = int(max(np.diff(self._B_displs).max(), 1))
        self._identity_exchange = False

        # P('pm', None, ...): replicated along pn — the all-gather-A equivalent
        def put_pm(a):
            return jax.device_put(
                a, NamedSharding(self.mesh, P("pm", *([None] * (a.ndim - 1))))
            )

        if self.overlap:
            with self._t_build.phase("pack"):
                self.ring = build_ring_spmm(
                    panels, self.xplan, self._B_displs, self.max_m,
                    self.dtype, kind,
                )
            self.d_kernel = tuple(put_pm(a) for a in self.ring.self_arrays)
            self._kernel_specs = tuple(
                P("pm", *([None] * (a.ndim - 1)))
                for a in self.ring.self_arrays
            )
            self.d_step = tuple(
                put_pm(a) for a in
                (self.ring.step_rows, self.ring.step_cols, self.ring.step_vals)
            )
            self.d_send_idx = put_pm(self.xplan.send_idx)
        else:
            shards_compact = []
            for i, s in enumerate(panels):
                if reidx:
                    cc = np.searchsorted(
                        self.xplan.rowmap[i], s.colidx
                    ).astype(np.int32)
                else:
                    cc = (s.colidx - int(self.xplan.rowmap[i])).astype(np.int32)
                shards_compact.append((s.rowptr, cc, s.val))
            with self._t_build.phase("pack"):
                arrays, self._local_fn = pack_local_kernel(
                    shards_compact, self.max_m, self.dtype, kind,
                )
            self._rb_rows = max(self.xplan.rB_nrow_max, 1)
            with self._t_build.phase("upload"):
                self.d_kernel = tuple(put_pm(a) for a in arrays)
                for x in self.d_kernel:
                    x.block_until_ready()
            self._kernel_specs = tuple(
                P("pm", *([None] * (a.ndim - 1))) for a in arrays
            )
            self._identity_exchange = (
                pm == 1
                and bool(self.config.rb_reidx)
                and len(self.xplan.rowmap[0]) == int(self._B_displs[-1])
            )
            if self._identity_exchange:
                self.max_k = max(self.max_k, self._rb_rows)
            else:
                self.d_send_idx = put_pm(self.xplan.send_idx)
                self.d_recv_dst = put_pm(self.xplan.recv_dst)
                self.d_self_src = put_pm(self.xplan.self_src)
                self.d_self_dst = put_pm(self.xplan.self_dst)
        # resolved kernel after auto-selection
        self.kernel_kind = kind
        self.max_nloc = int(max(np.diff(plan.BC_colptr).max(), 1))
        self.b_sharding = NamedSharding(self.mesh, P("pm", "pn", None, None))
        self._exec_jit = self._make_exec()

        # ------- audit (reference para2d_spmm.c:102-109, rowpara_spmm.c:149)
        self.rA_cost = int(
            float(last_blk_nnz) * float(pn - 1) * NNZ_COST_FACTOR
        )
        self.rB_recv_size = int(self.xplan.total_recv_rows)  # rows, x n when printed

    def _make_exec(self):
        pmspec = P("pm", None)
        bspec = P("pm", "pn", None, None)

        nk = len(self.d_kernel)

        if self.overlap:
            self_fn = self.ring.self_fn
            max_m = self.max_m

            def local(*args):
                kernel = tuple(a[0] for a in args[:nk])
                step_rows, step_cols, step_vals, send_idx, b_loc = args[nk:]
                c = ring_spmm(
                    b_loc[0, 0], send_idx[0], kernel, self_fn,
                    step_rows[0], step_cols[0], step_vals[0], max_m, "pm",
                )
                return c[None, None]

            in_specs = self._kernel_specs + (
                P("pm", None, None), P("pm", None, None), P("pm", None, None),
                P("pm", None, None), bspec,
            )
        elif self._identity_exchange:
            # pm == 1 with every B row referenced: the exchange along pm is
            # an identity copy — feed the owned slab straight to the kernel
            local_fn = self._local_fn

            def local(*args):
                kernel = tuple(a[0] for a in args[:nk])
                return local_fn(kernel, args[nk][0, 0])[None, None]

            in_specs = self._kernel_specs + (bspec,)
        else:
            rB_nrow_max = self._rb_rows
            local_fn = self._local_fn
            xch_fn = exchange_b_ring if self.config.rb_p2p else exchange_b

            def local(*args):
                # block shapes: (1, ..) over pm for A/plan; (1, 1, k, n) for B
                kernel = tuple(a[0] for a in args[:nk])
                send_idx, recv_dst, self_src, self_dst, b_loc = args[nk:]
                rB = xch_fn(
                    b_loc[0, 0], send_idx[0], recv_dst[0], self_src[0],
                    self_dst[0], rB_nrow_max, "pm",
                )
                return local_fn(kernel, rB)[None, None]

            in_specs = self._kernel_specs + (
                P("pm", None, None), P("pm", None, None), pmspec, pmspec,
                bspec,
            )

        fn = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=in_specs,
            out_specs=bspec,
            check_vma=False,
        )
        return jax.jit(fn)

    # ------------------------------------------------------------------ exec
    def shard_b(self, b: np.ndarray) -> jax.Array:
        """Global (k, n) -> (pm, pn, max_k, max_nloc) padded 2D blocks.

        With the dd kernel each block is split hi/lo into the fixed halves
        of a doubled-width slab ([.., :max_nloc] = hi, [.., max_nloc:] = lo)
        so the kernel's midpoint split stays aligned for narrow blocks.
        """
        plan = self.plan
        w = 2 * self.max_nloc if self.is_dd else self.max_nloc
        dt = np.float32 if self.is_dd else self.dtype
        out = np.zeros((self.pm, self.pn, self.max_k, w), dtype=dt)
        if self.is_dd:
            from ..kernels.spmm_dd import split_f64

            bhi, blo = split_f64(np.asarray(b, dtype=np.float64))
        row_displs = self._B_displs
        for i in range(self.pm):
            r0, r1 = int(row_displs[i]), int(row_displs[i + 1])
            for j in range(self.pn):
                c0, c1 = int(plan.BC_colptr[j]), int(plan.BC_colptr[j + 1])
                if self.is_dd:
                    out[i, j, : r1 - r0, : c1 - c0] = bhi[r0:r1, c0:c1]
                    out[i, j, : r1 - r0,
                        self.max_nloc : self.max_nloc + c1 - c0] = (
                        blo[r0:r1, c0:c1]
                    )
                else:
                    out[i, j, : r1 - r0, : c1 - c0] = b[r0:r1, c0:c1]
        return jax.device_put(out, self.b_sharding)

    def unshard_c(self, c_shards) -> np.ndarray:
        plan = self.plan
        c_shards = np.asarray(c_shards)
        dt = np.float64 if self.is_dd else c_shards.dtype
        out = np.zeros((plan.m, plan.n), dtype=dt)
        for i in range(self.pm):
            r0, r1 = int(plan.AC_rowptr[i]), int(plan.AC_rowptr[i + 1])
            for j in range(self.pn):
                c0, c1 = int(plan.BC_colptr[j]), int(plan.BC_colptr[j + 1])
                blk = c_shards[i, j]
                if self.is_dd:
                    out[r0:r1, c0:c1] = (
                        blk[: r1 - r0, : c1 - c0].astype(np.float64)
                        + blk[: r1 - r0,
                              self.max_nloc : self.max_nloc + c1 - c0
                              ].astype(np.float64)
                    )
                else:
                    out[r0:r1, c0:c1] = blk[: r1 - r0, : c1 - c0]
        return out

    def exec_device(self, b_shards: jax.Array) -> jax.Array:
        if self._identity_exchange:
            return self._exec_jit(*self.d_kernel, b_shards)
        if self.overlap:
            return self._exec_jit(
                *self.d_kernel, *self.d_step, self.d_send_idx, b_shards
            )
        return self._exec_jit(
            *self.d_kernel,
            self.d_send_idx, self.d_recv_dst, self.d_self_src, self.d_self_dst,
            b_shards,
        )

    def exec(self, b: np.ndarray) -> np.ndarray:
        with self.timer.phase("pack"):
            bs = self.shard_b(b)
            bs.block_until_ready()
        c = self.exec_device(bs)
        with self.timer.phase("exec", fence=c):
            pass
        self.timer.n_exec += 1
        with self.timer.phase("unpack"):
            out = self.unshard_c(c)
        return out

    # ----------------------------------------------------------------- stats
    def print_stat(self) -> str:
        """Merged table in the spirit of ``para2d_spmm_print_stat``
        (``src/para2d_spmm.c:150-198``)."""
        body = format_stat_table(
            title="para2d_spmm",
            t_init=self.t_init,
            timer=self.timer,
            comm_rows=self.rB_recv_size,
            glb_n=self.glb_n,
            physical_rows=(
                self.xplan.physical_rows_ring
                if (self.overlap or self.config.rb_p2p)
                else self.xplan.physical_rows
            ) * self.pn,
        )
        head = [
            f"Total comm size for replicating A = {self.rA_cost}",
            f"Total comm size for replicating B = {self.rB_recv_size * self.glb_n}",
            f"Total comm size for SpMM          = {self.rA_cost + self.rB_recv_size * self.glb_n}",
        ]
        return "\n".join(head) + "\n" + body

    def clear_stat(self) -> None:
        self.timer.clear()
