"""CrpSpmm — the any-layout end-to-end engine (v1 ``crpspmm_engine``).

Counterpart of ``deprecated/src/crpspmm.{h,c}``: the user hands
over B in arbitrary per-device 2D blocks and wants C back in arbitrary 2D
blocks; the engine

  1. plans an ``np_row x np_col`` grid with the bandwidth-bound planner
     (``crpspmm.c:133-195`` -> ``plan.bandwidth``),
  2. reshards B from the user layout to the internal k-slab x n-slab layout
     (``rd_B`` -> ``shard.redist.RedistEngine``),
  3. exchanges B rows along the grid columns so every device holds its row
     panel's window — coarse contiguous [min_col, max_col] ranges or exact
     referenced rows under ``A2A_B_FINEGRAIN`` (``crpspmm.c:294-396`` ->
     ``comm.exchange`` driven by plan-time row lists),
  4. runs the local SpMM kernel (MKL/cuSPARSE -> ``kernels.dispatch``),
  5. reshards C to the user layout (``rd_C``).

A may arrive either as a host-global ``CSRMatrix`` (the planner holds A;
panels are placed replicated along ``pn`` at init) or *already distributed*
as per-device row-range blocks (:class:`~crp_tpu.shard.dist_a.DistCSR`,
the v1 ``src_A_*`` arguments): then only O(m) metadata is assembled on the
host, and the O(nnz) payload moves with device collectives — the
``rd_Ai``/``rd_Av`` nnz-vector reshard plus the Allgatherv-A panel assembly
(``crpspmm.c:240-265,559-584`` -> ``shard.dist_a.ingest_dist_a``).  The
comm volumes are computed and reported exactly as the reference audit does
(``crpspmm.c:448-456``), including the "Alltoallv B necessary"
minimal-volume metric (``crpspmm.c:587-600``).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..config import SpmmConfig, engine_dtype
from ..comm.exchange import build_b_exchange, exchange_b, exchange_b_ring
from ..kernels.dispatch import pack_local_kernel, resolve_auto_kernel
from ..plan.bandwidth import calc_bandwidth_part2d
from ..shard.layout import make_mesh_2d
from ..shard.redist import BlockDist, RedistEngine
from ..utils.blocks import uniform_displs
from ..utils.timers import Timer


class CrpSpmm:
    """init(A, n, user layouts) / exec(B blocks) -> C blocks."""

    def __init__(
        self,
        a,                        # global CSRMatrix (m x k) or DistCSR blocks
        n: int,
        user_B: BlockDist,        # p user-owned B blocks (k x n coordinates)
        user_C: BlockDist,        # p user-owned C blocks (m x n coordinates)
        nproc: Optional[int] = None,
        mesh: Optional[jax.sharding.Mesh] = None,
        config: Optional[SpmmConfig] = None,
        dtype=None,  # default: SpmmConfig.dtype
        bplan=None,  # precomputed BandwidthPlan (skips re-planning)
    ) -> None:
        self.config = config or SpmmConfig()
        if self.config.bc_layout:
            raise ValueError(
                "BC_layout=1 is a RowParaSpmm feature (the reference's "
                "rp_spmm seam); this engine takes row-major (k, n)/(m, n)"
            )
        self.a = a
        self.m, self.k, self.n = a.nrow, a.ncol, n
        self.nproc = nproc or user_B.p
        assert user_B.p == self.nproc and user_C.p == self.nproc
        self.dtype = engine_dtype(dtype, self.config)
        self.timer = Timer()
        t0 = Timer()
        with t0.phase("init"):
            self._build(a, user_B, user_C, mesh, bplan)
        self.t_init = t0.t["init"]

    # ------------------------------------------------------------------ init
    def _build(self, a, user_B, user_C, mesh, bplan=None) -> None:
        p = self.nproc
        from ..shard.dist_a import DistCSR, ingest_dist_a

        is_dist = isinstance(a, DistCSR)
        # 1. bandwidth-bound planner (v1, crpspmm.c:133-195) — or a plan
        # the caller already computed (the CLIs plan first for the mesh).
        # For distributed A only the O(m) metadata is assembled host-side
        # (crpspmm.c:90-131): global rowptr + per-row colidx ranges.
        grp = a.global_rowptr() if is_dist else a.rowptr
        bp = bplan if bplan is not None else calc_bandwidth_part2d(
            p, self.m, self.n, self.k, grp, a.row_col_ranges_v1()
        )
        self.bplan = bp
        pm, pn = bp.np_row, bp.np_col
        self.pm, self.pn = pm, pn
        self.mesh = mesh if mesh is not None else make_mesh_2d(pm, pn)

        # kernel + schedule switches (crpspmm.c honors its MKL/cuSPARSE and
        # finegrain modes everywhere; this engine honors its kernel,
        # rb_p2p and overlap switches here too)
        self.overlap = bool(self.config.overlap)
        fine = bool(self.config.a2a_b_finegrain)
        self.fine = fine
        kind = self.config.kernel
        if kind == "auto":
            kind = resolve_auto_kernel(self.dtype)
        self.is_dd = kind == "dd"
        if self.is_dd and self.overlap:
            raise ValueError(
                "kernel='dd' is incompatible with overlap=1: the per-shift "
                "partial SpMM is plain fp32 and would lose the dd accuracy"
            )

        # internal layouts
        rd_rows = bp.B_rd_row_displs          # (pm+1,) uniform k slabs
        bc_cols = bp.BC_colptr                # (pn+1,) uniform n slabs
        m_idx = bp.m_split_idx

        # A row panels (step 3's A side).
        # Host-global A: panels sliced host-side, replicated by placement.
        # Distributed A: the real device path — rd_Ai/rd_Av nnz reshard +
        # all_gather along pn (crpspmm.c:240-265,559-584).
        if is_dist:
            panels, self.nelem_A_rd, self.nelem_A_agv = ingest_dist_a(
                a, m_idx, pm, pn, self.mesh, val_dtype=self.dtype
            )
        else:
            panels = [
                a.row_slice(int(m_idx[i]), int(m_idx[i + 1]))
                for i in range(pm)
            ]
            self.nelem_A_rd = int(a.nnz)
            panel_nnz0 = np.array([pl_.nnz for pl_ in panels], dtype=np.int64)
            self.nelem_A_agv = 0 if pn == 1 else int(panel_nnz0.sum() * pn)
        self.max_m = max(max(pl_.nrow for pl_ in panels), 1)

        internal_B = BlockDist.from_grid(rd_rows, bc_cols)
        internal_C = BlockDist.from_grid(m_idx, bc_cols)

        # 2. rd_B, 5. rd_C.  Under dd, B/C travel as fp32 hi/lo halves and
        # each redistribution runs twice per exec (one per half) — the
        # logical element counts in the audit are unchanged.
        rd_dtype = np.float32 if self.is_dd else self.dtype
        self.rd_B = RedistEngine(user_B, internal_B, self.mesh, dtype=rd_dtype)
        self.rd_C = RedistEngine(internal_C, user_C, self.mesh, dtype=rd_dtype)

        # 3. B-row exchange along pm within each column group.
        if fine:
            row_lists = [pl_.colidx for pl_ in panels]
        else:
            # coarse: the contiguous window from per-row colidx ranges
            row_lists = [
                np.arange(bp.B_windows[i, 0], bp.B_windows[i, 1])
                for i in range(pm)
            ]
        self.xplan = build_b_exchange(row_lists, rd_rows, reidx=fine)

        self.max_k = int(max(np.diff(rd_rows).max(), 1))
        self.max_nloc = int(max(np.diff(bc_cols).max(), 1))

        def put_pm(x):
            return jax.device_put(
                x, NamedSharding(self.mesh, P("pm", *([None] * (x.ndim - 1))))
            )

        if self.overlap:
            from ..comm.ring import build_ring_spmm

            self.ring = build_ring_spmm(
                panels, self.xplan, rd_rows, self.max_m, self.dtype, kind,
            )
            self.kernel_kind = self.ring.self_kind
            self.d_kernel = tuple(put_pm(x) for x in self.ring.self_arrays)
            self._kernel_specs = tuple(
                P("pm", *([None] * (x.ndim - 1)))
                for x in self.ring.self_arrays
            )
            self.d_step = tuple(
                put_pm(a) for a in
                (self.ring.step_rows, self.ring.step_cols, self.ring.step_vals)
            )
            self.d_send_idx = put_pm(self.xplan.send_idx)
        else:
            # compact panel colidx into the exchange buffer space
            shards_compact = []
            for i, s in enumerate(panels):
                if fine:
                    cc = np.searchsorted(
                        self.xplan.rowmap[i], s.colidx
                    ).astype(np.int32)
                else:
                    cc = (s.colidx - int(self.xplan.rowmap[i])).astype(np.int32)
                shards_compact.append((s.rowptr, cc, s.val))
            arrays, self._local_fn = pack_local_kernel(
                shards_compact, self.max_m, self.dtype, kind,
            )
            self.kernel_kind = kind
            self._rb_rows = max(self.xplan.rB_nrow_max, 1)
            self.d_kernel = tuple(put_pm(x) for x in arrays)
            self._kernel_specs = tuple(
                P("pm", *([None] * (x.ndim - 1))) for x in arrays
            )
            self.d_send_idx = put_pm(self.xplan.send_idx)
            self.d_recv_dst = put_pm(self.xplan.recv_dst)
            self.d_self_src = put_pm(self.xplan.self_src)
            self.d_self_dst = put_pm(self.xplan.self_dst)

        self._spmm_jit = self._make_spmm()
        if not self.overlap:
            self._xch_jit, self._spmm_only_jit = self._make_staged()

        # ------- audit (crpspmm.c:448-456, 587-600); A counters set above
        loc_ncols = np.diff(bc_cols)
        self.nelem_B_rd = self.rd_B.nelem_dst
        if pm == 1:
            self.nelem_B_a2av = 0
        elif fine:
            # all requested rows incl. self-owned, x local width
            req_rows = np.array(
                [len(np.unique(pl_.colidx)) for pl_ in panels], dtype=np.int64
            )
            self.nelem_B_a2av = int((req_rows[:, None] * loc_ncols[None, :]).sum())
        else:
            win = (bp.B_windows[:, 1] - bp.B_windows[:, 0]).astype(np.int64)
            self.nelem_B_a2av = int((win[:, None] * loc_ncols[None, :]).sum())
        req_rows_min = np.array(
            [len(np.unique(pl_.colidx)) for pl_ in panels], dtype=np.int64
        )
        self.nelem_B_a2av_min = int(
            (req_rows_min[:, None] * loc_ncols[None, :]).sum()
        )

    def _make_spmm(self):
        pmspec = P("pm", None)
        bspec = P("pm", "pn", None, None)
        max_m = self.max_m

        nk = len(self.d_kernel)

        if self.overlap:
            from ..comm.ring import ring_spmm

            self_fn = self.ring.self_fn

            def local(*args):
                kernel = tuple(x[0] for x in args[:nk])
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
        else:
            rB_nrow_max = self._rb_rows
            local_fn = self._local_fn
            xch_fn = exchange_b_ring if self.config.rb_p2p else exchange_b

            def local(*args):
                kernel = tuple(x[0] for x in args[:nk])
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

    def _make_staged(self):
        """Exchange and local SpMM as separate jitted stages, so exec() can
        fence and time them truthfully (the reference's ``t_a2a_B`` vs
        ``t_spmm`` split, ``crpspmm.c:602-665``)."""
        rB_nrow_max = self._rb_rows
        local_fn = self._local_fn
        nk = len(self.d_kernel)
        pmspec = P("pm", None)
        bspec = P("pm", "pn", None, None)
        xch_impl = exchange_b_ring if self.config.rb_p2p else exchange_b

        def xch(send_idx, recv_dst, self_src, self_dst, b_loc):
            return xch_impl(
                b_loc[0, 0], send_idx[0], recv_dst[0], self_src[0],
                self_dst[0], rB_nrow_max, "pm",
            )[None, None]

        def spmm(*args):
            kernel = tuple(x[0] for x in args[:nk])
            return local_fn(kernel, args[nk][0, 0])[None, None]

        xch_fn = jax.jit(jax.shard_map(
            xch, mesh=self.mesh,
            in_specs=(P("pm", None, None), P("pm", None, None), pmspec,
                      pmspec, bspec),
            out_specs=bspec, check_vma=False,
        ))
        spmm_fn = jax.jit(jax.shard_map(
            spmm, mesh=self.mesh,
            in_specs=self._kernel_specs + (bspec,),
            out_specs=bspec, check_vma=False,
        ))
        return xch_fn, spmm_fn

    # ------------------------------------------------------------------ exec
    def _spmm_fused(self, b4: jax.Array) -> jax.Array:
        if self.overlap:
            return self._spmm_jit(
                *self.d_kernel, *self.d_step, self.d_send_idx, b4
            )
        return self._spmm_jit(
            *self.d_kernel,
            self.d_send_idx, self.d_recv_dst, self.d_self_src, self.d_self_dst,
            b4,
        )

    def exec_device(self, b_user_shards: jax.Array) -> jax.Array:
        """(p, userB_max_h, userB_max_w) -> (p, userC_max_h, userC_max_w).

        Fused path: exchange + SpMM in one jit; staged phase timing lives in
        :meth:`exec`.  Under dd the shards must already carry packed hi/lo
        halves (width ``2 * userB_max_w``) — use :meth:`exec` from host data.
        """
        t = self.timer
        with t.phase("rd_B"):
            b_int = self.rd_B.exec_device(b_user_shards)
            b_int.block_until_ready()
        b4 = b_int.reshape(self.pm, self.pn, self.max_k, -1)
        with t.phase("exec_nr"):  # exchange + SpMM, fused in one jit here
            c4 = self._spmm_fused(b4)
            with t.phase("spmm", fence=c4):
                pass
        with t.phase("rd_C"):
            c_int = c4.reshape(self.pm * self.pn, self.max_m, -1)
            out = self.rd_C.exec_device(c_int)
            out.block_until_ready()
        t.n_exec += 1
        return out

    def exec(self, b: np.ndarray) -> np.ndarray:
        """Host global B (k, n) -> host global C (m, n), via the user layouts.

        Phases are staged and fenced per stage, reproducing the reference's
        timed pipeline (``crpspmm.c:522-689``): rd_B -> a2a_B -> local SpMM
        -> rd_C (A moved once at init; overlap mode fuses a2a_B + SpMM by
        design and reports them as one SpMM phase).
        """
        import jax.numpy as jnp

        t = self.timer
        with t.phase("exec"):
            if self.is_dd:
                from ..kernels.spmm_dd import split_f64

                bhi, blo = split_f64(np.asarray(b, dtype=np.float64))
                with t.phase("rd_B"):
                    hi = self.rd_B.exec_device(self.rd_B.shard_src(bhi))
                    lo = self.rd_B.exec_device(self.rd_B.shard_src(blo))
                    hi.block_until_ready(); lo.block_until_ready()
                # pack [hi | lo] halves per internal block (midpoint split)
                b4 = jnp.concatenate(
                    [hi.reshape(self.pm, self.pn, self.max_k, self.max_nloc),
                     lo.reshape(self.pm, self.pn, self.max_k, self.max_nloc)],
                    axis=-1,
                )
            else:
                bs = self.rd_B.shard_src(np.asarray(b, dtype=self.dtype))
                with t.phase("rd_B"):
                    b_int = self.rd_B.exec_device(bs)
                    b_int.block_until_ready()
                b4 = b_int.reshape(self.pm, self.pn, self.max_k, self.max_nloc)

            if self.overlap:
                with t.phase("exec_nr"):  # exchange fused into the ring
                    c4 = self._spmm_fused(b4)
                    with t.phase("spmm", fence=c4):
                        pass
            else:
                with t.phase("exec_nr"):  # reference t_exec_nr: a2a + spmm
                    with t.phase("a2a_B"):
                        rB4 = self._xch_jit(
                            self.d_send_idx, self.d_recv_dst,
                            self.d_self_src, self.d_self_dst, b4,
                        )
                        rB4.block_until_ready()
                    with t.phase("spmm"):
                        c4 = self._spmm_only_jit(*self.d_kernel, rB4)
                        c4.block_until_ready()

            if self.is_dd:
                with t.phase("rd_C"):
                    chi = self.rd_C.exec_device(
                        c4[..., : self.max_nloc].reshape(
                            self.pm * self.pn, self.max_m, self.max_nloc
                        )
                    )
                    clo = self.rd_C.exec_device(
                        c4[..., self.max_nloc :].reshape(
                            self.pm * self.pn, self.max_m, self.max_nloc
                        )
                    )
                    chi.block_until_ready(); clo.block_until_ready()
                out = (
                    self.rd_C.unshard_dst(chi, self.m, self.n).astype(np.float64)
                    + self.rd_C.unshard_dst(clo, self.m, self.n)
                )
            else:
                with t.phase("rd_C"):
                    c_int = c4.reshape(
                        self.pm * self.pn, self.max_m, self.max_nloc
                    )
                    cs = self.rd_C.exec_device(c_int)
                    cs.block_until_ready()
                out = self.rd_C.unshard_dst(cs, self.m, self.n)
        t.n_exec += 1
        return out

    # ----------------------------------------------------------------- stats
    def print_stat(self) -> str:
        """Runtime + communicated-elements tables in the shape of
        ``crpspmm_engine_print_stat`` (``crpspmm.c:715-772``): the same
        rows, with min/avg/max across execs (the reference reduces across
        ranks; phases here are host-fenced wall clock).  A moves once at
        init, so its per-exec redist/allgather rows read zero."""
        t = self.timer
        ne = max(t.n_exec, 1)

        def row(label, key):
            return (
                f"{label} {t.min(key):6.3f}      "
                f"{t.t.get(key, 0.0)/ne:6.3f}      {t.max(key):6.3f}"
            )

        # "SpMM w/o Redist" (reference t_exec_nr) is a real measured phase
        # wrapping exchange + local SpMM in both exec() and exec_device()
        lines = [
            f"crpspmm_engine init time: {self.t_init:.3f} s",
            "-------------------------- Runtime (s) -------------------------",
            "                                   min         avg         max",
            row("Redist A to internal 1D layout ", "rd_A"),
            row("Redist B to internal 2D layout ", "rd_B"),
            row("Replicate A with allgatherv    ", "agv_A"),
            row("Replicate B with alltoallv     ", "a2a_B"),
            row("Local SpMM                     ", "spmm"),
            row("SpMM w/o Redist                ", "exec_nr"),
            row("Redist C to user's 2D layout   ", "rd_C"),
            row(f"SpMM total (avg of {t.n_exec:3d} runs)   ", "exec"),
            "------------------ Communicated Matrix Elements -----------------",
            "                                       sum",
            f"Redist A                {self.nelem_A_rd:>15}",
            f"Allgatherv A            {self.nelem_A_agv:>15}",
            f"Redist B                {self.nelem_B_rd:>15}",
            f"Alltoallv B             {self.nelem_B_a2av:>15}",
            f"Alltoallv B necessary   {self.nelem_B_a2av_min:>15}",
        ]
        return "\n".join(lines)

    def clear_stat(self) -> None:
        self.timer.clear()
