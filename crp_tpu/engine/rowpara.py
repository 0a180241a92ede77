"""1D row-parallel SpMM engine.

Counterpart of ``rp_spmm`` (``src/rowpara_spmm.{h,c}``): A is
partitioned into p nnz-balanced row blocks (one per device along the ``pm``
mesh axis), B/C are row-partitioned by ownership; each exec performs the
plan-driven sparsity-aware B-row halo exchange (``comm.exchange``) followed
by the local SpMM kernel — all inside one jitted ``shard_map``.

Differences from the reference by design:
  * the needed-row index exchange (``MPI_Alltoall(v)``,
    ``src/rowpara_spmm.c:152-165``) happens at plan time on the host — the
    planner holds the global pattern, no startup collective is needed;
  * pack -> a2a -> unpack -> spmm are fused into one XLA program; a staged
    variant (``exec_timed``) fences per phase to reproduce the reference's
    stat table (``rp_spmm_print_stat``).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P


from ..config import SpmmConfig, engine_dtype
from ..comm.exchange import build_b_exchange, exchange_b, exchange_b_ring
from ..comm.ring import build_ring_spmm, ring_spmm
from ..kernels.dispatch import pack_local_kernel, resolve_auto_kernel
from ..shard.layout import make_mesh_1d, shard_dense_rows, unshard_dense_rows
from ..utils.timers import Timer
from .stats import format_stat_table


class RowParaSpmm:
    """init(plan)/exec(B)->C engine for 1D row-parallel SpMM."""

    def __init__(
        self,
        a,                      # global CSRMatrix
        A_row_displs,           # (p+1,) row blocks of A and C
        B_row_displs,           # (p+1,) ownership partition of B rows
        glb_n: int,
        mesh: Optional[jax.sharding.Mesh] = None,
        axis: str = "pm",
        config: Optional[SpmmConfig] = None,
        dtype=None,  # default: SpmmConfig.dtype
    ) -> None:
        self.config = config or SpmmConfig()
        self.A_row_displs = np.asarray(A_row_displs, dtype=np.int64)
        self.B_row_displs = np.asarray(B_row_displs, dtype=np.int64)
        self.p = len(self.A_row_displs) - 1
        self.glb_n = glb_n
        self.axis = axis
        self.dtype = engine_dtype(dtype, self.config)
        self.mesh = mesh if mesh is not None else make_mesh_1d(self.p, axis)
        self.glb_m = a.nrow
        self.timer = Timer()

        t0 = Timer()
        self._t_build = Timer()
        with t0.phase("init"):
            self._build(a)
        self.t_init = t0.t["init"]
        # plan/pack/upload split of init (the reference reports one init
        # number, src/rowpara_spmm.c:425; pack and upload get rows of
        # their own here)
        tb = self._t_build
        self.init_breakdown = {
            k: round(tb.t.get(k, 0.0), 4) for k in ("plan", "pack", "upload")
        }

    # ------------------------------------------------------------------ init
    def _build(self, a) -> None:
        p = self.p
        tb = self._t_build
        with tb.phase("plan"):
            shards = [
                a.row_slice(
                    int(self.A_row_displs[i]), int(self.A_row_displs[i + 1])
                )
                for i in range(p)
            ]
            self.max_m = max(max(s.nrow for s in shards), 1)

            # B ownership must cover every column of A; nnz-balanced row
            # blocks exclude trailing empty rows (reference
            # csr_mat_row_partition semantics), so extend the last boundary
            # when drivers reuse them as B displs on square matrices
            if int(self.B_row_displs[-1]) < a.ncol:
                self.B_row_displs = self.B_row_displs.copy()
                self.B_row_displs[-1] = a.ncol

            # B exchange plan from each shard's referenced global B rows
            reidx = bool(self.config.rb_reidx)
            self.xplan = build_b_exchange(
                [s.colidx for s in shards], self.B_row_displs, reidx=reidx
            )
        kind = self.config.kernel
        if kind == "auto":
            kind = resolve_auto_kernel(self.dtype)
        self.overlap = bool(self.config.overlap)
        self.is_dd = kind == "dd"
        if self.config.bc_layout and self.is_dd:
            # validate BEFORE the pack+upload, not after
            raise ValueError(
                "BC_layout=1 supports the standard kernel paths; dd packs "
                "B as hi/lo halves"
            )
        if self.is_dd and self.overlap:
            raise ValueError(
                "kernel='dd' is incompatible with overlap=1: the per-shift "
                "partial SpMM is plain fp32 and would lose the dd accuracy"
            )

        sharding = NamedSharding(self.mesh, P(self.axis))
        put = functools.partial(jax.device_put, device=sharding)
        self.max_k = int(max(np.diff(self.B_row_displs).max(), 1))
        self._identity_exchange = False

        if self.overlap:
            with tb.phase("pack"):
                self.ring = build_ring_spmm(
                    shards, self.xplan, self.B_row_displs, self.max_m,
                    self.dtype, kind,
                )
            self.d_kernel = tuple(put(a) for a in self.ring.self_arrays)
            self._kernel_specs = tuple(
                P(self.axis, *([None] * (a.ndim - 1)))
                for a in self.ring.self_arrays
            )
            self.d_step = tuple(
                put(a) for a in
                (self.ring.step_rows, self.ring.step_cols, self.ring.step_vals)
            )
            self.d_send_idx = put(self.xplan.send_idx)
        else:
            # memoize the pack + device upload on the matrix object: the
            # packed arrays depend only on (matrix content, partition,
            # kernel, dtype) — an n-sweep or repeated init re-uses them.
            # Content is keyed by full digests of rowptr/colidx/val
            # (blake2b streams ~1 GB/s over the warm arrays — small next to
            # the pack itself, and in-place edits such as
            # plan_from_csr(method="metis")'s permute can never slip
            # through).  At most ONE entry is kept: a new key evicts the old
            # pack so multi-config sweeps on a big matrix don't accumulate
            # device arrays (the entry holds live device references).
            import hashlib

            def _digest(*arrs):
                h = hashlib.blake2b(digest_size=16)
                for x in arrs:
                    h.update(np.ascontiguousarray(x))
                return h.digest()

            cache_key = (
                "rowpara_pack", kind, str(self.dtype), reidx, self.axis,
                self.A_row_displs.tobytes(), self.B_row_displs.tobytes(),
                tuple(d.id for d in self.mesh.devices.flat),
                a.nnz,
                _digest(a.rowptr, a.colidx, a.val),
            )
            cache = getattr(a, "_pack_cache", None)
            if cache is None:
                cache = a._pack_cache = {}
            if cache_key in cache:
                self._local_fn, self.d_kernel = cache[cache_key]
            else:
                cache.clear()  # single-slot: drop the old pack's device refs
                # compact local column indices into the rB coordinate
                # space (cache misses only — O(nnz) remap + copies)
                shards_compact = []
                for i, s in enumerate(shards):
                    if reidx:
                        cc = np.searchsorted(
                            self.xplan.rowmap[i], s.colidx
                        ).astype(np.int32)
                    else:
                        cc = (
                            s.colidx - int(self.xplan.rowmap[i])
                        ).astype(np.int32)
                    shards_compact.append((s.rowptr, cc, s.val))
                with tb.phase("pack"):
                    arrays, self._local_fn = pack_local_kernel(
                        shards_compact, self.max_m, self.dtype, kind,
                    )
                with tb.phase("upload"):
                    self.d_kernel = tuple(put(x) for x in arrays)
                    for x in self.d_kernel:
                        x.block_until_ready()
                cache[cache_key] = (self._local_fn, self.d_kernel)
            self._rb_rows = max(self.xplan.rB_nrow_max, 1)
            self._kernel_specs = tuple(
                P(self.axis, *([None] * (x.ndim - 1))) for x in self.d_kernel
            )
            self._identity_exchange = (
                p == 1
                and bool(self.config.rb_reidx)
                and len(self.xplan.rowmap[0]) == int(self.B_row_displs[-1])
            )
            if self._identity_exchange:
                # the kernel reads the owned block directly; pad it to the
                # receive-buffer size the kernel was packed for
                self.max_k = max(self.max_k, self._rb_rows)
            else:
                self.d_send_idx = put(self.xplan.send_idx)
                self.d_recv_dst = put(self.xplan.recv_dst)
                self.d_self_src = put(self.xplan.self_src)
                self.d_self_dst = put(self.xplan.self_dst)

        # resolved kernel after auto-selection
        self.kernel_kind = kind
        self.b_sharding = NamedSharding(self.mesh, P(self.axis, None, None))
        self._bt_jit = self._ct_jit = None  # lazy BC_layout transposes
        self._exec_jit = self._make_exec()
        if not (self.overlap or self._identity_exchange):
            self._exchange_jit, self._spmm_jit = self._make_staged()

        # audit (reference: rB_recv_size, src/rowpara_spmm.c:149)
        self.rB_recv_rows = self.xplan.rB_recv_rows
        self.rB_recv_size = int(self.xplan.total_recv_rows)

    def _shard_specs(self):
        ax = self.axis
        return dict(
            xch=(P(ax, None, None), P(ax, None, None), P(ax, None), P(ax, None)),
            b=P(ax, None, None),
        )

    def _make_exec(self):
        specs = self._shard_specs()
        axis = self.axis

        nk = len(self.d_kernel)

        if self.overlap:
            self_fn = self.ring.self_fn
            max_m = self.max_m

            def local(*args):
                kernel = tuple(a[0] for a in args[:nk])
                step_rows, step_cols, step_vals, send_idx, b_loc = args[nk:]
                c = ring_spmm(
                    b_loc[0], send_idx[0], kernel, self_fn,
                    step_rows[0], step_cols[0], step_vals[0], max_m, axis,
                )
                return c[None]

            in_specs = self._kernel_specs + (
                P(axis, None, None), P(axis, None, None), P(axis, None, None),
                P(axis, None, None), specs["b"],
            )
        elif self._identity_exchange:
            # p == 1 with every B row referenced: the exchange degenerates
            # to an identity copy of all of B (~15% of exec at the headline
            # shape) — feed the owned block straight into the kernel
            local_fn = self._local_fn

            def local(*args):
                kernel = tuple(a[0] for a in args[:nk])
                return local_fn(kernel, args[nk][0])[None]

            in_specs = self._kernel_specs + (specs["b"],)
        else:
            rB_nrow_max = self._rb_rows
            local_fn = self._local_fn
            xch_fn = exchange_b_ring if self.config.rb_p2p else exchange_b

            def local(*args):
                kernel = tuple(a[0] for a in args[:nk])
                send_idx, recv_dst, self_src, self_dst, b_loc = args[nk:]
                rB = xch_fn(
                    b_loc[0], send_idx[0], recv_dst[0], self_src[0],
                    self_dst[0], rB_nrow_max, axis,
                )
                return local_fn(kernel, rB)[None]

            in_specs = self._kernel_specs + specs["xch"] + (specs["b"],)

        fn = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=in_specs,
            out_specs=specs["b"],
            check_vma=False,
        )
        return jax.jit(fn)

    def _make_staged(self):
        """Exchange and local-SpMM as separate jitted stages for phase timing."""
        specs = self._shard_specs()
        rB_nrow_max = self._rb_rows
        axis = self.axis
        local_fn = self._local_fn

        xch_impl = exchange_b_ring if self.config.rb_p2p else exchange_b

        def xch(send_idx, recv_dst, self_src, self_dst, b_loc):
            return xch_impl(
                b_loc[0], send_idx[0], recv_dst[0], self_src[0], self_dst[0],
                rB_nrow_max, axis,
            )[None]

        def spmm(*args):
            kernel = tuple(a[0] for a in args[:-1])
            return local_fn(kernel, args[-1][0])[None]

        xch_fn = jax.jit(jax.shard_map(
            xch, mesh=self.mesh,
            in_specs=specs["xch"] + (specs["b"],),
            out_specs=specs["b"], check_vma=False,
        ))
        spmm_fn = jax.jit(jax.shard_map(
            spmm, mesh=self.mesh,
            in_specs=self._kernel_specs + (specs["b"],),
            out_specs=specs["b"], check_vma=False,
        ))
        return xch_fn, spmm_fn

    # ------------------------------------------------------------------ exec
    def shard_b(self, b: np.ndarray) -> jax.Array:
        """Global (k, n) host B -> device-stacked padded shards (p, max_k, n).

        With the dd kernel, B is split hi/lo and packed as (k, 2n) fp32
        before sharding; the exchange layer moves rows unchanged.

        With ``config.bc_layout = 1`` (the reference's col-major view,
        ``src/rowpara_spmm.c:225-264``) ``b`` arrives as (n, k): column
        slabs are staged host-side in the user's orientation and
        transposed ON DEVICE — one XLA pass at memory speed, since XLA owns
        physical layouts.
        """
        if self.config.bc_layout:
            b = np.asarray(b, dtype=self.dtype)
            displs = self.B_row_displs
            p = len(displs) - 1
            slabs = np.zeros((p, b.shape[0], self.max_k), dtype=self.dtype)
            for i in range(p):
                s, e = int(displs[i]), int(displs[i + 1])
                slabs[i, :, : e - s] = b[:, s:e]
            d = jax.device_put(slabs, self.b_sharding)
            if self._bt_jit is None:
                self._bt_jit = jax.jit(
                    lambda x: jnp.transpose(x, (0, 2, 1)),
                    out_shardings=self.b_sharding,
                )
            return self._bt_jit(d)
        if self.is_dd:
            from ..kernels.spmm_dd import pack_b_dd

            b = pack_b_dd(np.asarray(b, dtype=np.float64))
        else:
            b = np.asarray(b, dtype=self.dtype)
        bs = shard_dense_rows(b, self.B_row_displs, pad_rows=self.max_k)
        return jax.device_put(bs, self.b_sharding)

    def unshard_c(self, c_shards) -> np.ndarray:
        if self.config.bc_layout:
            # device-side transpose, then host assembly along columns:
            # C returns as (n, m) (reference BC_layout col-major view)
            if self._ct_jit is None:
                self._ct_jit = jax.jit(
                    lambda x: jnp.transpose(x, (0, 2, 1)),
                    out_shardings=self.b_sharding,
                )
            ct = np.asarray(self._ct_jit(c_shards))  # (p, n, max_m)
            displs = self.A_row_displs
            c = np.concatenate(
                [ct[i][:, : int(displs[i + 1] - displs[i])]
                 for i in range(len(displs) - 1)],
                axis=1,
            )
            if c.shape[1] < self.glb_m:
                c = np.concatenate(
                    [c, np.zeros((c.shape[0], self.glb_m - c.shape[1]),
                                 c.dtype)],
                    axis=1,
                )
            return c
        c = unshard_dense_rows(np.asarray(c_shards), self.A_row_displs)
        if self.is_dd:
            from ..kernels.spmm_dd import unpack_c_dd

            c = unpack_c_dd(c)
        if c.shape[0] < self.glb_m:
            # rows past the last nnz-balanced block are empty A rows (the
            # reference's binary search leaves trailing all-zero rows out of
            # every block, src/spmat_part.c:20-33) -> C rows are zero
            pad = np.zeros((self.glb_m - c.shape[0], c.shape[1]), c.dtype)
            c = np.concatenate([c, pad], axis=0)
        return c

    def exec_device(self, b_shards: jax.Array) -> jax.Array:
        """Fused exchange + SpMM on pre-sharded B; returns (p, max_m, n) shards."""
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
        """C := A @ B from a global host B; returns global host C (m, n)."""
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

    def exec_timed(self, b_shards: jax.Array) -> jax.Array:
        """Staged exec with per-phase fences (reference stat table parity).

        Overlap mode fuses exchange and compute by design, so its phases are
        not separable — it is timed as one "exec" phase.
        """
        t = self.timer
        if self.overlap or self._identity_exchange:
            c = self.exec_device(b_shards)
            with t.phase("exec", fence=c):
                pass
            t.n_exec += 1
            return c
        with t.phase("a2a"):
            rB = self._exchange_jit(
                self.d_send_idx, self.d_recv_dst, self.d_self_src, self.d_self_dst,
                b_shards,
            )
            rB.block_until_ready()
        with t.phase("spmm"):
            c = self._spmm_jit(*self.d_kernel, rB)
            c.block_until_ready()
        t.n_exec += 1
        return c

    # ----------------------------------------------------------------- stats
    def print_stat(self) -> str:
        """Stat table in the spirit of ``rp_spmm_print_stat``
        (``src/rowpara_spmm.c:425-464``)."""
        if self.overlap or self.config.rb_p2p:
            physical = self.xplan.physical_rows_ring
        else:
            physical = self.xplan.physical_rows
        return format_stat_table(
            title="rp_spmm",
            t_init=self.t_init,
            timer=self.timer,
            comm_rows=self.rB_recv_size,
            glb_n=self.glb_n,
            physical_rows=physical,
        )

    def clear_stat(self) -> None:
        self.timer.clear()
