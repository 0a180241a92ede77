"""Generic 2D block redistribution (the ``mat_redist`` equivalent).

The reference's ``mat_redist`` engine moves a matrix from per-process
"source" 2D blocks to per-process "required" 2D blocks: it allgathers block
coordinates, intersects rectangles to derive send/recv pairs, and execs
pack -> ``MPI_Neighbor_alltoallv`` -> unpack (``src/mat_redist.c:9-213,
298-419``).

JAX version: the planner holds all block coordinates, so the
rectangle intersections happen host-side at init; exec is one jitted
shard_map — every device slices its (pair-padded) patches out of its source
block, a single ``lax.all_to_all`` moves them, and each device blends the
received patches into its destination block.  Raggedness is handled by
padding every pair patch to (max_h, max_w) and blending with plan-time
masks; the audit tracks logical (exact) vs physical (padded) volumes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P


@dataclasses.dataclass
class BlockDist:
    """Per-device 2D block layout: row i = (srow, scol, nrow, ncol)."""

    blocks: np.ndarray  # (p, 4) int64

    def __post_init__(self):
        self.blocks = np.asarray(self.blocks, dtype=np.int64).reshape(-1, 4)

    @property
    def p(self) -> int:
        return self.blocks.shape[0]

    @property
    def max_h(self) -> int:
        return int(max(self.blocks[:, 2].max(), 1))

    @property
    def max_w(self) -> int:
        return int(max(self.blocks[:, 3].max(), 1))

    @classmethod
    def from_row_slabs(cls, displs: np.ndarray, ncol: int) -> "BlockDist":
        displs = np.asarray(displs, dtype=np.int64)
        p = len(displs) - 1
        b = np.zeros((p, 4), dtype=np.int64)
        b[:, 0] = displs[:-1]
        b[:, 2] = np.diff(displs)
        b[:, 3] = ncol
        return cls(b)

    @classmethod
    def from_grid(
        cls, row_displs: np.ndarray, col_displs: np.ndarray
    ) -> "BlockDist":
        """Row-major (len(row_displs)-1) x (len(col_displs)-1) grid."""
        rd = np.asarray(row_displs, dtype=np.int64)
        cd = np.asarray(col_displs, dtype=np.int64)
        out = []
        for i in range(len(rd) - 1):
            for j in range(len(cd) - 1):
                out.append([rd[i], cd[j], rd[i + 1] - rd[i], cd[j + 1] - cd[j]])
        return cls(np.array(out, dtype=np.int64))

    def gather_single(self, nrow: int, ncol: int, root: int = 0) -> "BlockDist":
        """All data on one device (the drivers' result-check layout,
        ``examples/test_para2d_spmm.c:183-200``)."""
        b = np.zeros((self.p, 4), dtype=np.int64)
        b[root] = [0, 0, nrow, ncol]
        return BlockDist(b)


def _intersect(a: np.ndarray, b: np.ndarray) -> tuple[int, int, int, int]:
    """Intersection rect of two (srow, scol, nrow, ncol) blocks
    (``src/mat_redist.c:9-41``)."""
    r0 = max(a[0], b[0])
    r1 = min(a[0] + a[2], b[0] + b[2])
    c0 = max(a[1], b[1])
    c1 = min(a[1] + a[3], b[1] + b[3])
    if r0 >= r1 or c0 >= c1:
        return 0, 0, 0, 0
    return r0, c0, r1 - r0, c1 - c0


class RedistEngine:
    """init once, exec many — moves (p, H, W) padded shards between layouts."""

    def __init__(
        self,
        src: BlockDist,
        dst: BlockDist,
        mesh: jax.sharding.Mesh,
        axes=None,
        dtype=np.float64,
    ) -> None:
        assert src.p == dst.p, (src.p, dst.p)
        p = src.p
        self.src, self.dst = src, dst
        self.mesh = mesh
        self.axes = tuple(axes) if axes is not None else tuple(mesh.axis_names)
        self.dtype = np.dtype(dtype)
        self.p = p

        # pairwise intersections: pair[i][j] = what device j sends to device i
        rect = np.zeros((p, p, 4), dtype=np.int64)  # (dst, src, [r0 c0 h w]) global
        for i in range(p):
            for j in range(p):
                rect[i, j] = _intersect(dst.blocks[i], src.blocks[j])
        h, w = rect[:, :, 2], rect[:, :, 3]
        self.max_h = int(max(h.max(), 1))
        self.max_w = int(max(w.max(), 1))

        # per-source-device j: slice starts (relative to its block) of the
        # patch destined for device i
        self.s_start = np.zeros((p, p, 2), dtype=np.int32)  # [src j][dst i]
        # per-dest-device i: placement starts of the patch from j
        self.d_start = np.zeros((p, p, 2), dtype=np.int32)  # [dst i][src j]
        self.hw = np.zeros((p, p, 2), dtype=np.int32)       # [dst i][src j]
        for i in range(p):
            for j in range(p):
                r0, c0, hh, ww = rect[i, j]
                self.s_start[j, i] = (r0 - src.blocks[j, 0], c0 - src.blocks[j, 1])
                self.d_start[i, j] = (r0 - dst.blocks[i, 0], c0 - dst.blocks[i, 1])
                self.hw[i, j] = (hh, ww)

        # audit volumes (elements): reference counts the full destination
        # size as the redistributed volume (deprecated/src/crpspmm.c:451)
        self.nelem_dst = int((dst.blocks[:, 2] * dst.blocks[:, 3]).sum())
        off = ~np.eye(p, dtype=bool)
        self.nelem_moved = int((h * w)[off].sum())
        self.nelem_physical = p * p * self.max_h * self.max_w

        self._sharding = NamedSharding(
            self.mesh, P(self.axes if len(self.axes) > 1 else self.axes[0],
                         None, None)
        )
        sh = self._sharding
        self.d_s_start = jax.device_put(self.s_start, sh)
        self.d_d_start = jax.device_put(self.d_start.transpose(0, 1, 2), sh)
        self.d_hw = jax.device_put(self.hw, sh)
        self._exec_jit = self._make_exec()

    # ------------------------------------------------------------------ exec
    def _make_exec(self):
        p = self.p
        mh, mw = self.max_h, self.max_w
        src_h, src_w = self.src.max_h, self.src.max_w
        dst_h, dst_w = self.dst.max_h, self.dst.max_w
        axes = self.axes
        axis_for_a2a = axes if len(axes) > 1 else axes[0]

        row_i = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 0)
        col_i = jax.lax.broadcasted_iota(jnp.int32, (mh, mw), 1)

        def local(s_start, d_start, hw, x_loc):
            s_start, d_start, hw, x = s_start[0], d_start[0], hw[0], x_loc[0]
            # source padded so pair slices never clamp
            x_pad = jnp.pad(x, ((0, mh), (0, mw)))
            patches = [
                jax.lax.dynamic_slice(
                    x_pad, (s_start[i, 0], s_start[i, 1]), (mh, mw)
                )
                for i in range(p)
            ]
            send = jnp.stack(patches, axis=0).reshape(p * mh, mw)
            recv = jax.lax.all_to_all(
                send, axis_for_a2a, split_axis=0, concat_axis=0, tiled=True
            ).reshape(p, mh, mw)
            out = jnp.zeros((dst_h + mh, dst_w + mw), dtype=x.dtype)
            for j in range(p):
                r0, c0 = d_start[j, 0], d_start[j, 1]
                cur = jax.lax.dynamic_slice(out, (r0, c0), (mh, mw))
                mask = (row_i < hw[j, 0]) & (col_i < hw[j, 1])
                blend = jnp.where(mask, recv[j], cur)
                out = jax.lax.dynamic_update_slice(out, blend, (r0, c0))
            return out[:dst_h, :dst_w][None]

        spec = P(self.axes if len(self.axes) > 1 else self.axes[0], None, None)
        fn = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(spec, spec, spec, spec),
            out_specs=spec,
            check_vma=False,
        )
        return jax.jit(fn)

    def exec_device(self, x_shards: jax.Array) -> jax.Array:
        """(p, src_max_h, src_max_w) padded shards -> (p, dst_max_h, dst_max_w)."""
        return self._exec_jit(self.d_s_start, self.d_d_start, self.d_hw, x_shards)

    # ------------------------------------------------------------- host utils
    def shard_src(self, x: np.ndarray) -> jax.Array:
        """Global (m, n) -> padded per-device source blocks, on device."""
        out = np.zeros((self.p, self.src.max_h, self.src.max_w), dtype=self.dtype)
        for i, (r, c, h, w) in enumerate(self.src.blocks):
            out[i, :h, :w] = x[r : r + h, c : c + w]
        return jax.device_put(out, self._sharding)

    def unshard_dst(self, shards, m: int, n: int) -> np.ndarray:
        shards = np.asarray(shards)
        out = np.zeros((m, n), dtype=shards.dtype)
        for i, (r, c, h, w) in enumerate(self.dst.blocks):
            out[r : r + h, c : c + w] = shards[i, :h, :w]
        return out
