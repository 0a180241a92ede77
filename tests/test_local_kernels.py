"""Every kept local kernel against the fp64 host reference.

``segsum`` and ``ell`` are plain XLA; ``triton`` is the Pallas CSR kernel for
NVIDIA GPUs, run here through the Pallas interpreter (the same kernel body
the GPU compiles).  Each case packs two row shards of unequal size through
``pack_local_kernel`` — the stacking, padding and tail segments the engines
ship — and checks every shard's C block.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crp_tpu.kernels import spmm_triton as st
from crp_tpu.kernels.dispatch import pack_local_kernel
from crp_tpu.sparse.csr import CSRMatrix
from crp_tpu.sparse.synth import (
    banded_random_csr, powerlaw_community_csr, powerlaw_random_csr,
)
from crp_tpu.utils.norms import rel_fro_err


def _empty_rows(dt):
    """Every third row empty, plus a run of trailing empty rows."""
    rng = np.random.default_rng(6)
    rows = np.repeat(np.arange(0, 150, 3), 5)
    cols = rng.integers(0, 140, size=len(rows))
    return CSRMatrix.from_coo(180, 140, rows, cols,
                              rng.standard_normal(len(rows)), dtype=dt)


def _hub_row(dt):
    """One row longer than the head kernel's SEG (tail segments), the rest
    short."""
    rng = np.random.default_rng(7)
    hub = np.full(st.SEG * 2 + 37, 11)
    rows = np.concatenate([hub, np.repeat(np.arange(60), 3)])
    cols = np.concatenate([
        rng.permutation(700)[: len(hub)], rng.integers(0, 700, size=180),
    ])
    return CSRMatrix.from_coo(60, 700, rows, cols,
                              rng.standard_normal(len(rows)), dtype=dt)


def _empty(dt):
    return CSRMatrix.from_coo(40, 30, np.zeros(0, np.int64),
                              np.zeros(0, np.int64), np.zeros(0), dtype=dt)


MATRICES = {
    "banded": lambda dt: banded_random_csr(160, nnz_per_row=9, bandwidth=20,
                                           seed=3, dtype=dt),
    "powerlaw": lambda dt: powerlaw_random_csr(200, avg_degree=6, seed=4,
                                               dtype=dt),
    "scrambled_community": lambda dt: powerlaw_community_csr(
        256, avg_degree=8, comm_size=32, permute=True, seed=5, dtype=dt),
    "empty_rows": _empty_rows,
    "hub_row": _hub_row,
    "empty": _empty,
}


def _run_kernel(kind, a, b):
    """Pack A as two row shards and run each shard's local kernel."""
    cut = a.nrow // 3
    shards = [a.row_slice(0, cut), a.row_slice(cut, a.nrow)]
    max_m = max(s.nrow for s in shards)
    arrays, local_fn = pack_local_kernel(
        [(s.rowptr, s.colidx.astype(np.int32), s.val) for s in shards],
        max_m, b.dtype, kind, interpret=True,
    )
    blocks = []
    for i, s in enumerate(shards):
        c = np.asarray(local_fn(tuple(jnp.asarray(x[i]) for x in arrays),
                                jnp.asarray(b)))
        assert c.shape == (max_m, b.shape[1]) and c.dtype == b.dtype
        assert not c[s.nrow:].any()  # padding rows stay zero
        blocks.append(c[: s.nrow])
    return np.concatenate(blocks)


@pytest.mark.parametrize("n", [1, 17, 128])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
@pytest.mark.parametrize("matrix", list(MATRICES))
@pytest.mark.parametrize("kind", ["segsum", "ell", "triton"])
def test_local_kernel_matches_reference(kind, matrix, dtype, n):
    a = MATRICES[matrix](dtype)
    b = np.random.default_rng(n).standard_normal((a.ncol, n)).astype(dtype)
    c = _run_kernel(kind, a, b)
    ref = a.spmm_ref(b)
    if not ref.any():
        assert not c.any()
        return
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert rel_fro_err(ref, c) <= tol


def test_pack_rows_orders_by_length_bucket():
    """Rows sort longest first by quarter-octave bucket; equal buckets keep
    matrix order; pads carry id nrow and length 0."""
    lens = np.array([3, 50, 52, 0, 7, 49, 53, 1])
    rowptr = np.concatenate([[0], np.cumsum(lens)])
    perm, start, length, *_ = st.pack_rows(rowptr, 10, block_m=4)
    assert len(perm) == 12
    assert list(perm[:10]) == [1, 2, 5, 6, 4, 0, 7, 3, 8, 9]
    assert list(perm[10:]) == [10, 10] and not length[10:].any()
    np.testing.assert_array_equal(start[:8], rowptr[perm[:8]])
    np.testing.assert_array_equal(length[:10], np.r_[lens, 0, 0][perm[:10]])


def test_pack_rows_tail_segments_cover_long_rows():
    lens = np.array([5, 3 * 100 + 7, 100, 101])
    rowptr = np.concatenate([[0], np.cumsum(lens)])
    perm, start, length, seg_row, seg_start, seg_end = st.pack_rows(
        rowptr, 4, block_m=2, seg=100)
    assert length.max() == 100
    assert list(seg_row) == [1, 1, 1, 3]
    covered = np.zeros(rowptr[-1], int)
    for r, s, l in zip(perm, start, length):
        covered[s: s + l] += 1
    for s, e in zip(seg_start, seg_end):
        assert 0 < e - s <= 100
        covered[s:e] += 1
    assert (covered == 1).all()  # every nonzero exactly once


@pytest.mark.parametrize("n,dtype,tn", [(1, np.float32, 16),
                                        (17, np.float32, 32),
                                        (256, np.float32, 128),
                                        (256, np.float64, 64)])
def test_tile_geometry(n, dtype, tn):
    assert st.tile_n(n, dtype) == tn
    assert st.block_rows(dtype) == (8 if dtype == np.float64 else 16)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
@pytest.mark.parametrize("tails", [0, 5])
def test_triton_lowers_for_cuda(dtype, tails):
    """The kernel lowers to Triton IR for the GPU from this CPU host: one
    head call, plus the tail call when some row is longer than SEG."""
    from jax import export

    nrow, nnz, k, n = 300, 4000, 500, 256
    bm = st.block_rows(dtype)
    i32 = np.int32
    args = (
        jax.ShapeDtypeStruct((-(-nrow // bm) * bm,), i32),
        jax.ShapeDtypeStruct((-(-nrow // bm) * bm,), i32),
        jax.ShapeDtypeStruct((-(-nrow // bm) * bm,), i32),
        *(jax.ShapeDtypeStruct((tails,), i32),) * 3,
        jax.ShapeDtypeStruct((nnz + st.BK,), i32),
        jax.ShapeDtypeStruct((nnz + st.BK,), dtype),
        jax.ShapeDtypeStruct((k, n), dtype),
    )
    f = jax.jit(functools.partial(st.spmm_csr_triton, nrow=nrow))
    exp = export.export(
        f, platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")],
    )(*args)
    text = exp.mlir_module()
    assert text.count("__gpu$xla.gpu.triton") == (2 if tails else 1)
    assert "spmm_csr_head" in text


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
def test_triton_compiled_on_gpu(gpu_device, dtype):
    """The kernel as compiled for the card (no interpreter) against the fp64
    reference, hub rows and all."""
    a = powerlaw_community_csr(20000, avg_degree=16, comm_size=256,
                               permute=True, seed=8, dtype=dtype)
    b = np.random.default_rng(9).standard_normal((a.ncol, 256)).astype(dtype)
    arrays, local_fn = pack_local_kernel(
        [(a.rowptr, a.colidx.astype(np.int32), a.val)], a.nrow, dtype,
        "triton",
    )
    c = np.asarray(local_fn(tuple(jnp.asarray(x[0]) for x in arrays),
                            jnp.asarray(b)))
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert rel_fro_err(a.spmm_ref(b), c) <= tol
