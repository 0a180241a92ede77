"""Local SpMM kernel tests (kernels layer) — fp64 on CPU, vs scipy."""

import jax
import numpy as np
import pytest

from crp_tpu.kernels.spmm_jnp import DeviceCSR, pack_device_csr, spmm_segment_sum
from crp_tpu.sparse.synth import banded_random_csr, powerlaw_random_csr, fill_b
from crp_tpu.utils.norms import rel_fro_err


@pytest.mark.parametrize("gen,kw", [
    (banded_random_csr, dict(nnz_per_row=7, bandwidth=30)),
    (powerlaw_random_csr, dict(avg_degree=9)),
])
def test_spmm_matches_scipy(gen, kw):
    a = gen(300, seed=17, **kw)
    b = fill_b(0, a.ncol, 0, 40)
    row_ids, cols, vals = pack_device_csr(a.rowptr, a.colidx, a.val, a.nnz)
    c = spmm_segment_sum(DeviceCSR(row_ids, cols, vals, a.nrow), b)
    assert rel_fro_err(a.spmm_ref(b), np.asarray(c)) <= 1e-12


def test_spmm_with_padding():
    """Padded nnz entries (row_id = nrow) must not contribute."""
    a = banded_random_csr(100, nnz_per_row=5, bandwidth=10, seed=3)
    b = fill_b(0, a.ncol, 0, 8)
    row_ids, cols, vals = pack_device_csr(a.rowptr, a.colidx, a.val, a.nnz + 177)
    c = spmm_segment_sum(DeviceCSR(row_ids, cols, vals, a.nrow), b)
    assert rel_fro_err(a.spmm_ref(b), np.asarray(c)) <= 1e-12


def test_spmm_under_jit():
    a = powerlaw_random_csr(200, avg_degree=5, seed=4)
    b = np.asarray(fill_b(0, a.ncol, 0, 16))
    row_ids, cols, vals = pack_device_csr(a.rowptr, a.colidx, a.val, a.nnz)

    @jax.jit
    def run(r, c, v, b):
        return spmm_segment_sum(DeviceCSR(r, c, v, a.nrow), b)

    c = run(row_ids, cols, vals, b)
    assert rel_fro_err(a.spmm_ref(b), np.asarray(c)) <= 1e-12


def test_spmm_empty_rows_and_matrix():
    from crp_tpu.sparse.csr import CSRMatrix
    a = CSRMatrix(5, 5, np.array([0, 0, 2, 2, 2, 3]),
                  np.array([1, 4, 0], dtype=np.int32), np.array([2.0, 3.0, 4.0]))
    b = fill_b(0, 5, 0, 4)
    row_ids, cols, vals = pack_device_csr(a.rowptr, a.colidx, a.val, a.nnz)
    c = np.asarray(spmm_segment_sum(DeviceCSR(row_ids, cols, vals, 5), b))
    np.testing.assert_allclose(c, a.to_dense() @ b, rtol=1e-14)
    assert np.all(c[0] == 0) and np.all(c[2] == 0)


def test_ell_kernel_matches_scipy():
    from crp_tpu.kernels.spmm_ell import pack_ell, spmm_ell

    a = banded_random_csr(300, nnz_per_row=7, bandwidth=30, seed=18)
    b = np.asarray(fill_b(0, a.ncol, 0, 24))
    cols, vals = pack_ell(a.rowptr, a.colidx, a.val, a.nrow)
    c = spmm_ell(cols, vals, b)
    assert rel_fro_err(a.spmm_ref(b), np.asarray(c)) <= 1e-12


def test_ell_kernel_padded_rows():
    from crp_tpu.kernels.spmm_ell import pack_ell, spmm_ell

    a = powerlaw_random_csr(150, avg_degree=6, seed=19)
    b = np.asarray(fill_b(0, a.ncol, 0, 8))
    # extra row padding and forced larger L
    max_row = int(np.diff(a.rowptr).max())
    cols, vals = pack_ell(a.rowptr, a.colidx, a.val, a.nrow + 13, L=max_row + 10)
    c = np.asarray(spmm_ell(cols, vals, b))
    assert rel_fro_err(a.spmm_ref(b), c[: a.nrow]) <= 1e-12
    assert np.all(c[a.nrow:] == 0)
    # too-small L must be rejected loudly
    with pytest.raises(ValueError):
        pack_ell(a.rowptr, a.colidx, a.val, a.nrow, L=1)


def test_dd_ell_kernel_fp64_class_accuracy():
    """Double-float ELL kernel (bounded row degree): <=1e-12 vs the fp64
    reference using only fp32 device arithmetic (fp64 parity on fp32-only hardware,
    SURVEY.md section 7)."""
    import jax
    from crp_tpu.kernels.spmm_dd import (
        pack_ell_dd, pack_b_dd, unpack_c_dd, spmm_ell_dd,
    )

    a = banded_random_csr(1500, nnz_per_row=9, bandwidth=60, seed=36)
    b = np.asarray(fill_b(0, a.ncol, 0, 32))
    cols, vh, vl = pack_ell_dd(a.rowptr, a.colidx, a.val, a.nrow)
    cp = jax.jit(spmm_ell_dd)(cols, vh, vl, pack_b_dd(b))
    assert cp.dtype == np.float32
    c = unpack_c_dd(np.asarray(cp))
    assert rel_fro_err(a.spmm_ref(b), c) <= 1e-12


def test_dd_segsum_kernel_fp64_class_accuracy():
    """Segmented-scan double-float kernel: degree-independent compile,
    handles hub rows and empty rows."""
    import jax
    from crp_tpu.kernels.spmm_dd import (
        pack_coo_dd, pack_b_dd, unpack_c_dd, spmm_segsum_dd,
    )

    for gen, kw in [
        (banded_random_csr, dict(nnz_per_row=9, bandwidth=60)),
        (powerlaw_random_csr, dict(avg_degree=12)),
    ]:
        a = gen(1500, seed=36, **kw)
        b = np.asarray(fill_b(0, a.ncol, 0, 32))
        arrs = pack_coo_dd(a.rowptr, a.colidx, a.val, a.nnz + 1, a.nrow)
        cp = jax.jit(spmm_segsum_dd)(*arrs, pack_b_dd(b))
        assert cp.dtype == np.float32
        c = unpack_c_dd(np.asarray(cp))
        assert rel_fro_err(a.spmm_ref(b), c) <= 1e-12


def test_dd_split_roundtrip():
    from crp_tpu.kernels.spmm_dd import split_f64

    x = np.random.default_rng(1).uniform(-1e3, 1e3, 4096)
    hi, lo = split_f64(x)
    err = np.abs(hi.astype(np.float64) + lo.astype(np.float64) - x)
    assert (err / np.abs(x)).max() <= 2 ** -45
