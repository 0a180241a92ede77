"""Native C++ fastops vs numpy fallbacks — identical results required."""

import numpy as np
import pytest

from crp_tpu import native
from crp_tpu.sparse.synth import banded_random_csr, powerlaw_random_csr


needs_native = pytest.mark.skipif(
    native._load() is None, reason="native toolchain unavailable"
)


@needs_native
def test_native_comm_size_matches_numpy(monkeypatch):
    from crp_tpu.plan import partition1d

    a = powerlaw_random_csr(800, avg_degree=9, seed=60)
    from crp_tpu.plan.partition1d import csr_row_partition
    from crp_tpu.utils.blocks import uniform_displs

    rblk = csr_row_partition(a.rowptr, 8)
    xd = uniform_displs(a.ncol, 8)
    s_native, t_native = partition1d.csr_row_part_comm_size(
        a.ncol, a.rowptr, a.colidx, rblk, xd
    )
    monkeypatch.setattr(native, "comm_size", lambda *a, **k: None)
    s_np, t_np = partition1d.csr_row_part_comm_size(
        a.ncol, a.rowptr, a.colidx, rblk, xd
    )
    np.testing.assert_array_equal(s_native, s_np)
    assert t_native == t_np


@needs_native
def test_native_coo2csr_matches_numpy():
    rng = np.random.default_rng(61)
    nnz = 150_000
    rows = rng.integers(0, 500, nnz)
    cols = rng.integers(0, 500, nnz)
    vals = rng.standard_normal(nnz)
    from crp_tpu.sparse.csr import CSRMatrix

    a = CSRMatrix.from_coo(500, 500, rows, cols, vals)  # native path (>100k)
    b = CSRMatrix.from_coo(500, 500, rows[:99_000], cols[:99_000], vals[:99_000])
    # cross-check against scipy on the full set
    import scipy.sparse as sp

    ref = sp.coo_matrix((vals, (rows, cols)), shape=(500, 500)).tocsr()
    ref.sort_indices()
    # duplicate (row, col) entries are summed in a different order than
    # scipy's tocsr -> allow fp addition reordering
    np.testing.assert_allclose(
        a.to_scipy().toarray(), ref.toarray(), rtol=1e-12, atol=1e-12
    )
    for i in range(500):
        seg = a.colidx[a.rowptr[i]:a.rowptr[i + 1]]
        assert np.all(np.diff(seg) >= 0)


@needs_native
def test_native_mtx_reader(tmp_path):
    from crp_tpu.sparse.mmio import mm_read_sparse, write_mtx

    a = banded_random_csr(60, nnz_per_row=4, bandwidth=6, seed=63)
    f = str(tmp_path / "n.mtx")
    write_mtx(f, a)
    b = mm_read_sparse(f)
    np.testing.assert_allclose(b.to_dense(), a.to_dense(), rtol=1e-15)

    # symmetric + pattern fields
    f2 = str(tmp_path / "p.mtx")
    with open(f2, "w") as fh:
        fh.write("%%MatrixMarket matrix coordinate pattern symmetric\n")
        fh.write("% comment line\n3 3 3\n1 1\n2 1\n3 2\n")
    c = mm_read_sparse(f2)
    expect = np.array([[1.0, 1, 0], [1, 0, 1], [0, 1, 0]])
    np.testing.assert_array_equal(c.to_dense(), expect)
