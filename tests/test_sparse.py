"""Tests for the sparse containers and I/O (sparse layer)."""

import numpy as np
import pytest

from crp_tpu.sparse.csr import CSRMatrix
from crp_tpu.sparse.mmio import mm_read_sparse, write_mtx
from crp_tpu.sparse.synth import banded_random_csr, fill_b


def test_from_coo_sorted_and_complete():
    rows = np.array([2, 0, 1, 0, 2, 1])
    cols = np.array([1, 2, 0, 0, 0, 2])
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    a = CSRMatrix.from_coo(3, 3, rows, cols, vals)
    np.testing.assert_array_equal(a.rowptr, [0, 2, 4, 6])
    # columns sorted within each row (invariant for the v1 planner)
    for i in range(3):
        seg = a.colidx[a.rowptr[i]:a.rowptr[i + 1]]
        assert np.all(np.diff(seg) >= 0)
    dense = a.to_dense()
    expect = np.zeros((3, 3))
    expect[rows, cols] = vals
    np.testing.assert_array_equal(dense, expect)


def test_row_slice_and_localize():
    a = banded_random_csr(100, nnz_per_row=5, bandwidth=8, seed=1)
    blk = a.row_slice(40, 60)
    assert blk.nrow == 20
    np.testing.assert_array_equal(blk.to_dense(), a.to_dense()[40:60])
    loc, srow, w = blk.localize()
    assert srow == int(blk.colidx.min())
    np.testing.assert_array_equal(loc.to_dense(), blk.to_dense()[:, srow:srow + w])


def test_spmm_ref_matches_dense():
    a = banded_random_csr(64, nnz_per_row=4, bandwidth=6, seed=2)
    b = fill_b(0, 64, 0, 8)
    np.testing.assert_allclose(a.spmm_ref(b), a.to_dense() @ b, rtol=1e-13)


def test_row_col_ranges():
    a = banded_random_csr(50, nnz_per_row=3, bandwidth=5, seed=3)
    r = a.row_col_ranges()
    d = a.to_dense()
    for i in range(50):
        nz = np.nonzero(d[i])[0]
        if len(nz):
            assert r[i, 0] == nz.min() and r[i, 1] == nz.max()


def test_mmio_roundtrip(tmp_path):
    a = banded_random_csr(40, nnz_per_row=3, bandwidth=4, seed=5)
    f = str(tmp_path / "t.mtx")
    write_mtx(f, a)
    b = mm_read_sparse(f)
    np.testing.assert_allclose(b.to_dense(), a.to_dense(), rtol=1e-15)


def test_mmio_symmetric_expansion(tmp_path):
    """Symmetric storage must be mirror-expanded like the reference reader
    (examples/mmio_utils.c:102-117)."""
    f = str(tmp_path / "s.mtx")
    with open(f, "w") as fh:
        fh.write("%%MatrixMarket matrix coordinate real symmetric\n")
        fh.write("3 3 4\n1 1 2.0\n2 1 3.0\n3 2 4.0\n3 3 5.0\n")
    a = mm_read_sparse(f, need_symm=True)
    expect = np.array([[2.0, 3.0, 0.0], [3.0, 0.0, 4.0], [0.0, 4.0, 5.0]])
    np.testing.assert_array_equal(a.to_dense(), expect)
    assert a.nnz == 6  # off-diagonals mirrored, diagonal not duplicated


def test_mmio_need_symm_rejects_general(tmp_path):
    f = str(tmp_path / "g.mtx")
    with open(f, "w") as fh:
        fh.write("%%MatrixMarket matrix coordinate real general\n")
        fh.write("2 2 1\n1 2 1.0\n")
    with pytest.raises(ValueError):
        mm_read_sparse(f, need_symm=True)


def test_fill_b_formula():
    """B(i,j) = 0.19 i + 0.24 j, global indices (examples/test_utils.c:121-154)."""
    blk = fill_b(10, 3, 20, 2)
    assert blk[0, 0] == pytest.approx(0.19 * 10 + 0.24 * 20)
    assert blk[2, 1] == pytest.approx(0.19 * 12 + 0.24 * 21)
    # sub-blocks agree with the global fill without communication
    full = fill_b(0, 50, 0, 30)
    np.testing.assert_array_equal(full[10:13, 20:22], blk)


def test_bandwidth():
    a = banded_random_csr(200, nnz_per_row=5, bandwidth=7, seed=6)
    assert a.bandwidth() <= 7


def test_debug_dump_roundtrip(tmp_path):
    from crp_tpu.utils.debug import dump_binary, load_binary, print_matrix
    import io

    x = np.arange(12, dtype=np.float64).reshape(3, 4) * 0.19
    p = str(tmp_path / "x.bin")
    dump_binary(x, p)
    np.testing.assert_array_equal(load_binary(p), x)
    buf = io.StringIO()
    print_matrix(x, name="x", file=buf)
    assert buf.getvalue().startswith("x, size = 3 * 4:")


def test_plan2d_save_load_roundtrip(tmp_path):
    from crp_tpu.plan.planner2d import plan_from_csr, Plan2D
    from crp_tpu.sparse.synth import banded_random_csr

    a = banded_random_csr(800, nnz_per_row=6, bandwidth=30, seed=40)
    plan = plan_from_csr(a, 64, 8)
    p = str(tmp_path / "plan.npz")
    plan.save(p)
    got = Plan2D.load(p)
    assert (got.pm, got.pn, got.comm_cost) == (plan.pm, plan.pn, plan.comm_cost)
    for f in ("A0_rowptr", "B_rowptr", "AC_rowptr", "BC_colptr"):
        np.testing.assert_array_equal(getattr(got, f), getattr(plan, f))


def test_mmio_pattern_and_integer_fields(tmp_path):
    """Reference reads real/pattern/integer .mtx (mmio_utils.c:11-125);
    pattern entries become 1.0, symmetric storage is mirrored."""
    from crp_tpu.sparse.mmio import mm_read_sparse

    pat = tmp_path / "p.mtx"
    pat.write_text(
        "%%MatrixMarket matrix coordinate pattern symmetric\n"
        "3 3 3\n1 1\n2 1\n3 2\n"
    )
    a = mm_read_sparse(str(pat), need_symm=True)
    d = a.to_scipy().toarray()
    exp = np.array([[1, 1, 0], [1, 0, 1], [0, 1, 0]], dtype=np.float64)
    np.testing.assert_array_equal(d, exp)

    ints = tmp_path / "i.mtx"
    ints.write_text(
        "%%MatrixMarket matrix coordinate integer general\n"
        "2 3 3\n1 1 5\n2 2 -7\n1 3 2\n"
    )
    a = mm_read_sparse(str(ints))
    d = a.to_scipy().toarray()
    exp = np.array([[5, 0, 2], [0, -7, 0]], dtype=np.float64)
    np.testing.assert_array_equal(d, exp)


def test_config_dtype_reaches_engines(devices8):
    """SpmmConfig.dtype / CRP_TPU_DTYPE is the engine default when the
    constructor receives no explicit dtype (regression: it was a no-op)."""
    from crp_tpu.config import SpmmConfig
    from crp_tpu.engine.rowpara import RowParaSpmm
    from crp_tpu.plan.partition1d import csr_row_partition
    from crp_tpu.sparse.synth import banded_random_csr
    from crp_tpu.shard.layout import make_mesh_1d

    a = banded_random_csr(100, nnz_per_row=4, bandwidth=10, seed=81)
    d = csr_row_partition(a.rowptr, 2)
    eng = RowParaSpmm(a, d, d, 4, mesh=make_mesh_1d(2, devices=devices8),
                      config=SpmmConfig(dtype="float32"))
    assert eng.dtype == np.float32
    eng = RowParaSpmm(a, d, d, 4, mesh=make_mesh_1d(2, devices=devices8),
                      config=SpmmConfig(dtype="float32"), dtype=np.float64)
    assert eng.dtype == np.float64  # explicit argument wins


def test_bcoo_interop_roundtrip():
    """CSRMatrix <-> jax.experimental.sparse.BCOO: values, shape, and a
    matmul against the fp64 reference survive the roundtrip."""
    import jax.numpy as jnp
    import numpy as np

    from crp_tpu.sparse.synth import powerlaw_random_csr, fill_b
    from crp_tpu.sparse.csr import CSRMatrix

    a = powerlaw_random_csr(300, avg_degree=7, seed=82)
    m = a.to_bcoo()
    assert m.shape == (a.nrow, a.ncol) and m.nse == a.nnz
    b = np.asarray(fill_b(0, a.ncol, 0, 8))
    c = np.asarray(m @ jnp.asarray(b))
    assert np.allclose(c, a.spmm_ref(b), rtol=1e-10, atol=1e-10)
    back = CSRMatrix.from_bcoo(m)
    assert np.array_equal(back.rowptr, a.rowptr)
    assert np.array_equal(back.colidx, a.colidx)
    assert np.allclose(back.val, a.val)
