"""End-to-end 1D row-parallel engine tests on the 8-device CPU mesh.

Mirrors the reference's ``test_rp_spmm`` driver acceptance path
(``examples/test_rp_spmm.c``): analytic B, full-matrix fp64 reference SpMM,
``||C_ref - C||_F / ||C_ref||_F <= 1e-12``.
"""

import numpy as np
import pytest

from crp_tpu.config import SpmmConfig
from crp_tpu.engine.rowpara import RowParaSpmm
from crp_tpu.plan.partition1d import csr_row_partition
from crp_tpu.sparse.synth import banded_random_csr, powerlaw_random_csr, fill_b
from crp_tpu.shard.layout import make_mesh_1d
from crp_tpu.utils.blocks import uniform_displs
from crp_tpu.utils.norms import rel_fro_err


def build_engine(a, p, n, devices8, reidx=1, b_displs=None, **cfg_kw):
    displs = csr_row_partition(a.rowptr, p)
    if b_displs is None:
        b_displs = displs if a.nrow == a.ncol else uniform_displs(a.ncol, p)
    mesh = make_mesh_1d(p, devices=devices8)
    cfg = SpmmConfig(rb_reidx=reidx, **cfg_kw)
    return RowParaSpmm(a, displs, b_displs, n, mesh=mesh, config=cfg)


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("gen,kw", [
    (banded_random_csr, dict(nnz_per_row=7, bandwidth=40)),
    (powerlaw_random_csr, dict(avg_degree=10)),
])
def test_rowpara_matches_reference(p, gen, kw, devices8):
    a = gen(500, seed=20, **kw)
    n = 24
    eng = build_engine(a, p, n, devices8)
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    c = eng.exec(b)
    assert rel_fro_err(a.spmm_ref(b), c) <= 1e-12


@pytest.mark.parametrize("mode", [
    dict(rb_p2p=0),                       # single padded all_to_all
    dict(rb_p2p=1),                       # ppermute p2p ring
    dict(overlap=1),                      # fused ring + partial compute
    dict(overlap=1, kernel="ell"),        # self part on the ELL kernel
    dict(overlap=1, kernel="triton"),     # self part on the Pallas kernel
])
@pytest.mark.parametrize("p", [3, 8])
def test_rowpara_exchange_modes(p, mode, devices8, triton_interpret):
    """All exchange schedules (RP_SPMM_P2P analogs + the overlap design)
    produce the identical <=1e-12 result, including non-power-of-two p."""
    a = banded_random_csr(450, nnz_per_row=7, bandwidth=60, seed=28)
    n = 16
    eng = build_engine(a, p, n, devices8, **mode)
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12


def test_rowpara_overlap_powerlaw(devices8):
    """Overlap mode on a hub-heavy pattern (self part falls back to segsum
    when the windowed kernel rejects the shard)."""
    a = powerlaw_random_csr(500, avg_degree=9, seed=29)
    eng = build_engine(a, 8, 12, devices8, overlap=1)
    b = np.asarray(fill_b(0, a.ncol, 0, 12))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12


@pytest.mark.parametrize("p", [1, 4])
def test_rowpara_dd_kernel_fp32_hardware(p, devices8):
    """The double-float kernel reaches the reference's <=1e-12 acceptance
    with fp32-only device arithmetic (fp64 parity without fp64 units)."""
    import jax

    a = banded_random_csr(400, nnz_per_row=7, bandwidth=40, seed=34)
    n = 12
    eng = build_engine(a, p, n, devices8, kernel="dd")
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    bs = eng.shard_b(b)
    assert bs.dtype == np.float32 and bs.shape[-1] == 2 * n
    c = eng.exec(b)
    assert c.dtype == np.float64
    assert rel_fro_err(a.spmm_ref(b), c) <= 1e-12


def test_rowpara_dd_rejects_overlap(devices8):
    a = banded_random_csr(100, nnz_per_row=4, bandwidth=10, seed=35)
    with pytest.raises(ValueError, match="dd"):
        build_engine(a, 4, 8, devices8, kernel="dd", overlap=1)


def test_rowpara_no_reidx(devices8):
    a = banded_random_csr(300, nnz_per_row=5, bandwidth=25, seed=21)
    b = np.asarray(fill_b(0, a.ncol, 0, 8))
    c = build_engine(a, 4, 8, devices8, reidx=0).exec(b)
    assert rel_fro_err(a.spmm_ref(b), c) <= 1e-12


def test_rowpara_rectangular(devices8):
    """m != k: B rows partitioned uniformly (reference planner rule)."""
    a0 = banded_random_csr(400, nnz_per_row=6, bandwidth=30, seed=22)
    keep = a0.colidx < 250
    rows = np.repeat(np.arange(a0.nrow), np.diff(a0.rowptr))[keep]
    from crp_tpu.sparse.csr import CSRMatrix
    a = CSRMatrix.from_coo(400, 250, rows, a0.colidx[keep], a0.val[keep])
    b = np.asarray(fill_b(0, 250, 0, 10))
    c = build_engine(a, 4, 10, devices8).exec(b)
    assert rel_fro_err(a.spmm_ref(b), c) <= 1e-12


def test_rowpara_exec_repeated_and_timed(devices8):
    a = banded_random_csr(200, nnz_per_row=5, bandwidth=15, seed=23)
    eng = build_engine(a, 4, 8, devices8)
    b = np.asarray(fill_b(0, a.ncol, 0, 8))
    ref = a.spmm_ref(b)
    bs = eng.shard_b(b)
    for _ in range(3):
        c = eng.exec_timed(bs)
    assert rel_fro_err(ref, eng.unshard_c(c)) <= 1e-12
    assert eng.timer.n_exec == 3
    stat = eng.print_stat()
    assert "Local SpMM" in stat and "Redistribute B" in stat


def test_rowpara_audit_matches_planner(devices8):
    from crp_tpu.plan.partition1d import csr_row_part_comm_size

    a = powerlaw_random_csr(400, avg_degree=7, seed=24)
    eng = build_engine(a, 8, 16, devices8)
    _, total = csr_row_part_comm_size(
        a.ncol, a.rowptr, a.colidx, eng.A_row_displs, eng.B_row_displs
    )
    assert eng.rB_recv_size == total


def test_rowpara_fp32_tolerance(devices8):
    """fp32 path stays within fp32 tolerance."""
    a = banded_random_csr(300, nnz_per_row=6, bandwidth=20, seed=25)
    displs = csr_row_partition(a.rowptr, 4)
    mesh = make_mesh_1d(4, devices=devices8)
    eng = RowParaSpmm(a, displs, displs, 8, mesh=mesh, dtype=np.float32)
    b = np.asarray(fill_b(0, a.ncol, 0, 8, dtype=np.float32))
    c = eng.exec(b)
    assert rel_fro_err(a.spmm_ref(b), c) <= 1e-5


def test_rowpara_ell_kernel(devices8):
    """Engine with the ELL slot-scan local kernel."""
    a = banded_random_csr(300, nnz_per_row=6, bandwidth=25, seed=26)
    displs = csr_row_partition(a.rowptr, 4)
    mesh = make_mesh_1d(4, devices=devices8)
    eng = RowParaSpmm(a, displs, displs, 8, mesh=mesh,
                      config=SpmmConfig(kernel="ell"))
    b = np.asarray(fill_b(0, a.ncol, 0, 8))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12


def test_rowpara_triton_kernel(devices8, triton_interpret):
    """Engine with the Pallas CSR kernel (interpret mode on CPU)."""
    a = banded_random_csr(300, nnz_per_row=6, bandwidth=25, seed=27)
    displs = csr_row_partition(a.rowptr, 4)
    mesh = make_mesh_1d(4, devices=devices8)
    eng = RowParaSpmm(a, displs, displs, 8, mesh=mesh,
                      config=SpmmConfig(kernel="triton"))
    assert eng.kernel_kind == "triton"
    b = np.asarray(fill_b(0, a.ncol, 0, 8))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12


def test_rowpara_bfloat16(devices8):
    """bf16 storage + compute end-to-end (the memory-saving mode)."""
    import jax.numpy as jnp

    a = banded_random_csr(400, nnz_per_row=6, bandwidth=30, seed=41)
    displs = csr_row_partition(a.rowptr, 4)
    mesh = make_mesh_1d(4, devices=devices8)
    eng = RowParaSpmm(a, displs, displs, 16, mesh=mesh, dtype=jnp.bfloat16)
    b = np.asarray(fill_b(0, a.ncol, 0, 16, dtype=np.float32))
    c = eng.exec(b)
    assert c.dtype == jnp.bfloat16
    assert rel_fro_err(a.spmm_ref(b.astype(np.float64)),
                       c.astype(np.float64)) <= 3e-2


def test_rowpara_matrix_with_empty_rows(devices8):
    """Rows without nonzeros and a sparse tail (scatter drop paths)."""
    from crp_tpu.sparse.csr import CSRMatrix

    rows = np.array([0, 0, 5, 9])
    cols = np.array([1, 3, 2, 9])
    vals = np.array([1.0, 2.0, 3.0, 4.0])
    a = CSRMatrix.from_coo(10, 10, rows, cols, vals)
    eng = RowParaSpmm(a, csr_row_partition(a.rowptr, 2), np.array([0, 5, 10]),
                      4, mesh=make_mesh_1d(2, devices=devices8))
    b = np.asarray(fill_b(0, 10, 0, 4))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12


def test_rowpara_trailing_empty_rows_referenced_columns(devices8):
    """Square matrix with empty trailing rows whose columns ARE referenced:
    nnz-balanced row blocks exclude those rows, so reusing them as B
    ownership must not silently drop the referenced B rows (regression:
    this returned wrong results without an error)."""
    from crp_tpu.sparse.csr import CSRMatrix

    rows = np.array([0, 1, 2, 3, 0])
    cols = np.array([1, 2, 3, 0, 15])   # col 15 referenced, row 15 empty
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    a = CSRMatrix.from_coo(16, 16, rows, cols, vals)
    displs = csr_row_partition(a.rowptr, 4)
    assert displs[-1] < 16  # the partition really does truncate
    eng = RowParaSpmm(a, displs, displs, 4,
                      mesh=make_mesh_1d(4, devices=devices8))
    b = np.asarray(fill_b(0, 16, 0, 4))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12


def test_bc_layout_col_major_view(devices8):
    """Reference BC_layout=1 (src/rowpara_spmm.c:225-264,400-407): B
    arrives as (n, k), C returns as (n, m); the conversion is a
    device-side XLA transpose, not a host copy in disguise."""
    a = banded_random_csr(700, nnz_per_row=7, bandwidth=45, seed=77)
    n = 24
    displs = csr_row_partition(a.rowptr, 3)
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    ref = a.spmm_ref(b)

    eng = RowParaSpmm(
        a, displs, displs, n, mesh=make_mesh_1d(3, devices=devices8[:3]),
        config=SpmmConfig(bc_layout=1),
    )
    c_t = eng.exec(np.ascontiguousarray(b.T))  # (n, k) in
    assert c_t.shape == (n, a.nrow)            # (n, m) out
    assert rel_fro_err(ref.T, c_t) <= 1e-12

    # dd keeps its packed-halves contract: BC_layout must be rejected
    import pytest as _pytest
    with _pytest.raises(ValueError, match="BC_layout"):
        RowParaSpmm(
            a, displs, displs, n,
            mesh=make_mesh_1d(3, devices=devices8[:3]),
            config=SpmmConfig(bc_layout=1, kernel="dd"),
        )


@pytest.mark.parametrize("kernel", ["segsum", "ell", "triton", "dd"])
def test_n_equals_one_spmv_degenerate(kernel, devices8, triton_interpret):
    """n = 1 (the SpMV degenerate): every kernel pads the n-tile internally
    and slices back; the reference supports any glb_n >= 1 implicitly."""
    dtype = np.float64
    a = banded_random_csr(600, nnz_per_row=7, bandwidth=50, seed=91,
                          dtype=dtype)
    displs = csr_row_partition(a.rowptr, 2)
    eng = RowParaSpmm(
        a, displs, displs, 1, mesh=make_mesh_1d(2, devices=devices8[:2]),
        config=SpmmConfig(kernel=kernel), dtype=dtype,
    )
    b = np.random.default_rng(2).standard_normal((a.ncol, 1)).astype(dtype)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= tol


def test_bc_layout_rejected_outside_rowpara(devices8):
    """bc_layout=1 must not be silently ignored by the 2D / any-layout
    engines (it changes the user-facing array orientation)."""
    import pytest as _pytest

    from crp_tpu.engine.para2d import Para2dSpmm
    from crp_tpu.plan.planner2d import plan_from_csr

    a = banded_random_csr(300, nnz_per_row=5, bandwidth=20, seed=3)
    plan = plan_from_csr(a, 8, 4)
    with _pytest.raises(ValueError, match="BC_layout"):
        Para2dSpmm(a, plan, config=SpmmConfig(bc_layout=1))

    from crp_tpu.engine.crp import CrpSpmm
    from crp_tpu.shard.redist import BlockDist
    from crp_tpu.utils.blocks import uniform_displs

    user_B = BlockDist.from_row_slabs(uniform_displs(a.ncol, 4), 8)
    user_C = BlockDist.from_row_slabs(uniform_displs(a.nrow, 4), 8)
    with _pytest.raises(ValueError, match="BC_layout"):
        CrpSpmm(a, 8, user_B, user_C, nproc=4,
                config=SpmmConfig(bc_layout=1))
