"""End-to-end any-layout CrpSpmm engine tests (v1 crpspmm_engine parity).

Mirrors the reference driver ``deprecated/examples/test_crpspmm.c``: user
owns B and C in arbitrary 2D blocks; analytic B; fp64 reference check."""

import numpy as np
import pytest

from crp_tpu.config import SpmmConfig
from crp_tpu.engine.crp import CrpSpmm
from crp_tpu.shard.layout import make_mesh_2d
from crp_tpu.shard.redist import BlockDist
from crp_tpu.sparse.synth import banded_random_csr, powerlaw_random_csr, fill_b
from crp_tpu.utils.blocks import uniform_displs
from crp_tpu.utils.norms import rel_fro_err


def user_grid(m, n, pr, pc):
    return BlockDist.from_grid(uniform_displs(m, pr), uniform_displs(n, pc))


def build(a, n, p, devices8, config=None, user_B=None, user_C=None):
    user_B = user_B if user_B is not None else user_grid(a.ncol, n, p, 1)
    user_C = user_C if user_C is not None else user_grid(a.nrow, n, 1, p)
    eng = CrpSpmm.__new__(CrpSpmm)
    # need the planner's grid to build the mesh, so construct in two steps
    from crp_tpu.plan.bandwidth import calc_bandwidth_part2d

    bp = calc_bandwidth_part2d(p, a.nrow, n, a.ncol, a.rowptr, a.row_col_ranges_v1())
    mesh = make_mesh_2d(bp.np_row, bp.np_col, devices=devices8)
    return CrpSpmm(a, n, user_B, user_C, nproc=p, mesh=mesh, config=config)


@pytest.mark.parametrize("p", [2, 4, 8])
def test_crp_banded(p, devices8):
    a = banded_random_csr(400, nnz_per_row=40, bandwidth=30, seed=40)
    n = 12
    eng = build(a, n, p, devices8)
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    c = eng.exec(b)
    assert rel_fro_err(a.spmm_ref(b), c) <= 1e-12


def test_crp_powerlaw_splits_n(devices8):
    """Unstructured matrix: planner splits N; exchange degenerates."""
    a = powerlaw_random_csr(500, avg_degree=4, seed=41)
    n = 16
    eng = build(a, n, 8, devices8)
    assert eng.pn > 1
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12


def test_crp_finegrain_mode(devices8):
    """A2A_B_FINEGRAIN analog: exact referenced rows travel; the audit's
    Alltoallv B equals the 'necessary' metric (crpspmm.c:339-396)."""
    a = banded_random_csr(400, nnz_per_row=30, bandwidth=40, seed=42)
    n = 8
    cfg = SpmmConfig(a2a_b_finegrain=1)
    eng = build(a, n, 8, devices8, config=cfg)
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12
    if eng.pm > 1:
        assert eng.nelem_B_a2av == eng.nelem_B_a2av_min


def test_crp_coarse_upper_bounds_necessary(devices8):
    a = banded_random_csr(400, nnz_per_row=30, bandwidth=40, seed=42)
    eng = build(a, 8, 8, devices8)
    if eng.pm > 1:
        assert eng.nelem_B_a2av >= eng.nelem_B_a2av_min
        assert eng.nelem_B_rd == a.ncol * 8  # whole B redistributed once


def test_crp_arbitrary_user_layouts(devices8):
    """B given as column slabs, C wanted as 4x2 grid blocks."""
    a = banded_random_csr(300, nnz_per_row=25, bandwidth=25, seed=43)
    n = 10
    user_B = user_grid(a.ncol, n, 1, 8)
    user_C = user_grid(a.nrow, n, 4, 2)
    eng = build(a, n, 8, devices8, user_B=user_B, user_C=user_C)
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12


def test_crp_gather_all_to_root(devices8):
    """The README validation path: C gathered on device 0."""
    a = banded_random_csr(200, nnz_per_row=20, bandwidth=15, seed=44)
    n = 6
    user_C = user_grid(a.nrow, n, 1, 8).gather_single(a.nrow, n, root=0)
    eng = build(a, n, 8, devices8, user_C=user_C)
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    c = eng.exec(b)
    assert rel_fro_err(a.spmm_ref(b), c) <= 1e-12
    stat = eng.print_stat()
    assert "Alltoallv B necessary" in stat


def test_crp_rb_p2p_modes_agree(devices8):
    """rb_p2p=0 (padded all_to_all) and rb_p2p=1 (ppermute ring) produce
    identical results (RP_SPMM_P2P analog honored by the v1 engine)."""
    a = banded_random_csr(400, nnz_per_row=30, bandwidth=40, seed=48)
    n = 8
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    ref = a.spmm_ref(b)
    for p2p in (0, 1):
        eng = build(a, n, 8, devices8, config=SpmmConfig(rb_p2p=p2p))
        assert rel_fro_err(ref, eng.exec(b)) <= 1e-12


def test_crp_overlap_schedule(devices8):
    """overlap=1: ring exchange fused with per-shift partial SpMM."""
    a = banded_random_csr(400, nnz_per_row=30, bandwidth=40, seed=49)
    n = 8
    eng = build(a, n, 8, devices8, config=SpmmConfig(overlap=1))
    assert eng.overlap
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12


def test_crp_dd_kernel(devices8):
    """kernel='dd': fp64-class result from fp32 hi/lo halves end-to-end
    through both redistributions."""
    a = banded_random_csr(300, nnz_per_row=20, bandwidth=30, seed=50)
    n = 8
    eng = build(a, n, 4, devices8, config=SpmmConfig(kernel="dd"))
    assert eng.is_dd and eng.kernel_kind == "dd"
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12


def test_crp_staged_phase_accounting(devices8):
    """exec() fences exchange and SpMM separately — the a2a_B phase must
    time the actual exchange (ADVICE r1: it used to fence a reshape)."""
    a = banded_random_csr(400, nnz_per_row=30, bandwidth=40, seed=51)
    n = 8
    eng = build(a, n, 8, devices8)
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    eng.exec(b)
    if eng.pm > 1:
        assert len(eng.timer.samples["a2a_B"]) == 1
        assert len(eng.timer.samples["spmm"]) == 1
    stat = eng.print_stat()
    assert "Replicate B with alltoallv" in stat
    assert "SpMM w/o Redist" in stat


@pytest.mark.parametrize("kernel", ["ell", "triton"])
def test_crp_local_kernel_nonmultiple_rows(kernel, devices8, triton_interpret):
    """The kept local kernels return exactly max_m rows into rd_C's internal
    layout (max_m=100 is no multiple of any tile) and match the fp64
    reference."""
    a = banded_random_csr(400, nnz_per_row=30, bandwidth=30, seed=47)
    n = 8
    eng = build(a, n, 4, devices8, config=SpmmConfig(kernel=kernel))
    assert eng.kernel_kind == kernel
    assert eng.max_m % 16 != 0
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12


@pytest.mark.parametrize("kernel", ["ell", "triton"])
def test_crp_overlap_local_kernels(kernel, devices8, triton_interpret):
    """overlap=1 with the ring's self part on each kept kernel."""
    a = banded_random_csr(800, nnz_per_row=30, bandwidth=40, seed=52)
    n = 8
    eng = build(a, n, 8, devices8,
                config=SpmmConfig(overlap=1, kernel=kernel))
    assert eng.overlap and eng.kernel_kind == kernel
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12


@pytest.mark.parametrize("kernel", ["segsum", "triton"])
def test_crp_powerlaw_finegrain_kernels(kernel, devices8, triton_interpret):
    """A2A_B_FINEGRAIN=1 (exact referenced rows) on a power-law matrix with
    hub rows, through each kernel."""
    a = powerlaw_random_csr(1200, avg_degree=10, seed=53)
    n = 16
    eng = build(a, n, 4, devices8,
                config=SpmmConfig(kernel=kernel, a2a_b_finegrain=1))
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12
