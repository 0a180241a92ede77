"""End-to-end 2D engine tests on the 8-device CPU mesh.

Mirrors the reference's ``test_para2d_spmm`` driver: plan -> distribute ->
replicate A -> exec -> redistribute C -> fp64 check (<= 1e-12).
"""

import numpy as np
import pytest

from crp_tpu.engine.para2d import Para2dSpmm
from crp_tpu.plan.planner2d import plan_from_csr, Plan2D
from crp_tpu.plan.partition1d import csr_row_partition
from crp_tpu.sparse.synth import banded_random_csr, powerlaw_random_csr, fill_b
from crp_tpu.shard.layout import make_mesh_2d
from crp_tpu.utils.blocks import uniform_displs
from crp_tpu.utils.norms import rel_fro_err


def force_plan(a, n, pm, pn):
    """Build a plan with a forced grid (for exercising specific shapes)."""
    nproc = pm * pn
    rb = csr_row_partition(a.rowptr, nproc)
    AC = rb[::pn].copy()
    A0 = rb.copy()
    return Plan2D(
        nproc=nproc, m=a.nrow, n=n, k=a.ncol, pm=pm, pn=pn, comm_cost=0,
        A0_rowptr=A0, B_rowptr=AC if a.nrow == a.ncol else uniform_displs(a.ncol, pm),
        AC_rowptr=AC, BC_colptr=uniform_displs(n, pn),
    )


@pytest.mark.parametrize("pm,pn", [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2), (3, 2)])
def test_para2d_grids(pm, pn, devices8):
    a = banded_random_csr(400, nnz_per_row=7, bandwidth=35, seed=30)
    n = 20
    plan = force_plan(a, n, pm, pn)
    mesh = make_mesh_2d(pm, pn, devices=devices8)
    eng = Para2dSpmm(a, plan, mesh=mesh)
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    c = eng.exec(b)
    assert rel_fro_err(a.spmm_ref(b), c) <= 1e-12


@pytest.mark.parametrize("mode", [dict(rb_p2p=1), dict(overlap=1)])
def test_para2d_ring_and_overlap(mode, devices8):
    """Ring exchange and overlapped exec on a pm x pn grid (exchange along
    pm inside each of the pn column groups)."""
    from crp_tpu.config import SpmmConfig

    a = banded_random_csr(400, nnz_per_row=7, bandwidth=45, seed=33)
    n = 20
    plan = force_plan(a, n, 4, 2)
    mesh = make_mesh_2d(4, 2, devices=devices8)
    eng = Para2dSpmm(a, plan, mesh=mesh, config=SpmmConfig(**mode))
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12


def test_para2d_dd_kernel(devices8):
    """Double-float kernel on a 2D grid: fp32 device arrays, fp64-class
    result, including narrow (padded) column slabs."""
    from crp_tpu.config import SpmmConfig

    a = banded_random_csr(400, nnz_per_row=7, bandwidth=40, seed=37)
    n = 13  # not divisible by pn -> narrow last slab exercises the hi/lo halves
    plan = force_plan(a, n, 2, 4)
    mesh = make_mesh_2d(2, 4, devices=devices8)
    eng = Para2dSpmm(a, plan, mesh=mesh, config=SpmmConfig(kernel="dd"))
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    c = eng.exec(b)
    assert c.dtype == np.float64
    assert rel_fro_err(a.spmm_ref(b), c) <= 1e-12


def test_para2d_planner_chosen_grid(devices8):
    """Use the actual planner decision end-to-end (flagship path,
    SURVEY.md section 3.1)."""
    a = powerlaw_random_csr(600, avg_degree=12, seed=31)
    n = 64
    plan = plan_from_csr(a, n, 8)
    mesh = make_mesh_2d(plan.pm, plan.pn, devices=devices8)
    eng = Para2dSpmm(a, plan, mesh=mesh)
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    c = eng.exec(b)
    assert rel_fro_err(a.spmm_ref(b), c) <= 1e-12


def test_para2d_uneven_column_slabs(devices8):
    """n not divisible by pn -> padded column slabs must still be exact."""
    a = banded_random_csr(300, nnz_per_row=5, bandwidth=25, seed=32)
    plan = force_plan(a, 13, 2, 4)
    eng = Para2dSpmm(a, plan, mesh=make_mesh_2d(2, 4, devices=devices8))
    b = np.asarray(fill_b(0, a.ncol, 0, 13))
    c = eng.exec(b)
    assert rel_fro_err(a.spmm_ref(b), c) <= 1e-12


def test_para2d_audit_and_stats(devices8):
    a = banded_random_csr(300, nnz_per_row=6, bandwidth=30, seed=33)
    plan = force_plan(a, 16, 4, 2)
    eng = Para2dSpmm(a, plan, mesh=make_mesh_2d(4, 2, devices=devices8))
    b = np.asarray(fill_b(0, a.ncol, 0, 16))
    eng.exec(b)
    # rA_cost formula parity: last A0 block nnz * (pn-1) * 1.5
    last_nnz = int(a.rowptr[plan.A0_rowptr[-1]] - a.rowptr[plan.A0_rowptr[-2]])
    assert eng.rA_cost == int(last_nnz * (plan.pn - 1) * 1.5)
    stat = eng.print_stat()
    assert "replicating A" in stat and "replicating B" in stat


def test_para2d_rB_volume_equals_plan_prediction(devices8):
    """Engine's audit count == planner's rB prediction (same counting)."""
    a = powerlaw_random_csr(500, avg_degree=9, seed=34)
    plan = plan_from_csr(a, 32, 8)
    if plan.pm == 1:
        pytest.skip("planner chose full replication; no B exchange")
    eng = Para2dSpmm(a, plan, mesh=make_mesh_2d(plan.pm, plan.pn, devices=devices8))
    assert eng.rB_recv_size * plan.n == plan.rB_cost


def test_para2d_spmv_n1(devices8):
    """n=1 (the reference's vary_n lower end, plot_vary_n2.m)."""
    a = banded_random_csr(600, nnz_per_row=6, bandwidth=30, seed=70)
    plan = plan_from_csr(a, 1, 8)
    eng = Para2dSpmm(a, plan,
                     mesh=make_mesh_2d(plan.pm, plan.pn, devices=devices8))
    b = np.asarray(fill_b(0, a.ncol, 0, 1))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12


def test_para2d_rectangular_planner(devices8):
    """m != k through the planner (uniform B rows, m==k rule off)."""
    from crp_tpu.sparse.csr import CSRMatrix

    a0 = banded_random_csr(500, nnz_per_row=6, bandwidth=40, seed=71)
    keep = a0.colidx < 300
    rows = np.repeat(np.arange(a0.nrow), np.diff(a0.rowptr))[keep]
    a = CSRMatrix.from_coo(500, 300, rows, a0.colidx[keep], a0.val[keep])
    plan = plan_from_csr(a, 16, 8)
    eng = Para2dSpmm(a, plan,
                     mesh=make_mesh_2d(plan.pm, plan.pn, devices=devices8))
    b = np.asarray(fill_b(0, 300, 0, 16))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12


@pytest.mark.parametrize("kernel", ["ell", "triton"])
@pytest.mark.parametrize("pm,pn", [(2, 2), (4, 1)])
def test_para2d_local_kernels_powerlaw(kernel, pm, pn, devices8,
                                       triton_interpret):
    """The kept local kernels shard over pm and replicate over pn: a
    power-law matrix (hub rows, scattered columns) through the 2D engine
    matches the fp64 reference."""
    from crp_tpu.config import SpmmConfig

    a = powerlaw_random_csr(1600, avg_degree=12, seed=41)
    n = 16
    plan = force_plan(a, n, pm, pn)
    mesh = make_mesh_2d(pm, pn, devices=devices8)
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    eng = Para2dSpmm(a, plan, mesh=mesh, config=SpmmConfig(kernel=kernel))
    assert eng.kernel_kind == kernel
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12
