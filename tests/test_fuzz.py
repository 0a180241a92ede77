"""Cross-engine/kernel randomized consistency sweep.

Every engine x kernel x schedule combination must agree with the fp64
reference on randomly drawn matrices and shapes — the mechanized version of
the reference's single acceptance check applied across the whole config
matrix (the reference only ever tests one path per driver run).
"""

import numpy as np
import pytest

from crp_tpu.config import SpmmConfig
from crp_tpu.engine.para2d import Para2dSpmm
from crp_tpu.engine.rowpara import RowParaSpmm
from crp_tpu.plan.planner2d import plan_from_csr
from crp_tpu.plan.partition1d import csr_row_partition
from crp_tpu.sparse.synth import banded_random_csr, powerlaw_random_csr, fill_b
from crp_tpu.shard.layout import make_mesh_1d, make_mesh_2d
from crp_tpu.utils.blocks import uniform_displs
from crp_tpu.utils.norms import rel_fro_err


def _random_case(rng):
    if rng.random() < 0.5:
        a = banded_random_csr(
            int(rng.integers(200, 1200)),
            nnz_per_row=int(rng.integers(3, 12)),
            bandwidth=int(rng.integers(10, 80)),
            seed=int(rng.integers(1 << 30)),
        )
    else:
        a = powerlaw_random_csr(
            int(rng.integers(200, 1200)),
            avg_degree=int(rng.integers(4, 14)),
            seed=int(rng.integers(1 << 30)),
        )
    n = int(rng.integers(1, 40))
    return a, n


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_rowpara_configs(trial, devices8, triton_interpret):
    rng = np.random.default_rng(1000 + trial)
    a, n = _random_case(rng)
    p = int(rng.choice([2, 3, 4, 7]))
    cfg = SpmmConfig(
        rb_p2p=int(rng.integers(0, 2)),
        rb_reidx=int(rng.integers(0, 2)),
        overlap=int(rng.random() < 0.3),
        kernel=str(rng.choice(["segsum", "ell", "dd", "triton"])),
    )
    if cfg.kernel == "dd" and cfg.overlap:
        cfg.overlap = 0
    displs = csr_row_partition(a.rowptr, p)
    b_displs = displs if a.nrow == a.ncol else uniform_displs(a.ncol, p)
    eng = RowParaSpmm(a, displs, b_displs, n,
                      mesh=make_mesh_1d(p, devices=devices8), config=cfg)
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    err = rel_fro_err(a.spmm_ref(b), eng.exec(b))
    assert err <= 1e-12, (err, cfg, a.nrow, a.nnz, n, p)


@pytest.mark.parametrize("trial", range(4))
def test_fuzz_para2d_planner(trial, devices8):
    rng = np.random.default_rng(2000 + trial)
    a, n = _random_case(rng)
    nproc = int(rng.choice([4, 6, 8]))
    plan = plan_from_csr(a, n, nproc)
    cfg = SpmmConfig(overlap=int(rng.random() < 0.5))
    eng = Para2dSpmm(
        a, plan, mesh=make_mesh_2d(plan.pm, plan.pn, devices=devices8),
        config=cfg,
    )
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    err = rel_fro_err(a.spmm_ref(b), eng.exec(b))
    assert err <= 1e-12, (err, plan.pm, plan.pn, a.nrow, a.nnz, n)


@pytest.mark.parametrize("trial", range(3))
def test_fuzz_triton_banded(trial, devices8, triton_interpret):
    """The Pallas CSR kernel on random banded matrices and shard counts."""
    rng = np.random.default_rng(3000 + trial)
    a = banded_random_csr(
        int(rng.integers(400, 2500)),
        nnz_per_row=int(rng.integers(3, 10)),
        bandwidth=int(rng.integers(15, 90)),
        seed=int(rng.integers(1 << 30)),
    )
    n = int(rng.integers(1, 40))
    p = int(rng.choice([2, 3, 5, 7]))
    displs = csr_row_partition(a.rowptr, p)
    eng = RowParaSpmm(a, displs, displs, n,
                      mesh=make_mesh_1d(p, devices=devices8),
                      config=SpmmConfig(kernel="triton"))
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    err = rel_fro_err(a.spmm_ref(b), eng.exec(b))
    assert err <= 1e-12, (err, a.nrow, a.nnz, n, p)


@pytest.mark.parametrize("trial", range(4))
def test_fuzz_crp_configs(trial, devices8, triton_interpret):
    """Any-layout engine across its full switch matrix (rb_p2p / overlap /
    finegrain / kernel), random matrices, random user layouts."""
    from crp_tpu.engine.crp import CrpSpmm
    from crp_tpu.plan.bandwidth import calc_bandwidth_part2d
    from crp_tpu.shard.layout import make_mesh_2d
    from crp_tpu.shard.redist import BlockDist

    rng = np.random.default_rng(4000 + trial)
    a, n = _random_case(rng)
    n = max(n, 2)
    p = int(rng.choice([4, 8]))
    cfg = SpmmConfig(
        rb_p2p=int(rng.integers(0, 2)),
        overlap=int(rng.random() < 0.4),
        a2a_b_finegrain=int(rng.integers(0, 2)),
        kernel=str(rng.choice(["segsum", "ell", "triton", "dd"])),
    )
    if cfg.kernel == "dd" and cfg.overlap:
        cfg.overlap = 0
    # user layouts are one block per device (reference contract: every
    # rank owns one B block and one C block) — random p-factor grids
    def grid(rows, cols):
        facs = [(r, p // r) for r in (1, 2, 4, 8) if p % r == 0 and r <= rows
                and p // r <= cols]
        r, c = facs[int(rng.integers(len(facs)))]
        return BlockDist.from_grid(
            uniform_displs(rows, r), uniform_displs(cols, c)
        )

    user_B = grid(a.ncol, n)
    user_C = grid(a.nrow, n)
    bp = calc_bandwidth_part2d(
        p, a.nrow, n, a.ncol, a.rowptr, a.row_col_ranges_v1()
    )
    mesh = make_mesh_2d(bp.np_row, bp.np_col, devices=devices8)
    eng = CrpSpmm(a, n, user_B, user_C, nproc=p, mesh=mesh, config=cfg,
                  bplan=bp)
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    err = rel_fro_err(a.spmm_ref(b), eng.exec(b))
    assert err <= 1e-12, (err, cfg, a.nrow, a.nnz, n, p, eng.kernel_kind)


@pytest.mark.parametrize("trial", range(4))
def test_fuzz_any_csr_triton(trial, devices8, triton_interpret):
    """ANY random scatter CSR runs through kernel="triton" in fp32 and
    agrees with the fp64 reference — the "any CSR works" guarantee the
    reference's MKL/cuSPARSE seam gives (src/rowpara_spmm.c:398-407)."""
    from crp_tpu.sparse.csr import CSRMatrix

    rng = np.random.default_rng(5000 + trial)
    nr = int(rng.integers(100, 800))
    k = int(rng.integers(1000, 30000))
    deg = int(rng.integers(1, 8))
    rows = np.repeat(np.arange(nr, dtype=np.int64), deg)
    cols = rng.integers(0, k, size=deg * nr)
    a = CSRMatrix.from_coo(
        nr, k, rows, cols, rng.standard_normal(deg * nr)
    )
    n = int(rng.integers(1, 24))
    p = int(rng.integers(2, 5))
    displs = csr_row_partition(a.rowptr, p)
    eng = RowParaSpmm(
        a, displs, uniform_displs(a.ncol, p), n,
        mesh=make_mesh_1d(p, devices=devices8),
        config=SpmmConfig(
            kernel="triton", rb_reidx=int(rng.random() < 0.5)
        ),
        dtype=np.float32,
    )
    b = np.asarray(fill_b(0, a.ncol, 0, n), dtype=np.float32)
    err = rel_fro_err(a.spmm_ref(b), eng.exec(b))
    assert err <= 1e-4, (eng.kernel_kind, err, nr, k, deg, n, p)
