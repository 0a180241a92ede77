"""crp-bench — end-to-end SpMM driver (the ``test_para2d_spmm`` equivalent).

Usage: crp-bench <mtx-file|synth:spec> <num-of-B-col> <num-of-tests>
                 <part-method> [<check-correct>] [--engine=para2d|rowpara|crp]
                 [--kernel=auto|segsum|ell|triton|dd]
                 [--dtype=float32|float64] [--devices=N] [--profile=DIR]

Mirrors the reference CLI (``README.md:33-40``): plan -> distribute ->
replicate A -> timed exec loop -> stats -> optional ``||C_ref - C||_F``
check.  <part-method>: 0 native 1D partition, 1 METIS 1D partition
(``test_para2d_spmm.c:50-57``), 2 RCM-reorder first.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .plan_cli import load_matrix


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    pos = [a for a in argv if not a.startswith("--")]
    opt = dict(
        (a[2:].split("=", 1) + ["1"])[:2] for a in argv if a.startswith("--")
    )
    if len(pos) < 4:
        print(
            "Usage: crp-bench <mtx-file|synth:spec> <num-of-B-col> "
            "<num-of-tests> <part-method> [<check-correct>] [--engine=...] "
            "[--kernel=...] [--dtype=...] [--devices=N]"
        )
        return 255
    glb_n, n_test, method = int(pos[1]), int(pos[2]), int(pos[3])
    chk_res = int(pos[4]) if len(pos) > 4 else 0
    engine_kind = opt.get("engine", "para2d")
    dtype = np.dtype(opt.get("dtype", "float32"))
    if "distributed" in opt:
        # multi-process run: the same command runs in every process,
        # jax.distributed derives the rank from the launcher env — the
        # reference's srun/MPI init (SC23_AD/scripts)
        from ..shard.layout import init_distributed

        init_distributed()

    import jax

    from ..utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)

    from ..config import SpmmConfig
    from ..plan.partition1d import csr_row_partition
    from ..plan.planner2d import plan_from_csr
    from ..sparse.synth import fill_b
    from ..utils.norms import rel_fro_err

    nproc = int(opt.get("devices", len(jax.devices())))
    config = SpmmConfig.from_env()
    if "kernel" in opt:
        config.kernel = opt["kernel"]

    a = load_matrix(pos[0], need_symm=method != 0)
    if method == 2:
        from ..sparse.reorder import rcm_reorder

        a, _ = rcm_reorder(a)

    st = time.perf_counter()
    # method=1: plan_from_csr runs METIS_row_partition, which permutes `a`
    # in place exactly like the reference driver (test_para2d_spmm.c:50-57)
    plan = plan_from_csr(a, glb_n, nproc, method="metis" if method == 1 else "nnz")
    print(f"Calculate 2D partitioning time = {time.perf_counter()-st:.2f} s")
    print(f"2D process grid: pm, pn = {plan.pm}, {plan.pn}")

    if engine_kind == "para2d":
        from ..engine.para2d import Para2dSpmm
        from ..shard.layout import make_mesh_2d

        eng = Para2dSpmm(
            a, plan, mesh=make_mesh_2d(plan.pm, plan.pn),
            config=config, dtype=dtype,
        )
    elif engine_kind == "rowpara":
        from ..engine.rowpara import RowParaSpmm
        from ..shard.layout import make_mesh_1d
        from ..utils.blocks import uniform_displs

        rb = csr_row_partition(a.rowptr, nproc)
        b_displs = rb if a.nrow == a.ncol else uniform_displs(a.ncol, nproc)
        eng = RowParaSpmm(
            a, rb, b_displs, glb_n, mesh=make_mesh_1d(nproc),
            config=config, dtype=dtype,
        )
    elif engine_kind == "crp":
        from ..engine.crp import CrpSpmm
        from ..plan.bandwidth import calc_bandwidth_part2d
        from ..shard.layout import make_mesh_2d
        from ..shard.redist import BlockDist
        from ..utils.blocks import uniform_displs

        user_B = BlockDist.from_row_slabs(uniform_displs(a.ncol, nproc), glb_n)
        user_C = BlockDist.from_row_slabs(uniform_displs(a.nrow, nproc), glb_n)
        bp = calc_bandwidth_part2d(
            nproc, a.nrow, glb_n, a.ncol, a.rowptr, a.row_col_ranges_v1()
        )
        eng = CrpSpmm(
            a, glb_n, user_B, user_C, nproc=nproc,
            mesh=make_mesh_2d(bp.np_row, bp.np_col),
            config=config, dtype=dtype, bplan=bp,
        )
    else:
        raise SystemExit(f"unknown engine {engine_kind}")

    b = np.asarray(fill_b(0, a.ncol, 0, glb_n, dtype=dtype))
    c = eng.exec(b)  # warm-up (compile)
    eng.clear_stat()
    profile_dir = opt.get("profile")
    if profile_dir:
        # device-level trace (the reference's phase timers only see host
        # fences; jax.profiler sees the device timeline)
        jax.profiler.start_trace(profile_dir)
    for _ in range(n_test):
        st = time.perf_counter()
        c = eng.exec(b)
        print(f"{time.perf_counter()-st:.4f}")
    if profile_dir:
        jax.profiler.stop_trace()
        print(f"Profiler trace written to {profile_dir}")
    print(eng.print_stat())

    if chk_res:
        err = rel_fro_err(a.spmm_ref(b), c)
        print(f"||C_ref - C||_f / ||C_ref||_f = {err:e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
