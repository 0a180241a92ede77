"""Drive the SpMM engines once on the GPU at the reference's sizes and check
every result against the fp64 host reference.

    python chip_smoke.py           # one card: the phases below
    python chip_smoke.py --four    # four cards: the multi-device paths only

One card: the reference README's matrix (pwtk-class banded, 217,918 rows,
~11.4M nnz; ``banded_random_csr(217918, 53, 2500, seed=1234)``) at n = 256
through ``plan_from_csr`` -> ``Para2dSpmm`` and through ``RowParaSpmm``, each
in fp32 and native fp64; the scrambled community power-law matrix (786,432
rows, ~10.8M nnz) through ``Para2dSpmm`` in fp32; and one training step of
``DifferentiableSpmm`` (forward, then ``jax.grad`` through the A^T engine).

Four cards (``--four``): the README matrix at p = 4 through the planner's
grid in ``Para2dSpmm`` (fp32 and fp64), ``RowParaSpmm`` with the padded
all_to_all, the ppermute ring and the overlapped ring, ``CrpSpmm`` with
uniform user row slabs, and the power-law matrix through ``Para2dSpmm``.

Every phase is compared with ``CSRMatrix.spmm_ref`` by the reference's
metric ``||C_ref - C||_F / ||C_ref||_F``: at most 1e-12 in fp64 (the
reference's own bar) and 1e-5 in fp32 (products summed in another order,
partly by atomics).  Each phase prints the matrix, dtype, the kernel kind
that ran, the error against its bound, the set-up and first-exec seconds
and the median exec seconds over ``block_until_ready``-fenced runs.  The
last line is ``{"ok": true, "device": {...}}``, printed only when every
phase passed; without a GPU the script exits non-zero before any phase.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

N_COLS = 256
W1_ROWS = 217918
PLAW_ROWS = 786432
TOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-12}
REPS = 5


# ---------------------------------------------------------------- matrices
def w1_matrix(nrow: int = W1_ROWS):
    """The reference README's pwtk-class run (ROADMAP W1)."""
    from crp_tpu.sparse.synth import banded_random_csr

    bw = 2500 if nrow == W1_ROWS else max(nrow // 80, 8)
    return banded_random_csr(nrow, nnz_per_row=53, bandwidth=bw, seed=1234)


def plaw_matrix(nrow: int = PLAW_ROWS):
    """Scrambled community power-law graph (social-graph class)."""
    from crp_tpu.sparse.synth import powerlaw_community_csr

    return powerlaw_community_csr(
        nrow, avg_degree=16, comm_size=min(1024, max(nrow // 16, 8)),
        permute=True,
    )


# ------------------------------------------------------------------ phases
def _check(a, b, c, dtype) -> tuple[float, float]:
    from crp_tpu.utils.norms import rel_fro_err

    ref = a.spmm_ref(np.asarray(b, np.float64))
    return float(rel_fro_err(ref, np.asarray(c, np.float64))), TOL[np.dtype(dtype)]


def _time_engine(build, a, n, dtype):
    """Build an engine, run it once (compile), then REPS fenced execs.
    Returns (engine, C on the host, setup_s, first_s, exec times)."""
    from crp_tpu.sparse.synth import fill_b

    t0 = time.perf_counter()
    eng = build()
    setup_s = time.perf_counter() - t0
    b = np.asarray(fill_b(0, a.ncol, 0, n, dtype=dtype))
    t0 = time.perf_counter()
    bs = eng.shard_b(b)
    out = eng.exec_device(bs)
    out.block_until_ready()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = eng.exec_device(bs)
        out.block_until_ready()
        times.append(time.perf_counter() - t0)
    return eng, b, out, setup_s, first_s, times


def _result(phase, matrix, a, dtype, kernel, err, tol, setup_s, first_s,
            times, **extra):
    return dict(
        phase=phase, matrix=matrix, nrow=a.nrow, nnz=int(a.nnz),
        dtype=np.dtype(dtype).name, kernel=kernel, rel_err=err, tol=tol,
        ok=bool(np.isfinite(err) and err <= tol), setup_s=setup_s,
        first_exec_s=first_s, exec_median_s=float(np.median(times)),
        exec_samples=len(times), **extra,
    )


def phase_para2d(a, matrix, n, dtype, nproc=1, devices=None):
    """``plan_from_csr`` -> ``Para2dSpmm`` on the planner's pm x pn grid."""
    from crp_tpu.engine.para2d import Para2dSpmm
    from crp_tpu.plan.planner2d import plan_from_csr
    from crp_tpu.shard.layout import make_mesh_2d

    plan = plan_from_csr(a, n, nproc)

    def build():
        mesh = make_mesh_2d(plan.pm, plan.pn, devices=devices)
        return Para2dSpmm(a, plan, mesh=mesh, dtype=dtype)

    eng, b, out, setup_s, first_s, times = _time_engine(build, a, n, dtype)
    err, tol = _check(a, b, eng.unshard_c(out), dtype)
    return _result(f"para2d_p{nproc}", matrix, a, dtype, eng.kernel_kind,
                   err, tol, setup_s, first_s, times,
                   grid=[plan.pm, plan.pn])


def phase_rowpara(a, matrix, n, dtype, p=1, devices=None, rb_p2p=1,
                  overlap=0):
    """``RowParaSpmm`` on nnz-balanced row blocks (``bench.py``'s path)."""
    from crp_tpu.config import SpmmConfig
    from crp_tpu.engine.rowpara import RowParaSpmm
    from crp_tpu.plan.partition1d import csr_row_partition
    from crp_tpu.shard.layout import make_mesh_1d

    displs = csr_row_partition(a.rowptr, p)
    config = SpmmConfig(rb_p2p=rb_p2p, overlap=overlap)

    def build():
        return RowParaSpmm(a, displs, displs, n, config=config, dtype=dtype,
                           mesh=make_mesh_1d(p, devices=devices))

    eng, b, out, setup_s, first_s, times = _time_engine(build, a, n, dtype)
    err, tol = _check(a, b, eng.unshard_c(out), dtype)
    mode = "overlap" if overlap else ("ring" if rb_p2p else "a2a")
    return _result(f"rowpara_p{p}_{mode}", matrix, a, dtype, eng.kernel_kind,
                   err, tol, setup_s, first_s, times)


def phase_crp(a, matrix, n, dtype, p, devices=None):
    """``CrpSpmm`` with uniform user row slabs of B in and C out."""
    from crp_tpu.engine.crp import CrpSpmm
    from crp_tpu.plan.bandwidth import calc_bandwidth_part2d
    from crp_tpu.shard.layout import make_mesh_2d
    from crp_tpu.shard.redist import BlockDist
    from crp_tpu.utils.blocks import uniform_displs

    user_B = BlockDist.from_row_slabs(uniform_displs(a.ncol, p), n)
    user_C = BlockDist.from_row_slabs(uniform_displs(a.nrow, p), n)
    bp = calc_bandwidth_part2d(p, a.nrow, n, a.ncol, a.rowptr,
                               a.row_col_ranges_v1())

    def build():
        mesh = make_mesh_2d(bp.np_row, bp.np_col, devices=devices)
        return CrpSpmm(a, n, user_B, user_C, nproc=p, mesh=mesh, dtype=dtype,
                       bplan=bp)

    from crp_tpu.sparse.synth import fill_b

    t0 = time.perf_counter()
    eng = build()
    setup_s = time.perf_counter() - t0
    b = np.asarray(fill_b(0, a.ncol, 0, n, dtype=dtype))
    bs = eng.rd_B.shard_src(b)
    t0 = time.perf_counter()
    out = eng.exec_device(bs)
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        out = eng.exec_device(bs)  # fences every phase itself
        times.append(time.perf_counter() - t0)
    err, tol = _check(a, b, eng.rd_C.unshard_dst(out, a.nrow, n), dtype)
    return _result(f"crp_p{p}", matrix, a, dtype, eng.kernel_kind, err, tol,
                   setup_s, first_s, times, grid=[eng.pm, eng.pn])


def phase_train_step(a, matrix, n, p=1, devices=None):
    """One training step through ``DifferentiableSpmm`` in fp32: the loss
    ``sum(W * (A @ B))`` and its gradient ``A^T @ W`` (the A^T engine)."""
    import jax
    import jax.numpy as jnp

    from crp_tpu.engine.autodiff import DifferentiableSpmm
    from crp_tpu.plan.partition1d import csr_row_partition
    from crp_tpu.shard.layout import make_mesh_1d, shard_dense_rows
    from crp_tpu.sparse.synth import fill_b
    from crp_tpu.utils.norms import rel_fro_err

    dtype = np.float32
    displs = csr_row_partition(a.rowptr, p)
    t0 = time.perf_counter()
    ds = DifferentiableSpmm(a, displs, displs, n, dtype=dtype,
                            mesh=make_mesh_1d(p, devices=devices))
    setup_s = time.perf_counter() - t0
    b = np.asarray(fill_b(0, a.ncol, 0, n, dtype=dtype))
    w = np.random.default_rng(7).standard_normal((a.nrow, n)).astype(dtype)
    bs = ds.shard_b(b)
    ws = jnp.asarray(shard_dense_rows(w, ds.fwd.A_row_displs,
                                      pad_rows=ds.fwd.max_m))
    step = jax.jit(jax.value_and_grad(lambda x: jnp.sum(ds.op(x) * ws)))
    t0 = time.perf_counter()
    loss, g = step(bs)
    g.block_until_ready()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        loss, g = step(bs)
        g.block_until_ready()
        times.append(time.perf_counter() - t0)
    c = ds.unshard_c(ds.op(bs))
    err_fwd, tol = _check(a, b, c, dtype)
    grad_ref = a.transpose().spmm_ref(w.astype(np.float64))
    err_grad = float(rel_fro_err(grad_ref, ds.unshard_db(g)))
    loss_ref = float(np.sum(a.spmm_ref(b.astype(np.float64)) * w))
    err_loss = abs(float(loss) - loss_ref) / max(abs(loss_ref), 1e-30)
    err = max(err_fwd, err_grad)
    return _result(f"train_step_p{p}", matrix, a, dtype, ds.fwd.kernel_kind,
                   err, tol, setup_s, first_s, times, rel_err_fwd=err_fwd,
                   rel_err_grad=err_grad, loss_rel_diff=err_loss,
                   bwd_kernel=ds.bwd.kernel_kind)


def one_card_phases(w1_rows: int = W1_ROWS, plaw_rows: int = PLAW_ROWS,
                    n: int = N_COLS, devices=None):
    """(name, thunk) for every one-card phase; sizes are arguments so the
    CPU tests can run the same code at a tiny size."""
    f32, f64 = np.float32, np.float64
    cache = {}

    def mat(kind):
        if kind not in cache:
            cache[kind] = (w1_matrix(w1_rows) if kind == "w1"
                           else plaw_matrix(plaw_rows))
        return cache[kind]

    return [
        ("para2d w1 fp32", lambda: phase_para2d(mat("w1"), "w1", n, f32, devices=devices)),
        ("para2d w1 fp64", lambda: phase_para2d(mat("w1"), "w1", n, f64, devices=devices)),
        ("rowpara w1 fp32", lambda: phase_rowpara(mat("w1"), "w1", n, f32, devices=devices)),
        ("rowpara w1 fp64", lambda: phase_rowpara(mat("w1"), "w1", n, f64, devices=devices)),
        ("para2d plaw fp32", lambda: phase_para2d(mat("plaw"), "plaw", n, f32, devices=devices)),
        ("train step w1 fp32", lambda: phase_train_step(mat("w1"), "w1", n, devices=devices)),
    ]


def four_card_phases(w1_rows: int = W1_ROWS, plaw_rows: int = PLAW_ROWS,
                     n: int = N_COLS, devices=None):
    """(name, thunk) for the four-card paths and nothing else."""
    f32, f64 = np.float32, np.float64
    cache = {}

    def mat(kind):
        if kind not in cache:
            cache[kind] = (w1_matrix(w1_rows) if kind == "w1"
                           else plaw_matrix(plaw_rows))
        return cache[kind]

    kw = dict(devices=devices)
    return [
        ("para2d w1 fp32 p4", lambda: phase_para2d(mat("w1"), "w1", n, f32, 4, **kw)),
        ("para2d w1 fp64 p4", lambda: phase_para2d(mat("w1"), "w1", n, f64, 4, **kw)),
        ("rowpara w1 a2a p4", lambda: phase_rowpara(mat("w1"), "w1", n, f32, 4, rb_p2p=0, **kw)),
        ("rowpara w1 ring p4", lambda: phase_rowpara(mat("w1"), "w1", n, f32, 4, rb_p2p=1, **kw)),
        ("rowpara w1 overlap p4", lambda: phase_rowpara(mat("w1"), "w1", n, f32, 4, overlap=1, **kw)),
        ("crp w1 fp32 p4", lambda: phase_crp(mat("w1"), "w1", n, f32, 4, **kw)),
        ("para2d plaw fp32 p4", lambda: phase_para2d(mat("plaw"), "plaw", n, f32, 4, **kw)),
    ]


def run_phases(phases) -> bool:
    """Run every phase, print one JSON line each; True if all passed."""
    all_ok = True
    for name, thunk in phases:
        try:
            rec = thunk()
        except Exception as e:  # a failed phase fails the run, not the rest
            traceback.print_exc()
            rec = dict(phase=name, ok=False, error=f"{type(e).__name__}: {e}")
        all_ok &= bool(rec.get("ok"))
        print(json.dumps(rec), flush=True)
    return all_ok


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r}); "
              "nothing run", file=sys.stderr)
        return 2
    need = 4 if four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    devices = devices[:need]
    jax.config.update("jax_enable_x64", True)
    from crp_tpu.utils.compile_cache import setup_compile_cache

    print(f"compile cache: {setup_compile_cache()}", flush=True)
    print(f"card: {card_line()}", flush=True)
    phases = (four_card_phases if four else one_card_phases)(devices=devices)
    if not run_phases(phases):
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
