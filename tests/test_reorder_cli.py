"""Reordering (sparse/reorder.py) and CLI driver tests."""

import numpy as np
import pytest

from crp_tpu.sparse.reorder import rcm_reorder, permute_symmetric
from crp_tpu.sparse.synth import banded_random_csr, powerlaw_random_csr, fill_b
from crp_tpu.utils.norms import rel_fro_err


def symmetrize(a):
    from crp_tpu.sparse.csr import CSRMatrix

    s = (a.to_scipy() + a.to_scipy().T).tocsr()
    return CSRMatrix.from_scipy(s)


def test_permute_symmetric_preserves_spmm():
    a = symmetrize(powerlaw_random_csr(200, avg_degree=6, seed=50))
    perm = np.random.default_rng(0).permutation(200)
    ap = permute_symmetric(a, perm)
    b = np.asarray(fill_b(0, 200, 0, 8))
    # A'[new] rows correspond to old rows perm[new]; B permuted likewise
    c_perm = ap.spmm_ref(b[perm])
    c_ref = a.spmm_ref(b)[perm]
    np.testing.assert_allclose(c_perm, c_ref, rtol=1e-12)


def test_rcm_reduces_bandwidth():
    a = symmetrize(powerlaw_random_csr(400, avg_degree=3, seed=51))
    ar, perm = rcm_reorder(a)
    assert ar.bandwidth() <= a.bandwidth()
    assert sorted(perm.tolist()) == list(range(400))


def test_rcm_shrinks_planner_windows():
    """The SC23 Fig. 7 effect: reordering shrinks planner comm cost on a
    scrambled banded matrix."""
    from crp_tpu.plan.planner2d import plan_from_csr

    base = symmetrize(banded_random_csr(600, nnz_per_row=5, bandwidth=8, seed=52))
    scramble = np.random.default_rng(1).permutation(600)
    scrambled = permute_symmetric(base, scramble)
    restored, _ = rcm_reorder(scrambled)
    p_bad = plan_from_csr(scrambled, 64, 8)
    p_good = plan_from_csr(restored, 64, 8)
    assert p_good.comm_cost < p_bad.comm_cost


def test_plan_cli(capsys):
    from crp_tpu.cli.plan_cli import main

    rc = main(["synth:banded:500:6:30", "64", "8", "0"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Calculated 2D grid" in out
    assert "1D row partitioning of A" in out


def test_plan_cli_usage(capsys):
    from crp_tpu.cli.plan_cli import main

    assert main([]) == 255


def test_bench_cli_rowpara(devices8, capsys):
    from crp_tpu.cli.bench_cli import main

    rc = main(["synth:banded:400:5:20", "8", "2", "0", "1",
               "--engine=rowpara", "--dtype=float64", "--devices=4"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "||C_ref - C||_f" in out
    err = float(out.strip().splitlines()[-1].split("=")[-1])
    assert err <= 1e-12


def test_bench_cli_para2d(devices8, capsys):
    from crp_tpu.cli.bench_cli import main

    rc = main(["synth:banded:400:5:20", "8", "1", "0", "1",
               "--engine=para2d", "--dtype=float64", "--devices=8"])
    out = capsys.readouterr().out
    assert rc == 0 and "||C_ref - C||_f" in out


def test_bench_cli_crp(devices8, capsys):
    from crp_tpu.cli.bench_cli import main

    rc = main(["synth:banded:400:25:20", "8", "1", "0", "1",
               "--engine=crp", "--dtype=float64", "--devices=8"])
    out = capsys.readouterr().out
    assert rc == 0 and "Alltoallv B necessary" in out


def test_suite_cli_modes(capsys):
    """crp-suite modes sweep: one JSON record per schedule, with comm audit."""
    import json

    from crp_tpu.cli.suite_cli import main as suite_main

    rc = suite_main([
        "modes", "synth:banded:600:5:25", "8", "4", "--ntest=1",
    ])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    recs = [json.loads(l) for l in lines]
    assert [r["mode"] for r in recs] == ["a2a", "ring", "overlap"]
    for r in recs:
        assert r["rel_fro_err"] <= 1e-5
        assert r["comm"]["exchange_B"] == recs[0]["comm"]["exchange_B"]
    # the ring moves less padded physical volume than the all_to_all
    assert recs[1]["comm"]["physical_B_rows"] < recs[0]["comm"]["physical_B_rows"]


def test_suite_cli_vary_n(capsys):
    import json

    from crp_tpu.cli.suite_cli import main as suite_main

    rc = suite_main([
        "vary_n", "synth:banded:400:5:20", "4", "--ns=4,8", "--ntest=1",
        "--engine=rowpara",
    ])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    recs = [json.loads(l) for l in lines]
    assert [r["n"] for r in recs] == [4, 8]
    assert all(r["rel_fro_err"] <= 1e-5 for r in recs)


def test_suite_cli_crp_engine(capsys):
    """crp-suite with the any-layout v1 engine: full v1-style comm audit."""
    import json

    from crp_tpu.cli.suite_cli import main as suite_main

    rc = suite_main([
        "scaling", "synth:banded:500:5:25", "8", "--procs=4", "--engine=crp",
        "--ntest=1",
    ])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    (rec,) = [json.loads(l) for l in lines]
    assert rec["rel_fro_err"] <= 1e-5
    assert rec["comm"]["a2av_B_necessary"] <= rec["comm"]["a2av_B"]


def _cut_edges(a, part):
    rows = np.repeat(np.arange(a.nrow), np.diff(a.rowptr))
    return int((part[rows] != part[a.colidx]).sum())


def test_ggp_partition_native_and_python_quality():
    """The greedy graph-growing fallback behind the METIS seam: valid,
    balanced within the 5% ubvec analog, and far below a random partition's
    cut on a banded graph (native C++ and the numpy twin)."""
    from crp_tpu import native
    from crp_tpu.sparse.reorder import _ggp_partition_py

    a = symmetrize(banded_random_csr(800, nnz_per_row=6, bandwidth=12, seed=60))
    nparts = 8
    cap = int(1.05 * a.nrow / nparts) + 1
    rng = np.random.default_rng(2)
    rand_cut = _cut_edges(a, rng.integers(0, nparts, a.nrow))
    parts = [_ggp_partition_py(a.rowptr, a.colidx, nparts, 1.05)]
    native_part = native.ggp_partition(a.rowptr, a.colidx, nparts, 1.05)
    if native_part is not None:
        parts.append(native_part.astype(np.int64))
    assert native.AVAILABLE  # this environment has g++
    for part in parts:
        assert part.shape == (a.nrow,)
        counts = np.bincount(part, minlength=nparts)
        assert counts.min() > 0 and counts.max() <= cap
        assert _cut_edges(a, part) < rand_cut / 4


def test_metis_row_partition_chain():
    """metis_row_partition end-to-end on the best available backend (native
    greedy growing here): contiguous displs, a valid symmetric permutation,
    and SpMM equivalence through the permutation."""
    from crp_tpu.sparse.reorder import metis_row_partition

    a = symmetrize(powerlaw_random_csr(300, avg_degree=5, seed=61))
    ap, perm, displs = metis_row_partition(a, 4)
    assert displs[0] == 0 and displs[-1] == a.nrow
    assert np.all(np.diff(displs) >= 0)
    assert sorted(perm.tolist()) == list(range(a.nrow))
    b = np.asarray(fill_b(0, a.ncol, 0, 8))
    np.testing.assert_allclose(
        ap.spmm_ref(b[perm]), a.spmm_ref(b)[perm], rtol=1e-12
    )


def test_plan_from_csr_metis(devices8):
    """plan_from_csr(method='metis') no longer raises: it permutes the
    matrix in place (reference driver flow, test_spmm_2dpg.c:30-37) and the
    plan drives an engine to a correct result on the permuted matrix."""
    from crp_tpu.engine.para2d import Para2dSpmm
    from crp_tpu.plan.planner2d import plan_from_csr
    from crp_tpu.shard.layout import make_mesh_2d

    a = symmetrize(banded_random_csr(400, nnz_per_row=5, bandwidth=30, seed=62))
    plan = plan_from_csr(a, 8, 8, method="metis")
    assert plan.A0_rowptr[-1] == a.nrow
    mesh = make_mesh_2d(plan.pm, plan.pn, devices=devices8)
    eng = Para2dSpmm(a, plan, mesh=mesh)
    b = np.asarray(fill_b(0, a.ncol, 0, 8))
    assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12


def test_plan_cli_metis(capsys):
    from crp_tpu.cli.plan_cli import main

    rc = main(["synth:banded:500:6:30", "64", "8", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and "Calculated 2D grid" in out


def test_bench_cli_metis_method(devices8, capsys):
    from crp_tpu.cli.bench_cli import main

    rc = main(["synth:banded:400:5:20", "8", "1", "1", "1",
               "--engine=para2d", "--dtype=float64", "--devices=8"])
    out = capsys.readouterr().out
    assert rc == 0
    err = float(out.strip().splitlines()[-1].split("=")[-1])
    assert err <= 1e-12


def test_suite_cli_crp_dd_correct(devices8, capsys):
    """Review r2: the crp-engine suite path fed plain fp32 shards to
    exec_device under kernel='dd' (silently wrong results, bogus
    timings); dd now times exec() with proper hi/lo packing."""
    import json

    from crp_tpu.cli.suite_cli import main as suite_main

    rc = suite_main([
        "kernels", "synth:banded:500:5:25", "8", "4", "--engine=crp",
        "--list=dd", "--ntest=1",
    ])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    (rec,) = [json.loads(l) for l in lines]
    assert "error" not in rec, rec
    assert rec["rel_fro_err"] <= 1e-12


def test_calc_partition_cli(capsys):
    """The standalone v1 planner driver prints the reference's per-factor
    trace (crpspmm_calc_partition.c:60-116) and the final grid."""
    from crp_tpu.cli.calc_partition_cli import main

    rc = main(["synth:banded:2000:8:40", "64", "6"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "bandwidth = 40" in out
    assert "split-N cost" in out and "split-M cost" in out
    assert "B rows to copy" in out
    assert "Final grid: 6 row panels x 1" in out


def test_calc_partition_cli_usage(capsys):
    from crp_tpu.cli.calc_partition_cli import main

    assert main([]) == 255


def test_suite_cli_reorder_flag(capsys):
    """--reorder=metis: scrambled-id community graph is reordered before
    packing, recorded with before/after bandwidth, and the result stays
    exact."""
    import json

    from crp_tpu.cli.suite_cli import main as suite_main

    rc = suite_main([
        "kernels", "synth:cplaw:8192:12:512:85:perm", "16", "2",
        "--engine=rowpara", "--list=segsum", "--ntest=1", "--inner=2",
        "--reorder=metis",
    ])
    assert rc == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    (rec,) = [json.loads(l) for l in lines]
    assert rec["rel_fro_err"] <= 1e-5
    assert rec["reorder"]["method"] == "metis"
    assert rec["reorder"]["bandwidth_before"] > 0
    assert rec["kernel_resolved"] == "segsum"


def _near_diagonal(m, width):
    """Share of nonzeros within ``width`` of the diagonal: how much of a
    row's B traffic stays in a window of nearby rows."""
    rows = np.repeat(np.arange(m.nrow), np.diff(m.rowptr))
    return float(np.mean(np.abs(m.colidx - rows) < width))


def test_cluster_reorder_recovers_scrambled_communities():
    """Recursive-bisection ordering brings a label-permuted community
    graph's nonzeros back near the diagonal, where a flat k-way reorder
    cannot (within-part order stays scrambled)."""
    from crp_tpu.sparse.reorder import cluster_reorder
    from crp_tpu.sparse.synth import powerlaw_community_csr

    a = powerlaw_community_csr(
        32768, avg_degree=10, comm_size=1024, p_local=0.85,
        permute=True, seed=7,
    )
    near0 = _near_diagonal(a, 1024)
    out, perm = cluster_reorder(a, leaf_size=256)
    near1 = _near_diagonal(out, 1024)
    # scrambled: ~6% of nnz within 1024 of the diagonal; reordered: ~56%
    assert near0 < 0.15, near0
    assert near1 > 0.4, near1

    # the permutation is a bijection and preserves the computation
    assert np.array_equal(np.sort(perm), np.arange(a.nrow))
    b = fill_b(0, a.ncol, 0, 8, dtype=np.float64)
    c_ref = np.asarray(a.spmm_ref(np.asarray(b)))
    c_out = np.asarray(out.spmm_ref(np.asarray(b)[perm]))
    assert rel_fro_err(c_ref[perm], c_out) <= 1e-13
