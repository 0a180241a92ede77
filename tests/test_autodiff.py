"""Differentiable SpMM (engine/autodiff.py): value + gradient checks.

The VJP contract: for loss L = sum(W * (A @ B)), dL/dB = A^T @ W — checked
against the dense fp64 reference on the CPU mesh, through the segsum and
the Pallas CSR (interpret-mode) kernel paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from crp_tpu.config import SpmmConfig
from crp_tpu.engine.autodiff import DifferentiableSpmm
from crp_tpu.plan.partition1d import csr_row_partition
from crp_tpu.shard.layout import shard_dense_rows, make_mesh_1d
from crp_tpu.sparse.synth import banded_random_csr, powerlaw_random_csr, fill_b
from crp_tpu.utils.blocks import uniform_displs
from crp_tpu.utils.norms import rel_fro_err


def _mk(a, p, kernel, devices8, n=8):
    displs = csr_row_partition(a.rowptr, p)
    b_displs = displs if a.nrow == a.ncol else uniform_displs(a.ncol, p)
    return DifferentiableSpmm(
        a, displs, b_displs, n,
        mesh=make_mesh_1d(p, devices=devices8),
        config=SpmmConfig(kernel=kernel), dtype=np.float32,
    )


@pytest.mark.parametrize("kernel", ["segsum", "triton"])
@pytest.mark.parametrize("mk", ["banded", "plaw"])
def test_value_and_grad_match_dense(kernel, mk, devices8, triton_interpret):
    if mk == "banded":
        a = banded_random_csr(500, nnz_per_row=9, bandwidth=40, seed=20)
    else:
        a = powerlaw_random_csr(500, avg_degree=8, seed=21)
    n, p = 8, 4
    ds = _mk(a, p, kernel, devices8, n=n)
    b = np.asarray(fill_b(0, a.ncol, 0, n, dtype=np.float32))
    bs = ds.shard_b(b)

    # forward value through the op
    cs = ds.op(bs)
    c = ds.unshard_c(cs)
    assert rel_fro_err(a.spmm_ref(b), c) <= 1e-5

    # gradient: L = sum(W * C) -> dB = A^T @ W.  W is sharded to the op's
    # actual output shape.
    rng = np.random.default_rng(22)
    w = rng.standard_normal((a.nrow, n)).astype(np.float32)
    ws = jnp.asarray(shard_dense_rows(
        w, ds.fwd.A_row_displs, pad_rows=int(cs.shape[1])
    ))

    def loss(x):
        return jnp.sum(ds.op(x) * ws)

    g = jax.grad(loss)(bs)
    db = ds.unshard_db(g)
    ref = a.to_dense().T.astype(np.float64) @ w.astype(np.float64)
    assert rel_fro_err(ref[: db.shape[0]], db) <= 1e-4


def test_grad_under_jit_and_value_linearity(devices8):
    a = banded_random_csr(300, nnz_per_row=7, bandwidth=30, seed=23)
    n, p = 8, 2
    ds = _mk(a, p, "segsum", devices8, n=n)
    b = np.asarray(fill_b(0, a.ncol, 0, n, dtype=np.float32))
    bs = ds.shard_b(b)

    # jit(grad(...)): the op must compose with the standard transforms
    gfn = jax.jit(jax.grad(lambda x: jnp.sum(ds.op(x))))
    db = ds.unshard_db(gfn(bs))
    ref = a.to_dense().T.astype(np.float64) @ np.ones((a.nrow, n))
    assert rel_fro_err(ref[: db.shape[0]], db) <= 1e-4

    # jvp-free sanity: linearity  op(2B) = 2 op(B)
    c1 = np.asarray(ds.op(bs))
    c2 = np.asarray(ds.op(jnp.asarray(bs) * 2.0))
    assert np.allclose(c2, 2.0 * c1, rtol=1e-5, atol=1e-5)


def test_rejects_stateful_kernels(devices8):
    a = banded_random_csr(200, nnz_per_row=5, bandwidth=20, seed=24)
    displs = csr_row_partition(a.rowptr, 2)
    for k in ("dd", "no_such_kernel"):
        with pytest.raises(ValueError):
            DifferentiableSpmm(
                a, displs, displs, 8,
                mesh=make_mesh_1d(2, devices=devices8),
                config=SpmmConfig(kernel=k),
            )


def test_transpose_roundtrip():
    a = powerlaw_random_csr(300, avg_degree=8, seed=25)
    at = a.transpose()
    assert at.nrow == a.ncol and at.ncol == a.nrow
    # sortedness invariant within each transposed row
    for i in range(at.nrow):
        s, e = int(at.rowptr[i]), int(at.rowptr[i + 1])
        assert np.all(np.diff(at.colidx[s:e]) > 0) or e - s <= 1
    assert np.allclose(at.to_dense(), a.to_dense().T)
    assert np.allclose(at.transpose().to_dense(), a.to_dense())


def test_gcn_example_trains(devices8):
    """The end-to-end training example (examples/gcn_train.py) learns the
    community structure through the planned engines: accuracy > 0.7 on the
    synthetic task (rc 0), under jit + grad + optax."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, os.path.join(repo, "examples", "gcn_train.py"),
         "--nodes=600", "--steps=25", "--p=2"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ),  # inherits the conftest CPU-mesh env
    )
    assert res.returncode == 0, res.stdout[-1500:] + res.stderr[-1500:]
    assert "final accuracy" in res.stdout


def test_auto_kernel_resolves_plain_b(devices8):
    """kernel="auto" lands the differentiable op on a plain-B kernel in
    both directions (never dd, whose B is packed as hi/lo halves)."""
    a = banded_random_csr(200, nnz_per_row=5, bandwidth=20, seed=26)
    ds = _mk(a, 4, "auto", devices8)
    assert ds.fwd.kernel_kind == "segsum"  # CPU backend
    assert ds.bwd.kernel_kind == "segsum"
