"""kernel="auto" resolution and the backend checks in kernels/dispatch (the
MKL/cuSPARSE seam analog, ``src/rowpara_spmm.c:386-413``)."""

import jax
import numpy as np
import pytest

from crp_tpu.config import SpmmConfig
from crp_tpu.engine.rowpara import RowParaSpmm
from crp_tpu.kernels import dispatch
from crp_tpu.kernels.dispatch import pack_local_kernel, resolve_auto_kernel
from crp_tpu.plan.partition1d import csr_row_partition
from crp_tpu.sparse.synth import banded_random_csr, fill_b
from crp_tpu.utils.norms import rel_fro_err


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_resolver_cpu_backend(dtype, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert resolve_auto_kernel(dtype) == "segsum"


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_resolver_gpu_backend(dtype, monkeypatch):
    """On a GPU, auto runs the per-dtype measured choice — native in
    float64 (never the dd emulation)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    got = resolve_auto_kernel(dtype)
    assert got == dispatch.GPU_AUTO[np.dtype(dtype)]
    assert got in ("segsum", "triton")


def test_resolver_gpu_unlisted_dtype_is_segsum(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert resolve_auto_kernel(np.float16) == "segsum"


def test_resolver_other_backend_is_segsum(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    assert resolve_auto_kernel(np.float32) == "segsum"


def _engine(a, p, kernel, devices8, n=8, **cfg):
    displs = csr_row_partition(a.rowptr, p)
    return RowParaSpmm(
        a, displs, displs, n,
        mesh=jax.sharding.Mesh(np.array(devices8[:p]), ("pm",)),
        config=SpmmConfig(kernel=kernel, **cfg),
    )


def test_engine_records_resolved_kind(devices8):
    """kernel_kind reflects what actually ran: auto -> segsum on the CPU,
    an explicit kind stays itself."""
    a = banded_random_csr(400, nnz_per_row=20, bandwidth=30, seed=60)
    b = np.asarray(fill_b(0, a.ncol, 0, 8))
    for kernel, want in (("auto", "segsum"), ("ell", "ell"), ("dd", "dd")):
        eng = _engine(a, 4, kernel, devices8)
        assert eng.kernel_kind == want
        assert rel_fro_err(a.spmm_ref(b), eng.exec(b)) <= 1e-12


def test_triton_refused_off_gpu(devices8):
    """The GPU kernel never runs the interpreter silently: off a GPU an
    explicit kernel='triton' is refused at pack time."""
    assert jax.default_backend() == "cpu"
    shard = (np.array([0, 1, 2]), np.array([0, 1], np.int32), np.ones(2))
    with pytest.raises(ValueError, match="CUDA GPU"):
        pack_local_kernel([shard], 2, np.float32, "triton")
    a = banded_random_csr(100, nnz_per_row=5, bandwidth=10, seed=61)
    with pytest.raises(ValueError, match="CUDA GPU"):
        _engine(a, 2, "triton", devices8)


def test_unknown_kernel_kind_rejected():
    shard = (np.array([0, 1]), np.array([0], np.int32), np.ones(1))
    with pytest.raises(ValueError, match="unknown local SpMM kernel"):
        pack_local_kernel([shard], 1, np.float32, "pallas")


def test_dispatch_is_the_only_backend_reader():
    """The kernel choice and the interpret decision live in
    kernels/dispatch.py alone: no other module of the package reads the
    JAX backend."""
    import pathlib

    root = pathlib.Path(dispatch.__file__).resolve().parents[1]
    readers = sorted(
        str(p.relative_to(root))
        for p in root.rglob("*.py")
        if "default_backend" in p.read_text()
    )
    assert readers == ["kernels/dispatch.py"], readers
