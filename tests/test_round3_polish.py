"""Pack-cache regressions: the engine's memoized pack is reused on the same
matrix, invalidated by any content edit, and kept to a single slot."""

import numpy as np

from crp_tpu.config import SpmmConfig
from crp_tpu.engine.rowpara import RowParaSpmm
from crp_tpu.plan.partition1d import csr_row_partition
from crp_tpu.sparse.synth import banded_random_csr, fill_b
from crp_tpu.shard.layout import make_mesh_1d
from crp_tpu.utils.norms import rel_fro_err


def _build(a, p, n, devices8, **cfg_kw):
    displs = csr_row_partition(a.rowptr, p)
    return RowParaSpmm(
        a, displs, displs, n, mesh=make_mesh_1d(p, devices=devices8),
        config=SpmmConfig(**cfg_kw),
    )


def test_pack_cache_reused_and_invalidated(devices8):
    """Rebuilding the engine on the same matrix reuses the pack; an
    in-place value edit (the metis driver permutes in place) invalidates
    it and the rebuilt engine computes the NEW matrix's product."""
    a = banded_random_csr(400, nnz_per_row=7, bandwidth=40, seed=77)
    n = 8
    b = np.asarray(fill_b(0, a.ncol, 0, n))

    eng1 = _build(a, 4, n, devices8, kernel="segsum")
    assert rel_fro_err(a.spmm_ref(b), eng1.exec(b)) <= 1e-12
    eng2 = _build(a, 4, n, devices8, kernel="segsum")
    assert eng2._local_fn is eng1._local_fn  # cache hit

    a.val *= 2.0  # in-place content edit — fingerprint must change
    eng3 = _build(a, 4, n, devices8, kernel="segsum")
    assert eng3._local_fn is not eng1._local_fn  # cache invalidated
    assert rel_fro_err(a.spmm_ref(b), eng3.exec(b)) <= 1e-12


def test_pack_cache_catches_single_element_edit(devices8):
    """Review r3: the sampled fingerprint missed edits off the 1-in-stride
    positions; the full digest must catch ANY single value edit."""
    a = banded_random_csr(3000, nnz_per_row=7, bandwidth=40, seed=5)
    n = 8
    b = np.asarray(fill_b(0, a.ncol, 0, n))
    eng1 = _build(a, 4, n, devices8, kernel="segsum")
    assert rel_fro_err(a.spmm_ref(b), eng1.exec(b)) <= 1e-12
    a.val[1] = a.val[1] + 7.5  # a position a 1024-sample stride skips
    eng2 = _build(a, 4, n, devices8, kernel="segsum")
    assert eng2._local_fn is not eng1._local_fn
    assert rel_fro_err(a.spmm_ref(b), eng2.exec(b)) <= 1e-12


def test_pack_cache_single_slot(devices8):
    """Review r3: the pack cache pins device arrays; sweeping configs in
    one process must not accumulate entries (HBM) — one slot, last wins."""
    a = banded_random_csr(400, nnz_per_row=7, bandwidth=40, seed=9)
    _build(a, 4, 8, devices8, kernel="segsum")
    _build(a, 4, 8, devices8, kernel="ell")
    assert len(a._pack_cache) == 1
