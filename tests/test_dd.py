"""dd (double-float) kernel dispatch guards."""

def test_dd_segsum_nnz_cap(monkeypatch):
    """Shards past the segmented-scan compile budget refuse cleanly
    (UnsupportedSparsity naming the cap) instead of OOMing the compiler —
    a 10.8M-nnz power-law shard is past it."""
    import numpy as np
    import pytest
    from crp_tpu.kernels.dispatch import pack_local_kernel
    from crp_tpu.kernels.dispatch import UnsupportedSparsity

    monkeypatch.setenv("CRP_TPU_DD_SEGSUM_MAX_NNZ", "64")
    # degree > 128 forces the segsum path (not ELL)
    nrow, deg = 4, 140
    rowptr = np.arange(nrow + 1, dtype=np.int64) * deg
    colidx = np.tile(np.arange(deg, dtype=np.int32), nrow)
    val = np.ones(nrow * deg)
    with pytest.raises(UnsupportedSparsity, match="SEGSUM_MAX_NNZ"):
        pack_local_kernel(
            [(rowptr, colidx, val)], nrow, np.float64, kind="dd",
        )
