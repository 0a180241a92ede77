"""Local SpMM in double-float ("double-double" fp32) precision.

For hardware without fp64 units (SURVEY.md section 7 "hard parts: fp64
parity"; the GPU computes fp64 natively and never needs this kernel): the
reference computes in fp64 (``mkl_sparse_d_mm``, ``src/rowpara_spmm.c:
398-407``) and its acceptance check is ``<= 1e-12`` Frobenius.  This kernel
reaches fp64-class accuracy on fp32 hardware by representing every value as
an unevaluated pair ``hi + lo`` of fp32 (~2^-48 unit roundoff) and using
error-free transformations:

  * ``two_sum``  (Knuth): exact error of an fp32 add;
  * ``two_prod`` (Dekker split, factor 2^12+1): exact error of an fp32
    multiply without FMA;
  * products and accumulations composed as double-float ops; per-row
    accumulation is a pairwise tree over the ELL slots (log2(L) unrolled
    vectorized VPU levels), so the error stays O(log L * 2^-48) — and the
    unrolled dependency chain stays shallow: XLA's CPU backend exhibits
    super-linear compile time in the *depth* of an unrolled EFT chain
    (measured: 3 s at depth 10, 24 s at depth 13, unbounded at 20), while
    a depth-5 tree over 20 slots compiles instantly.

All arithmetic must round to fp32 exactly as written: XLA preserves IEEE
semantics for these ops (no fast-math reassociation), which the EFT
identities rely on.

Layout: ELL (row-padded) — per-row sequential accumulation needs equal slot
counts; B travels as a packed (k, 2n) fp32 array ([:, :n] = hi, [:, n:] =
lo) so the exchange layer moves it row-wise unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_SPLIT = np.float32(4097.0)  # 2^12 + 1: Dekker split factor for fp32


def split_f64(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side fp64 -> (hi, lo) fp32 pair with hi + lo == fp64(x) closely."""
    hi = np.asarray(x, dtype=np.float32)
    lo = np.asarray(np.asarray(x, dtype=np.float64) - hi.astype(np.float64),
                    dtype=np.float32)
    return hi, lo


def pack_b_dd(b: np.ndarray) -> np.ndarray:
    """fp64 (k, n) -> packed fp32 (k, 2n): columns [hi | lo]."""
    hi, lo = split_f64(b)
    return np.concatenate([hi, lo], axis=1)


def unpack_c_dd(c: np.ndarray) -> np.ndarray:
    """Packed fp32 (m, 2n) -> fp64 (m, n)."""
    n = c.shape[-1] // 2
    return c[..., :n].astype(np.float64) + c[..., n:].astype(np.float64)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _fast_two_sum(a, b):
    # requires |a| >= |b| (holds after a two_sum/two_prod renormalize)
    s = a + b
    return s, b - (s - a)


def _two_prod(a, b):
    p = a * b
    ah = _SPLIT * a
    ah = ah - (ah - a)
    al = a - ah
    bh = _SPLIT * b
    bh = bh - (bh - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _dd_add(ah, al, bh, bl):
    s, e = _two_sum(ah, bh)
    e = e + (al + bl)
    return _fast_two_sum(s, e)


def _dd_mul(ah, al, bh, bl):
    p, e = _two_prod(ah, bh)
    e = e + (ah * bl + al * bh)
    return _fast_two_sum(p, e)


def pack_ell_dd(
    rowptr: np.ndarray,
    colidx: np.ndarray,
    val: np.ndarray,          # fp64 values
    nrow_pad: int,
    L: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR (fp64 values) -> ELL (cols, val_hi, val_lo), rows padded to L slots.

    Padded slots carry col = 0, val = 0 (contribute exactly zero).
    """
    nrow = len(rowptr) - 1
    counts = np.diff(rowptr)
    L = L if L is not None else max(int(counts.max()) if nrow else 0, 1)
    cols = np.zeros((nrow_pad, L), dtype=np.int32)
    vals = np.zeros((nrow_pad, L), dtype=np.float64)
    rows = np.repeat(np.arange(nrow), counts)
    slot = np.arange(len(colidx)) - np.repeat(rowptr[:-1], counts)
    cols[rows, slot] = colidx
    vals[rows, slot] = val
    vh, vl = split_f64(vals)
    return cols, vh, vl


def spmm_ell_dd(
    cols: jax.Array,          # (m, L) int32
    val_hi: jax.Array,        # (m, L) fp32
    val_lo: jax.Array,        # (m, L) fp32
    b_packed: jax.Array,      # (k, 2n) fp32: [hi | lo]
) -> jax.Array:
    """C = A @ B in double-float; returns packed fp32 (m, 2n).

    Per-row accumulation is a fully unrolled pairwise tree over the L ELL
    slots.  Unrolled (not ``fori_loop``/``scan``) is REQUIRED for
    correctness: XLA's while-loop compilation reassociates the EFT
    identities through the loop carry (measured: 2e-8 error looped vs
    2e-15 unrolled).  Tree (not sequential) keeps the unrolled dependency
    chain at log2(L) depth, which both tightens the error bound and avoids
    the XLA:CPU super-linear compile blowup on deep EFT chains (see module
    docstring).  Pad slots carry col = 0, val = 0, whose dd product and
    adds are exactly zero, so padding L to a power of two is error-free.
    Peak intermediate is (m, L, n) fp32 x2 — fine for the fp64-parity
    path this kernel serves.
    """
    n = b_packed.shape[1] // 2
    m, L = cols.shape
    brow = jnp.take(b_packed, cols, axis=0, fill_value=0)   # (m, L, 2n)
    ph, pl = _dd_mul(
        val_hi[:, :, None], val_lo[:, :, None], brow[..., :n], brow[..., n:]
    )
    pad = (1 << max(L - 1, 0).bit_length()) - L
    if pad:
        ph = jnp.pad(ph, ((0, 0), (0, pad), (0, 0)))
        pl = jnp.pad(pl, ((0, 0), (0, pad), (0, 0)))
    while ph.shape[1] > 1:
        h = ph.shape[1] // 2
        ph, pl = _dd_add(ph[:, :h], pl[:, :h], ph[:, h:], pl[:, h:])
    return jnp.concatenate([ph[:, 0], pl[:, 0]], axis=1)


def pack_coo_dd(
    rowptr: np.ndarray,
    colidx: np.ndarray,
    val: np.ndarray,          # fp64 values
    nnz_pad: int,
    nrow_pad: int,
) -> tuple[np.ndarray, ...]:
    """CSR (fp64 values) -> padded sorted COO for the segmented-scan kernel.

    Returns (row_ids, cols, val_hi, val_lo, row_last): pad entries carry
    val = 0 and belong to the trailing pad segment; ``row_last[i]`` is the
    flat position of row i's last nonzero (pad position for empty rows, so
    the gathered per-row sum is exactly 0).
    """
    nrow = len(rowptr) - 1
    counts = np.diff(rowptr)
    nnz = int(rowptr[-1]) - int(rowptr[0])
    # >= 1 pad slot so empty rows can gather an exact zero from the pad
    # segment via row_last
    assert nnz_pad > nnz, (nnz_pad, nnz)
    row_ids = np.full(nnz_pad, nrow_pad, dtype=np.int32)
    cols = np.zeros(nnz_pad, dtype=np.int32)
    vals = np.zeros(nnz_pad, dtype=np.float64)
    row_ids[:nnz] = np.repeat(np.arange(nrow, dtype=np.int32), counts)
    cols[:nnz] = colidx
    vals[:nnz] = val
    vh, vl = split_f64(vals)
    row_last = np.full(nrow_pad, nnz_pad - 1, dtype=np.int32)
    nonempty = counts > 0
    row_last[:nrow][nonempty] = (rowptr[1:][nonempty] - 1 - int(rowptr[0]))
    return row_ids, cols, vh, vl, row_last


def spmm_segsum_dd(
    row_ids: jax.Array,       # (nnz_pad,) int32 sorted; pad = nrow_pad
    cols: jax.Array,          # (nnz_pad,) int32
    val_hi: jax.Array,        # (nnz_pad,) fp32
    val_lo: jax.Array,        # (nnz_pad,) fp32
    row_last: jax.Array,      # (m,) int32 position of each row's last nnz
    b_packed: jax.Array,      # (k, 2n) fp32: [hi | lo]
) -> jax.Array:
    """C = A @ B in double-float via a segmented tree reduction.

    A head-flag segmented ``associative_scan`` with the double-float add as
    combiner: log2(nnz) unrolled levels (no while loop — XLA's loop pass
    would reassociate the EFTs, see ``spmm_ell_dd``), each a vectorized VPU
    pass, independent of the max row degree.  Per-row sums come out at each
    segment's last position.  Returns packed fp32 (m, 2n).
    """
    n = b_packed.shape[1] // 2
    brow = jnp.take(b_packed, cols, axis=0, fill_value=0)
    ph, pl = _dd_mul(val_hi[:, None], val_lo[:, None], brow[:, :n], brow[:, n:])
    heads = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), row_ids[1:] != row_ids[:-1]]
    )

    def comb(a, b):
        fa, ah, al = a
        fb, bh, bl = b
        sh, sl = _dd_add(ah, al, bh, bl)
        keep = fb[:, None]
        return (fa | fb, jnp.where(keep, bh, sh), jnp.where(keep, bl, sl))

    _, sh, sl = jax.lax.associative_scan(comb, (heads, ph, pl))
    ch = jnp.take(sh, row_last, axis=0, fill_value=0)
    cl = jnp.take(sl, row_last, axis=0, fill_value=0)
    return jnp.concatenate([ch, cl], axis=1)
