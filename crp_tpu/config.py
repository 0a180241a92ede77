"""Runtime configuration.

The reference configures its algorithm switches through environment variables
read with ``GET_ENV_INT_VAR`` (reference ``src/utils.h:71-87``), e.g.
``RP_SPMM_P2P`` / ``RP_SPMM_REIDX`` (``src/rowpara_spmm.c:42-43``) and
``A2A_B_FINEGRAIN`` (``deprecated/src/crpspmm.c:294``).  We keep the same
three switches (with the same env names and defaults) plus this library's own
(dtype, kernel, overlap, BC layout), carried in a small dataclass.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import numpy as np

logger = logging.getLogger("crp_tpu")


def get_env_int(
    env_name: str,
    default: int,
    min_val: int,
    max_val: int,
    *,
    var_name: Optional[str] = None,
    log: bool = True,
) -> int:
    """Read an integer env var with default / clamp-to-range semantics.

    Mirrors the behaviour of ``GET_ENV_INT_VAR`` (reference
    ``src/utils.h:71-87``): missing -> default, out-of-range -> default,
    and the override is logged once.
    """
    var_name = var_name or env_name.lower()
    raw = os.environ.get(env_name)
    if raw is None:
        return default
    try:
        val = int(raw)
    except ValueError:
        logger.warning("Ignoring non-integer env %s=%r", env_name, raw)
        return default
    if val < min_val or val > max_val:
        logger.warning(
            "Env %s=%d out of range [%d, %d]; using default %d",
            env_name, val, min_val, max_val, default,
        )
        return default
    if log and val != default:
        logger.info("Overriding parameter %s = %d (default %d)", var_name, val, default)
    return val


@dataclasses.dataclass
class SpmmConfig:
    """Algorithm switches for the SpMM engines.

    Attributes
    ----------
    rb_p2p:
        B-row halo exchange implementation.  The reference chooses between a
        nonblocking p2p ring and ``MPI_Alltoallv`` via ``RP_SPMM_P2P``
        (``src/rowpara_spmm.c:275-309``).  Here: 1 -> a ``ppermute``-based
        ring schedule, 0 -> a single padded ``lax.all_to_all``.
    rb_reidx:
        Compact never-referenced B rows out of the local receive buffer
        (``RP_SPMM_REIDX``, ``src/rowpara_spmm.c:81-86``).  This also
        shrinks the gather index space of the local kernel.
    a2a_b_finegrain:
        v1 engine switch: exchange exactly the referenced B rows instead of
        contiguous [min_col, max_col] panels (``A2A_B_FINEGRAIN``,
        ``deprecated/src/crpspmm.c:294-396``).
    dtype:
        Value dtype for A/B/C when the engine constructor does not receive
        an explicit ``dtype``.  Defaults to fp64 like the reference, which
        runs natively on the CPU and the GPU but needs ``jax_enable_x64``
        (the engines refuse float64 without it, see :func:`engine_dtype`).
    kernel:
        Local SpMM kernel: "auto" (the GPU's measured choice per dtype,
        ``segsum`` elsewhere — ``kernels.dispatch.resolve_auto_kernel``) |
        "segsum" (gather + segment-sum, runs everywhere) | "ell" |
        "triton" (the Pallas CSR kernel, CUDA GPUs only) | "dd"
        (double-float fp64-class from fp32 arithmetic).  Every kind takes
        any CSR, like the reference's MKL/cuSPARSE seam
        (``src/rowpara_spmm.c:398-407``).
    overlap:
        Overlap the B-row exchange with compute (no reference equivalent —
        SURVEY.md section 7 calls this out as new):
        the self part of A (owner == this shard) multiplies the owned B
        block concurrently with the ring transfers, and each shift's
        arriving rows feed a partial SpMM immediately.  Implies the ring
        schedule; ``rb_p2p`` is ignored when set.
    """

    rb_p2p: int = 1
    rb_reidx: int = 1
    a2a_b_finegrain: int = 0
    dtype: str = "float64"
    kernel: str = "auto"
    overlap: int = 0
    # reference BC_layout (rp_spmm_init arg, src/rowpara_spmm.c:225-264,
    # 400-407): 1 = B arrives as (n, k) and C returns as (n, m) — the
    # col-major view.  The conversion is a device-side XLA transpose
    # (XLA owns physical layouts; only the LOGICAL orientation of the user
    # arrays needs a switch).
    bc_layout: int = 0

    @classmethod
    def from_env(cls) -> "SpmmConfig":
        return cls(
            rb_p2p=get_env_int("RP_SPMM_P2P", 1, 0, 1, var_name="rB_p2p"),
            rb_reidx=get_env_int("RP_SPMM_REIDX", 1, 0, 1, var_name="rB_reidx"),
            a2a_b_finegrain=get_env_int(
                "A2A_B_FINEGRAIN", 0, 0, 1, var_name="a2a_B_finegrain"
            ),
            dtype=os.environ.get("CRP_TPU_DTYPE", "float64"),
            kernel=os.environ.get("CRP_TPU_KERNEL", "auto"),
            overlap=get_env_int("CRP_TPU_OVERLAP", 0, 0, 1, var_name="overlap"),
            bc_layout=get_env_int(
                "CRP_TPU_BC_LAYOUT", 0, 0, 1, var_name="BC_layout"
            ),
        )


def engine_dtype(dtype, config: SpmmConfig) -> np.dtype:
    """The value dtype an engine computes in: ``dtype`` if given, else
    ``config.dtype``.  float64 needs ``jax_enable_x64``: without it JAX
    would silently compute in float32, so the engines refuse instead."""
    dt = np.dtype(dtype if dtype is not None else config.dtype)
    if dt == np.float64:
        import jax

        if not jax.config.jax_enable_x64:
            raise ValueError(
                "float64 needs jax_enable_x64, which is off: call "
                "jax.config.update('jax_enable_x64', True) (or set "
                "JAX_ENABLE_X64=1) before building the engine, or pass "
                "dtype=float32"
            )
    return dt
