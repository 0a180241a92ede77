"""crp_tpu — communication-reduced distributed SpMM in JAX.

A JAX/XLA/Pallas re-design of the capabilities of
scalable-matrix/CRP-SpMM (see /root/reference, SURVEY.md): distributed
``C := A @ B`` with sparse CSR ``A`` and dense ``B``/``C``, built around

  * a sparsity-aware partition planner choosing a ``pm x pn`` device grid and
    nnz-balanced row blocks to minimize communicated matrix elements
    (reference: ``src/spmat_part.c``),
  * an A-replication path along grid rows and a plan-driven, sparsity-aware
    B-row halo exchange along grid columns (reference: ``src/para2d_spmm.c``,
    ``src/rowpara_spmm.c``),
  * any-layout <-> internal-layout resharding of A/B/C (reference:
    ``src/mat_redist.c``, ``deprecated/src/crpspmm.c``),
  * local SpMM kernels in plain XLA and a Pallas kernel for NVIDIA GPUs
    (replacing MKL / cuSPARSE),
  * phase-timing statistics and a communicated-element audit
    (planned vs actual vs minimal).
"""

__version__ = "0.1.0"

from .sparse.csr import CSRMatrix
from .sparse.mmio import read_mtx_csr
from .plan.partition1d import csr_row_partition, csr_row_part_comm_size
from .plan.planner2d import calc_spmm_part2d_from_1d, plan_from_csr, Plan2D
from .plan.bandwidth import calc_bandwidth_part2d
from .config import SpmmConfig, get_env_int


def __getattr__(name):
    # engines/redist import jax; keep top-level import light for host-only use
    if name in ("RowParaSpmm", "Para2dSpmm", "CrpSpmm", "RedistEngine",
                "BlockDist", "DifferentiableSpmm", "ValueParameterizedSpmm"):
        from .engine.rowpara import RowParaSpmm
        from .engine.para2d import Para2dSpmm
        from .engine.crp import CrpSpmm
        from .engine.autodiff import DifferentiableSpmm
        from .engine.trainable import ValueParameterizedSpmm
        from .shard.redist import RedistEngine, BlockDist

        return {
            "RowParaSpmm": RowParaSpmm,
            "Para2dSpmm": Para2dSpmm,
            "CrpSpmm": CrpSpmm,
            "RedistEngine": RedistEngine,
            "BlockDist": BlockDist,
            "DifferentiableSpmm": DifferentiableSpmm,
            "ValueParameterizedSpmm": ValueParameterizedSpmm,
        }[name]
    raise AttributeError(f"module 'crp_tpu' has no attribute {name!r}")


__all__ = [
    "CSRMatrix",
    "read_mtx_csr",
    "csr_row_partition",
    "csr_row_part_comm_size",
    "calc_spmm_part2d_from_1d",
    "plan_from_csr",
    "calc_bandwidth_part2d",
    "Plan2D",
    "SpmmConfig",
    "get_env_int",
    "RowParaSpmm",
    "Para2dSpmm",
    "CrpSpmm",
    "RedistEngine",
    "BlockDist",
    "DifferentiableSpmm",
    "ValueParameterizedSpmm",
]
