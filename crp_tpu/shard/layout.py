"""Plan -> device layout: padded stacking and mesh construction.

XLA shards must be identically shaped, but the planner's row blocks are
nnz-balanced and irregular (SURVEY.md section 2 #5).  The internal layout
therefore stacks per-shard blocks padded to the max block size along a
leading device axis; helpers here move between the user's global row-major
matrices and that stacked-padded internal layout (the moral equivalent of
the reference's pack/unpack phases, ``src/rowpara_spmm.c:225-264,312-346``).
"""

from __future__ import annotations

import jax
import numpy as np


def stack_padded(arrays: list[np.ndarray], pad_value=0, dtype=None) -> np.ndarray:
    """Stack 1D/2D arrays along a new leading axis, padding dim 0 to the max."""
    n = max((a.shape[0] for a in arrays), default=0)
    n = max(n, 1)
    rest = arrays[0].shape[1:] if arrays else ()
    dtype = dtype or arrays[0].dtype
    out = np.full((len(arrays), n) + rest, pad_value, dtype=dtype)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
    return out


def shard_dense_rows(
    b: np.ndarray, displs: np.ndarray, pad_rows: int | None = None
) -> np.ndarray:
    """Global (k, n) -> stacked padded shards (p, max_rows, n) by row blocks."""
    displs = np.asarray(displs)
    blocks = [b[displs[i] : displs[i + 1]] for i in range(len(displs) - 1)]
    out = stack_padded(blocks, pad_value=0, dtype=b.dtype)
    if pad_rows is not None and out.shape[1] < pad_rows:
        pad = np.zeros((out.shape[0], pad_rows - out.shape[1], out.shape[2]), out.dtype)
        out = np.concatenate([out, pad], axis=1)
    return out


def unshard_dense_rows(c_shards: np.ndarray, displs: np.ndarray) -> np.ndarray:
    """Stacked padded shards (p, max_rows, n) -> global (m, n)."""
    displs = np.asarray(displs)
    c_shards = np.asarray(c_shards)
    return np.concatenate(
        [c_shards[i, : displs[i + 1] - displs[i]] for i in range(len(displs) - 1)],
        axis=0,
    )


def make_mesh_1d(p: int, axis: str = "pm", devices=None) -> jax.sharding.Mesh:
    devices = devices if devices is not None else jax.devices()
    if len(devices) < p:
        raise ValueError(f"need {p} devices, have {len(devices)}")
    return jax.sharding.Mesh(np.array(devices[:p]), (axis,))


def make_mesh_2d(
    pm: int, pn: int, axes=("pm", "pn"), devices=None
) -> jax.sharding.Mesh:
    """Row-major pm x pn grid: device (i, j) = devices[i*pn + j], matching
    the reference's rank -> (pi, pj) map (``src/para2d_spmm.c:38-40``)."""
    devices = devices if devices is not None else jax.devices()
    if len(devices) < pm * pn:
        raise ValueError(f"need {pm * pn} devices, have {len(devices)}")
    grid = np.array(devices[: pm * pn]).reshape(pm, pn)
    return jax.sharding.Mesh(grid, axes)


def init_distributed(**kw) -> None:
    """Multi-process runtime init: one JAX process per host (or per card).

    The reference initializes MPI and derives ranks from SLURM/PBS env vars
    (``deprecated/src/cuda_proxy.cu:11-46``, ``SC23_AD/scripts/*.pbs``);
    here ``jax.distributed.initialize`` takes ``coordinator_address``,
    ``num_processes`` and ``process_id`` (or reads them from a launcher it
    recognizes), after which ``jax.devices()`` spans every process and the
    same engines run unchanged.  Call once per process before building
    meshes.  One process driving all the cards of a host needs no call.
    """
    import jax

    jax.distributed.initialize(**kw)
