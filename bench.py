"""Time the reference README's run on one GPU and print one JSON line.

    python bench.py [--kernel=auto|segsum|triton] [--dtype=float32|float64]

The run: pwtk-class banded matrix (217,918 rows, ~11.4M nnz,
``banded_random_csr(217918, 53, 2500, seed=1234)``) times a dense B with
n = 256 (``fill_b``), through ``RowParaSpmm`` at p = 1 — the B-row exchange
is the identity there, so an exec is the local kernel on device-resident B.
The reference publishes 1.060 s per exec for this run on a 4-rank Xeon node
(``BASELINE.md``).

Each exec is fenced with ``block_until_ready``; the record carries the
median and the sample count, the engine's set-up seconds, the first exec
(compile included), ``rel_fro_err`` against the fp64 host reference (the
reference's metric), and the device (platform, ``device_kind``, count) with
the card's name and power limit.  Without a GPU it exits non-zero.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opt = dict((a[2:].split("=", 1) + ["1"])[:2]
               for a in argv if a.startswith("--"))
    kernel = opt.get("kernel", "auto")
    dtype = np.dtype(opt.get("dtype", "float32"))
    reps, n = 20, 256

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    from crp_tpu.config import SpmmConfig
    from crp_tpu.engine.rowpara import RowParaSpmm
    from crp_tpu.plan.partition1d import csr_row_partition
    from crp_tpu.shard.layout import make_mesh_1d
    from crp_tpu.sparse.synth import banded_random_csr, fill_b
    from crp_tpu.utils.compile_cache import setup_compile_cache
    from crp_tpu.utils.norms import rel_fro_err

    setup_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()

    a = banded_random_csr(217918, nnz_per_row=53, bandwidth=2500, seed=1234)
    displs = csr_row_partition(a.rowptr, 1)
    t0 = time.perf_counter()
    eng = RowParaSpmm(a, displs, displs, n, mesh=make_mesh_1d(1),
                      config=SpmmConfig(kernel=kernel), dtype=dtype)
    setup_s = time.perf_counter() - t0
    b = np.asarray(fill_b(0, a.ncol, 0, n, dtype=dtype))
    bs = eng.shard_b(b)
    t0 = time.perf_counter()
    c = eng.exec_device(bs)
    c.block_until_ready()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        c = eng.exec_device(bs)
        c.block_until_ready()
        times.append(time.perf_counter() - t0)
    err = float(rel_fro_err(a.spmm_ref(b.astype(np.float64)),
                            np.asarray(eng.unshard_c(c), np.float64)))
    print(json.dumps({
        "metric": "pwtk-class 217918^2 n=256 p=1 SpMM exec",
        "exec_median_s": float(np.median(times)),
        "exec_samples": len(times),
        "setup_s": setup_s,
        "first_exec_s": first_s,
        "init_breakdown": eng.init_breakdown,
        "kernel": eng.kernel_kind,
        "dtype": dtype.name,
        "nnz": int(a.nnz),
        "rel_fro_err": err,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
