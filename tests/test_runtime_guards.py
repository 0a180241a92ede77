"""Guards that keep a run honest about its device and precision: the engines
refuse float64 while ``jax_enable_x64`` is off (JAX would silently compute
in float32), and the compile cache goes where the environment says or to one
fixed directory in the checkout."""

import contextlib
import os

import jax
import numpy as np
import pytest

from crp_tpu.config import SpmmConfig, engine_dtype
from crp_tpu.sparse.synth import banded_random_csr, fill_b
from crp_tpu.utils import compile_cache
from crp_tpu.utils.norms import rel_fro_err


@contextlib.contextmanager
def _x64_off():
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def _rowpara(a, dtype, devices8):
    from crp_tpu.engine.rowpara import RowParaSpmm
    from crp_tpu.plan.partition1d import csr_row_partition
    from crp_tpu.shard.layout import make_mesh_1d

    d = csr_row_partition(a.rowptr, 2)
    return RowParaSpmm(a, d, d, 8, dtype=dtype,
                       mesh=make_mesh_1d(2, devices=devices8))


def _para2d(a, dtype, devices8):
    from crp_tpu.engine.para2d import Para2dSpmm
    from crp_tpu.plan.planner2d import plan_from_csr
    from crp_tpu.shard.layout import make_mesh_2d

    plan = plan_from_csr(a, 8, 2)
    return Para2dSpmm(a, plan, dtype=dtype,
                      mesh=make_mesh_2d(plan.pm, plan.pn, devices=devices8))


def _crp(a, dtype, devices8):
    from crp_tpu.engine.crp import CrpSpmm
    from crp_tpu.shard.redist import BlockDist
    from crp_tpu.utils.blocks import uniform_displs

    user = BlockDist.from_row_slabs(uniform_displs(a.nrow, 2), 8)
    return CrpSpmm(a, 8, user, user, nproc=2, dtype=dtype)


ENGINES = {"rowpara": _rowpara, "para2d": _para2d, "crp": _crp}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_float64_without_x64_is_refused(engine, devices8):
    a = banded_random_csr(120, nnz_per_row=5, bandwidth=10, seed=70)
    with _x64_off():
        with pytest.raises(ValueError, match="jax_enable_x64"):
            ENGINES[engine](a, np.float64, devices8)
        # the config default is float64 too
        with pytest.raises(ValueError, match="jax_enable_x64"):
            ENGINES[engine](a, None, devices8)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_float32_without_x64_runs(engine, devices8):
    a = banded_random_csr(120, nnz_per_row=5, bandwidth=10, seed=71)
    b = np.asarray(fill_b(0, a.ncol, 0, 8, dtype=np.float32))
    with _x64_off():
        eng = ENGINES[engine](a, np.float32, devices8)
        c = eng.exec(b)
    assert rel_fro_err(a.spmm_ref(b), c) <= 1e-5


def test_engine_dtype_resolution():
    assert engine_dtype(None, SpmmConfig()) == np.float64
    assert engine_dtype(np.float32, SpmmConfig()) == np.float32
    assert engine_dtype(None, SpmmConfig(dtype="float32")) == np.float32
    with _x64_off():
        assert engine_dtype("float32", SpmmConfig()) == np.float32
        with pytest.raises(ValueError, match="jax_enable_x64"):
            engine_dtype(None, SpmmConfig())


@contextlib.contextmanager
def _cache_config():
    saved = jax.config.jax_compilation_cache_dir
    try:
        yield
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    with _cache_config():
        before = jax.config.jax_compilation_cache_dir
        assert compile_cache.setup_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; the program sets nothing
        assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_repo_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    with _cache_config():
        path = compile_cache.setup_compile_cache()
        assert jax.config.jax_compilation_cache_dir == path
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    # a fixed name: no pid, time or temporary directory in it
    assert path == compile_cache.REPO_CACHE_DIR
