"""Test configuration: force an 8-device virtual CPU mesh with fp64.

The multi-device tests emulate the reference's ``mpirun -np P`` single-box
runs (``README.md:31-34``) with a virtual CPU mesh
(``--xla_force_host_platform_device_count=8``), and run in fp64 to meet the
reference's ``<= 1e-12`` Frobenius acceptance check natively.

JAX fixes its platform and device count when it first initializes, so
``pytest_configure`` re-execs pytest once with the CPU-mesh environment
(global capture stopped so the replacement process writes to the real
stdout).  The suite is a CPU tool: tests that need a CUDA GPU carry the
``gpu`` marker and skip here through the ``gpu_device`` fixture.  On a
machine with a card, ``python -m pytest -m gpu tests/`` skips the re-exec
and runs just those tests on the default backend.
"""

import os
import sys

_SENTINEL = "CRP_TPU_TEST_ENV_READY"


def pytest_configure(config):
    if os.environ.get(_SENTINEL) == "1" or config.option.markexpr == "gpu":
        import jax

        jax.config.update("jax_enable_x64", True)
        return
    capman = config.pluginmanager.getplugin("capturemanager")
    if capman is not None:
        capman.stop_global_capturing()
    env = dict(os.environ)
    env[_SENTINEL] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
    env["JAX_ENABLE_X64"] = "1"
    os.execvpe(sys.executable, [sys.executable, "-m", "pytest"] + sys.argv[1:], env)


import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def devices8():
    import jax

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test on any other backend.  Decided
    here, at run time, so every xdist worker collects the same tests."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (run: pytest -m gpu on the card)")
    return jax.devices()[0]


@pytest.fixture
def triton_interpret(monkeypatch):
    """Let the engines pack ``kernel="triton"`` in Pallas interpret mode, so
    the CPU mesh runs the GPU kernel's arithmetic through the engines (no
    engine selects interpret mode on its own)."""
    import functools

    from crp_tpu.engine import crp, para2d, rowpara
    from crp_tpu.kernels import dispatch

    patched = functools.partial(dispatch.pack_local_kernel, interpret=True)
    for mod in (dispatch, rowpara, para2d, crp):
        monkeypatch.setattr(mod, "pack_local_kernel", patched)
