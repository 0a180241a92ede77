"""chip_smoke.py: it refuses to run off the GPU, and its phases — the same
functions the GPU run calls — pass at a tiny size on the CPU mesh."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("CRP_TPU_TEST_ENV_READY", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_refuses_without_gpu():
    res = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


ONE = [name for name, _ in chip_smoke.one_card_phases()]
FOUR = [name for name, _ in chip_smoke.four_card_phases()]


@pytest.mark.parametrize("name", ONE)
def test_one_card_phase_tiny(name, devices8, capsys):
    phases = dict(chip_smoke.one_card_phases(
        w1_rows=900, plaw_rows=1024, n=16, devices=devices8[:1]))
    assert chip_smoke.run_phases([(name, phases[name])])
    out = capsys.readouterr().out
    assert '"ok": true' in out and '"kernel": "segsum"' in out


@pytest.mark.parametrize("name", FOUR)
def test_four_card_phase_tiny(name, devices8, capsys):
    phases = dict(chip_smoke.four_card_phases(
        w1_rows=900, plaw_rows=1024, n=16, devices=devices8[:4]))
    assert chip_smoke.run_phases([(name, phases[name])])
    assert '"ok": true' in capsys.readouterr().out


def test_failed_phase_fails_the_run(capsys):
    def boom():
        raise RuntimeError("injected")

    ok = chip_smoke.run_phases([("good", lambda: dict(ok=True)),
                                ("bad", boom)])
    assert not ok
    assert "injected" in capsys.readouterr().out


def test_tolerances_are_the_reference_bars():
    assert chip_smoke.TOL[np.dtype(np.float64)] == 1e-12
    assert chip_smoke.TOL[np.dtype(np.float32)] == 1e-5
    assert jax.config.jax_enable_x64  # fp64 phases compute natively
