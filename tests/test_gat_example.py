"""Smoke-test the GAT training example.

``examples/gat_train.py`` is the demo of the trainable-adjacency surface
(ValueParameterizedSpmm.op + sddmm under jax.grad); like the GCN example
(``tests/test_gcn_example.py``) it is pinned in CI so it cannot silently
rot.  Runs the real script as a subprocess on the virtual CPU mesh with a
tiny graph, and checks the example's own acceptance: loss decreases and
final accuracy beats the script's 0.7 bar (chance is 1/8).
"""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "examples", "gat_train.py")


def test_gat_train_smoke():
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
    )
    env.pop("JAX_ENABLE_X64", None)  # example runs at fp32 like a user
    res = subprocess.run(
        [sys.executable, SCRIPT, "--nodes=800", "--steps=12", "--p=2",
         "--hidden=16"],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-2000:])
    losses = [float(m) for m in re.findall(r"loss (\d+\.\d+)", res.stdout)]
    assert len(losses) >= 2, res.stdout
    assert losses[-1] < losses[0], res.stdout
    m = re.search(r"final accuracy (\d+\.\d+)", res.stdout)
    assert m and float(m.group(1)) > 0.7, res.stdout
