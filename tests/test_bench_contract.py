"""The driver-contract surfaces: bench.py and chip_smoke.py refuse to
run off the GPU; __graft_entry__ compiles and dry-runs."""

import os
import subprocess
import sys

import pytest


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_gpu_scripts_exit_nonzero_on_cpu(script):
    """bench.py and chip_smoke.py measure the GPU only: on the CPU they
    exit non-zero and print no result line, never shrinking or falling
    back."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, os.path.join(root, script)],
                         capture_output=True, text=True, env=env,
                         cwd=root, timeout=300)
    assert out.returncode != 0
    assert "found no GPU" in out.stderr
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """Copied away from the repository, chip_smoke.py cannot import the
    program and exits non-zero without a result line."""
    import shutil
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copy(os.path.join(root, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_graft_entry_contract():
    import jax
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as g
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (171, 128)
    g.dryrun_multichip(8)
