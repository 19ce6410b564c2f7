"""The command-line and driver entry points: bench.py refuses the CPU
and the removed kernel flags; the compile-check entry and the
multi-device dry run work on the virtual CPU mesh."""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import __graft_entry__ as graft

ROOT = Path(__file__).resolve().parents[1]


def _run(*argv):
    return subprocess.run([sys.executable, *argv], cwd=ROOT,
                          env={"JAX_PLATFORMS": "cpu",
                               "PATH": "/usr/bin:/bin", "HOME": str(ROOT)},
                          capture_output=True, text=True, timeout=120)


def test_bench_refuses_the_cpu():
    proc = _run("bench.py", "--n", "32")
    assert proc.returncode == 1
    assert "no accelerator" in proc.stderr
    assert proc.stdout == ""


@pytest.mark.parametrize("argv", [
    ("bench.py", "--impl", "jnp"),
    ("bench.py", "--fuse-k", "4"),
    ("tools/bench_matrix.py", "--impls", "jnp"),
])
def test_removed_kernel_flags_are_refused(argv):
    proc = _run(*argv)
    assert proc.returncode == 2
    assert "unrecognized arguments" in proc.stderr


def test_entry_step_compiles_and_runs():
    fn, args = graft.entry()
    state, diag = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(state.u)).all()
    assert int(diag.p_iters) > 0


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_dryrun_multichip(n_devices):
    assert len(jax.devices()) >= n_devices
    graft.dryrun_multichip(n_devices)


def _former_name():
    """The alias package beside cfd_demo_jax (the package's old name)."""
    (name,) = [p.parent.name for p in ROOT.glob("cfd_demo_*/__init__.py")
               if p.parent.name != "cfd_demo_jax"]
    return name


@pytest.mark.parametrize("module", ["", ".solver.piso", ".core.config"])
def test_former_package_name_imports_the_same_modules(module):
    import importlib
    import cfd_demo_jax
    old = importlib.import_module(_former_name() + module)
    assert old is importlib.import_module("cfd_demo_jax" + module)
    if not module:
        assert old.make_scene is cfd_demo_jax.make_scene
