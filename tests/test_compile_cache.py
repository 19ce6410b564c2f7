"""runtime.compile_cache: JAX_COMPILATION_CACHE_DIR wins untouched;
otherwise the cache goes to the fixed .jax_cache/ of the checkout."""
from pathlib import Path

import jax
import pytest

from cfd_demo_jax.runtime import compile_cache

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_environment_directory_wins(monkeypatch, tmp_path,
                                    restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_the_checkouts_fixed_directory(monkeypatch,
                                                  restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    # The same path on every call: a cache that moves is never hit.
    assert compile_cache.enable_compile_cache() == got


def test_default_directory_is_ignored_by_git():
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_importing_the_package_sets_no_cache(tmp_path):
    import subprocess
    import sys
    code = ("import jax, cfd_demo_jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"JAX_PLATFORMS": "cpu", "HOME": str(tmp_path),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "None"
