"""core/jaxconfig: the one accelerator-or-CPU decision and the compile
cache that follows from it."""
import subprocess
from pathlib import Path

import jax
import pytest

from supernova_tpu.core import jaxconfig


@pytest.mark.parametrize("backend,accel", [("cpu", False), ("gpu", True)])
def test_on_accelerator_by_backend(monkeypatch, backend, accel):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert jaxconfig.on_accelerator() is accel


def test_cache_env_var_is_the_only_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxconfig.cache_dir(True) == str(tmp_path)
    assert jaxconfig.cache_dir(False) == str(tmp_path)


def test_cache_default_is_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = Path(jaxconfig.cache_dir(True))
    root = Path(__file__).resolve().parents[1]
    assert path == root / ".jax_cache"
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", str(path / "x")], cwd=root
    ).returncode
    assert ignored == 0 or not (root / ".git").exists()
    assert ".jax_cache/" in (root / ".gitignore").read_text().split()


def test_no_cache_on_cpu(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxconfig.cache_dir(False) is None
    assert jaxconfig.cache_dir() is None  # the tests' CPU backend
    monkeypatch.setattr(jaxconfig, "_DONE", False)
    before = jax.config.jax_compilation_cache_dir
    jaxconfig.ensure_cache()
    assert jax.config.jax_compilation_cache_dir == before
