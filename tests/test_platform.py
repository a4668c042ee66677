"""Platform plumbing: the per-platform implementation choice, the
compile-cache location, and chip_smoke.py's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from pointcloud_depthfusion_tpu.ops import backend
from pointcloud_depthfusion_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_backend_choice_per_platform(platform):
    """Each supported platform names an implementation the op accepts."""
    assert backend.choose("align", platform) in ("scatter", "binned")


def test_backend_choice_unknown_platform_raises():
    """No quiet fallback: an unsupported platform is an error."""
    with pytest.raises(RuntimeError, match="platform 'metal'"):
        backend.choose("align", "metal")


def test_backend_choice_defaults_to_jax_backend():
    assert backend.choose("align") == backend.choose(
        "align", jax.default_backend())


def test_compile_cache_uses_env_dir(tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and
    no other is set in code."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_persistent_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_in_checkout(monkeypatch):
    """Without the variable the cache goes to a fixed, git-ignored
    directory at the root of the checkout."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_persistent_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _smoke(cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_chip_smoke_fails_without_gpu():
    r = _smoke(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied away from the repository, the script cannot pass."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
