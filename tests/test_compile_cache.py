"""utils/compile_cache: one fixed cache directory, or JAX's own variable."""

import os

import jax
import pytest

from pyracecarsimulator_tpu.utils import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def restore_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_set_leaves_jax_config_alone(monkeypatch, tmp_path,
                                             restore_cache_config):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cc.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_env_var_unset_uses_checkout_dir(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cc.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_cache_dir_is_fixed_and_gitignored():
    """The path is part of the cache key: no time, pid or temp name."""
    assert cc.CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
