"""The compile-cache helper: the environment decides, else <checkout>/.jax_cache."""

import os

import jax
import pytest

from ikpso.utils import cache


@pytest.fixture
def restore_cache_config():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_env_variable_leaves_jax_setting_alone(monkeypatch, tmp_path,
                                               restore_cache_config):
    sentinel = str(tmp_path / "untouched")
    jax.config.update("jax_compilation_cache_dir", sentinel)
    monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path / "from_env"))
    assert cache.enable_compile_cache() == str(tmp_path / "from_env")
    assert jax.config.jax_compilation_cache_dir == sentinel


def test_default_is_fixed_path_in_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv(cache.CACHE_ENV, raising=False)
    path = cache.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.basename(path) == ".jax_cache"
    checkout = os.path.dirname(path)
    assert os.path.isfile(os.path.join(checkout, "ikpso", "__init__.py"))
    assert path == cache.default_cache_dir()
