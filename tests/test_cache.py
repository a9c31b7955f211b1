"""The persistent compilation cache: one directory for every entry point."""

import os

import jax
import pytest

from tpu_se.utils.cache import REPO_CACHE_DIR, setup_compilation_cache


@pytest.fixture
def restore_jax_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_cache_dir(env_dir, tmp_path, monkeypatch, restore_jax_cache_config):
    """Set, JAX_COMPILATION_CACHE_DIR is the only cache; unset, the cache
    is ``<repo>/.jax_cache``.  Either way the already-imported jax is told."""
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = REPO_CACHE_DIR
        assert REPO_CACHE_DIR.endswith("/.jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert setup_compilation_cache() == want
    assert os.environ["JAX_COMPILATION_CACHE_DIR"] == want
    assert jax.config.jax_compilation_cache_dir == want
