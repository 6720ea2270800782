"""Where the persistent compilation cache lives (utils/jaxcache.py)."""

import os

from deflatedmlmc_schwinger_tpu.utils import jaxcache


def test_cache_dir_defers_to_jax_env_var(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxcache.cache_dir() is None


def test_cache_dir_defaults_to_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = jaxcache.cache_dir()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")


def test_enable_is_a_noop_on_cpu(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    jaxcache.enable()
    assert jax.config.jax_compilation_cache_dir == before
