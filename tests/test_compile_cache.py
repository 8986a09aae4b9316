"""Persistent compilation cache location (utils/compile_cache.py)."""

from pathlib import Path

import jax

from attosecondraytracing_tpu.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]


def test_env_variable_wins(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the helper sets nothing (JAX reads
    the variable itself) and reports that directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_fixed_checkout_path_when_unset(monkeypatch):
    """Unset: the cache goes to .jax_cache/ at the checkout root — a fixed
    path (part of the cache key), listed in .gitignore."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert compile_cache.enable_compile_cache() == path  # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().splitlines()
