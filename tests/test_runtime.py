"""The shared compile-cache helper."""

import os

import jax
import pytest

import dsopp_tpu
from dsopp_tpu.runtime import COMPILE_CACHE_DIR, enable_compile_cache


@pytest.fixture
def restore_cache_dir():
    was = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", was)


def test_cache_dir_from_env(monkeypatch, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    jax.config.update("jax_compilation_cache_dir", None)
    assert enable_compile_cache() == "/elsewhere/cache"
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_dir_fixed_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(dsopp_tpu.__file__))
    assert enable_compile_cache() == os.path.join(checkout, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == COMPILE_CACHE_DIR
    # the same path on every call: a moving cache never hits
    assert enable_compile_cache() == COMPILE_CACHE_DIR


def test_cache_dir_is_git_ignored():
    checkout = os.path.dirname(os.path.dirname(dsopp_tpu.__file__))
    with open(os.path.join(checkout, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
