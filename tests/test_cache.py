"""Persistent-compile-cache location (utils/cache.py).

JAX_COMPILATION_CACHE_DIR, when set, is the only directory used.
Otherwise accelerator runs share the fixed <repo>/.jax_cache, and CPU
runs are keyed by the host's CPU and the jax/jaxlib build (a foreign
XLA:CPU AOT entry loads with feature-mismatch warnings and ulp-different
codegen).  Pure-unit: no jit dispatch.
"""

import os

import jax

from disinfect_slam.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_dir_is_fingerprinted_under_repo(monkeypatch):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    d = cache.resolve_dir("cpu")
    assert os.path.dirname(d) == os.path.join(REPO, ".jax_cache_cpu")
    assert len(os.path.basename(d)) == 12  # build id


def test_fingerprint_keys_build_not_boot(monkeypatch):
    """The CPU key is the host CPU plus the jax/jaxlib versions: the
    same machine gets the same directory after a reboot, another jax
    build gets another."""
    fp = cache._build_fingerprint()
    assert fp == cache._build_fingerprint()
    monkeypatch.setattr(jax, "__version__", "0.0.0-other")
    assert cache._build_fingerprint() != fp


def test_accelerator_dir_is_fixed(monkeypatch, tmp_path):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert cache.resolve_dir("gpu") == want
    monkeypatch.chdir(tmp_path)  # independent of the working directory
    assert cache.resolve_dir("cuda,cpu") == want


def test_env_var_is_honoured_by_enable(monkeypatch, tmp_path):
    """enable() points JAX at the variable's directory and no other."""
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable("gpu") == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_env_override_wins(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.resolve_dir("cpu") == str(tmp_path)
    assert cache.resolve_dir("gpu") == str(tmp_path)
