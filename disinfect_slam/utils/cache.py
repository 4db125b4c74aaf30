"""Persistent XLA compilation cache setup.

Full-size programs take a while to compile; caching compiled
executables on disk lets every later process that builds the same
program load it instead.  Call enable() before the first jit dispatch.

Where the cache lives:
  - JAX_COMPILATION_CACHE_DIR, when set, and nothing else;
  - otherwise accelerator runs use the fixed <repo>/.jax_cache (the path
    is part of the cache key, so it must not move between runs);
  - CPU runs use <repo>/.jax_cache_cpu/<build id>.  XLA:CPU caches AOT
    machine code keyed WITHOUT the host's CPU feature set, so an entry
    compiled on another machine or by another jaxlib build loads with a
    "machine type doesn't match" warning and different codegen (ulp-level
    divergence, possibly SIGILL).  The build id hashes the host's CPU
    model and flags with the jax/jaxlib versions to keep those apart.
"""

from __future__ import annotations

import hashlib
import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _build_fingerprint() -> str:
    """Stable per-(cpu family, jax/jaxlib build) id, 12 hex digits."""
    parts = []
    try:
        with open("/proc/cpuinfo") as f:
            parts.extend(sorted({
                ln.strip() for ln in f
                if ln.startswith(("flags", "model name"))
            }))
    except OSError:
        import platform

        parts.append(platform.machine() or "unknown")
    import jax
    import jaxlib

    parts.append(f"jax={jax.__version__}")
    parts.append(f"jaxlib={getattr(jaxlib, '__version__', '?')}")
    return hashlib.sha1("\n".join(parts).encode()).hexdigest()[:12]


def resolve_dir(platform_name: str | None = None) -> str:
    """Cache directory for the given (or configured) platform."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    if platform_name is None:
        import jax

        platform_name = (
            getattr(jax.config, "jax_platforms", None)
            or os.environ.get("JAX_PLATFORMS")
            or ""
        )
    if platform_name.split(",")[0].strip().lower() == "cpu":
        return os.path.join(_repo_root(), ".jax_cache_cpu", _build_fingerprint())
    return os.path.join(_repo_root(), ".jax_cache")


def enable(platform_name: str | None = None) -> str:
    """Point JAX's persistent cache at resolve_dir(); returns the path."""
    import jax

    cache_dir = resolve_dir(platform_name)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return cache_dir
