"""Runtime helpers: backend selection and the persistent compile cache."""

from __future__ import annotations

import os
from pathlib import Path

#: fixed default cache directory inside the checkout: the path is part of
#: the cache key, so a directory that moves never hits
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def force_platform(platform: str, host_device_count: int | None = None) -> None:
    """Select the JAX backend ('cpu', 'gpu', ...) before its first use.

    Equivalent to exporting ``JAX_PLATFORMS``; it must run before anything
    touches ``jax.devices()``. host_device_count: for 'cpu', fake this many
    host devices (XLA reads the flag when the CPU client is created).
    """
    if platform == "cpu" and host_device_count:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={host_device_count}"
            )
    import jax

    jax.config.update("jax_platforms", platform)


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache at ``compile_cache_dir()``."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
