"""JAX backend start-up and the one device predicate.

ensure_backend() starts JAX's backend once per process. It honours an
explicit FLOXER_TPU_PLATFORM override, places the persistent compilation
cache, and lets a platform that cannot start raise: a GPU that fails to
initialise is an error, never a quiet CPU run.

accelerator() is the one question the rest of the program asks about the
hardware: is the default backend a GPU, so that the device kernels run
compiled for the card? On a CPU host it answers False, which is a real
deployment (host engines only), not a failure.
"""

from __future__ import annotations

import os
from pathlib import Path

# <checkout>/.jax_cache: a fixed path, because the cache directory is part
# of the key under which JAX finds a compiled program again
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"

_ensured = False


def compilation_cache_dir() -> str | None:
    """Where this program puts JAX's persistent compilation cache, or None
    when JAX_COMPILATION_CACHE_DIR is set (JAX then reads it itself and
    the program sets no directory of its own)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(CACHE_DIR)


def ensure_backend() -> str:
    """Initialize JAX's backend; returns its name. Raises when a requested
    or present accelerator cannot start."""
    global _ensured
    import jax

    if not _ensured:
        override = os.environ.get("FLOXER_TPU_PLATFORM")
        if override:
            jax.config.update("jax_platforms", override)
        cache_dir = compilation_cache_dir()
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.devices()
        if jax.default_backend() == "cpu":
            # with no platform named, JAX skips an accelerator plugin that
            # fails to start and quietly serves the CPU; it keeps the error
            from jax._src import xla_bridge

            failed = {
                platform: error
                for platform, error in getattr(
                    xla_bridge, "_backend_errors", {}
                ).items()
                if platform != "cpu"
            }
            if failed:
                raise RuntimeError(
                    f"accelerator backend failed to initialize: {failed}"
                )
        _ensured = True
    return jax.default_backend()


def accelerator() -> bool:
    """True when the default backend is a GPU."""
    return ensure_backend() == "gpu"
