import os
from pathlib import Path

# fixed, inside the checkout: the cache key includes the path, so a
# directory that moved between runs would never hit
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_cache() -> str:
    """Enable JAX's persistent compile cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    directory is set here; otherwise the cache lives at CACHE_DIR, beside
    the package."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not env:
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return env or str(CACHE_DIR)
