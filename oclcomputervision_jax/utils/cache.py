"""Where JAX keeps its persistent compilation cache."""

from __future__ import annotations

import os

from oclcomputervision_jax.utils.assets import _REPO_ROOT


def enable_compile_cache(subdir: str | None = None) -> str:
    """Point JAX's persistent compilation cache at one directory.

    ``$JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the
    cache lives in ``.jax_cache/`` at the checkout root (git-ignored).
    ``subdir`` keeps one caller's entries apart inside it: the test suite
    gives each xdist worker its own, because concurrent writers on one
    directory have crashed JAX's cache code. Returns the path.
    """
    import jax

    base = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO_ROOT, ".jax_cache"
    )
    path = os.path.join(base, subdir) if subdir else base
    jax.config.update("jax_compilation_cache_dir", path)
    return path
