"""The one place that decides where JAX keeps its persistent compile cache.

The quality model and the fragment-consensus program are the same across
processes and runs, so a compiled program is worth keeping.  When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets nothing; otherwise the cache goes to ``<repo>/.jax_cache`` (listed in
.gitignore), a fixed path so that later runs of the same checkout hit it.
"""

import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir():
    """The directory this process should set, or None when the
    environment already names one."""
    if os.environ.get(ENV_VAR):
        return None
    return os.path.join(REPO, ".jax_cache")


def configure():
    """Apply the cache rule to this process; returns the cache path in
    effect (for logs)."""
    import jax
    path = cache_dir()
    if path is None:
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", path)
    return path
