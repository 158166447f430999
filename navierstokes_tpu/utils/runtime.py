"""Process-wide JAX settings that every entry point shares: where the
persistent compilation cache lives, and the precision of float32 matrix
products."""

from __future__ import annotations

import functools
import os
from pathlib import Path

import jax

# Every dot and einsum of the setup and step programs runs at full fp32
# precision.  At DEFAULT a GPU may run fp32 products in TF32, which keeps
# about three decimal digits: too few for the Newton-Schulz tile inverses,
# the assembled element matrices and the force integrals.
MATMUL_PRECISION = "highest"

# A fixed path inside the checkout: the cache key includes the path, so a
# directory that moves between runs never hits.
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def at_matmul_precision(fn):
    """Decorate ``fn`` so that every dot it traces uses MATMUL_PRECISION."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision(MATMUL_PRECISION):
            return fn(*args, **kwargs)
    return wrapped


def configure_compile_cache(backend: str | None = None) -> str | None:
    """Set up JAX's persistent compilation cache for an entry point.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX reads it and
    no directory is set here; otherwise the cache is ``<checkout>/.jax_cache``.
    The cache stays off on the CPU backend: XLA:CPU entries bake in the
    compiling host's CPU features and can crash another host that loads
    them.  Returns the cache directory in use, or None when it is off."""
    backend = backend or jax.default_backend()
    if backend == "cpu":
        jax.config.update("jax_enable_compilation_cache", False)
        return None
    jax.config.update("jax_enable_compilation_cache", True)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return jax.config.jax_compilation_cache_dir
