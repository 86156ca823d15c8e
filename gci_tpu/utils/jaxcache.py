"""Persistent XLA compile cache wiring — the one implementation every entry
point (CLI, bench, graft entry, chip smoke) shares.

When ``JAX_COMPILATION_CACHE_DIR`` is set, jax reads it itself and nothing
here sets another directory.  Otherwise the cache lives at the fixed
``.jax_cache/`` of the checkout the package runs from (listed in
``.gitignore``), so every entry point of one checkout shares one cache.
Safe to call more than once and after jax's backend is up.
"""
from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> None:
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    try:
        os.makedirs(CHECKOUT_CACHE_DIR, exist_ok=True)
    except OSError:
        return  # read-only checkout: run without a persistent cache
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
