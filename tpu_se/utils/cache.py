"""One persistent XLA compilation cache for every entry point.

The reference's process model is one trainer process per epoch
(``finetune.pl:47-126``); without a persistent cache every epoch process,
decode run and benchmark re-pays the full XLA compile.
"""

from __future__ import annotations

import os
import sys

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def setup_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at one directory; return it.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is and no other
    directory is set.  Otherwise the cache is ``<repo>/.jax_cache`` (listed
    in ``.gitignore``), a fixed path so that every process of a checkout
    finds what the others compiled.

    Safe before and after ``jax`` is imported: a later import reads the
    environment variables, and an already-loaded ``jax.config`` is updated.
    Importing this module does not import ``jax``, so pure-IO CLI commands
    stay fast.
    """
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR
    os.environ["JAX_COMPILATION_CACHE_DIR"] = cache
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
    if "jax" in sys.modules:
        import jax

        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs",
            float(os.environ["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"]))
    return cache
