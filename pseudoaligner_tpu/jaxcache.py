"""Persistent XLA compilation cache wiring.

The mapping kernel's cold compile takes seconds per process; the
persistent cache lets repeat CLI/bench runs load the compiled executable
from disk instead.  Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads
it itself and no directory is set here.  Otherwise the cache lives at
the fixed `<repo>/.jax_cache`: the directory is part of what a cached
entry is found by, so it never depends on a temporary name, a process id
or the time.

The reference decouples build from serve by serializing the index
(src/bin/pseudoaligner.rs:114,135 there); the compile artifact gets the
same checkpoint treatment here.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compilation_cache(platform: str | None = None) -> str | None:
    """Turn on jax's persistent compilation cache for `platform` (default:
    jax's default backend) and return its directory.

    Call before the first jit compile.  Skipped (returns None) on the
    CPU backend, which serves tests and cross-checks: XLA's CPU loader
    logs machine-feature mismatches when it reloads its own entries."""
    import jax

    if (platform or jax.default_backend()) == "cpu":
        return None
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    # the kernel compiles take seconds; cache everything longer than a
    # trivial fusion
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return os.environ.get(ENV) or DEFAULT_DIR
