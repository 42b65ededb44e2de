"""Shared 32-bit hash spec for k-mer hashing.

Device code works in 32-bit integers: every hash in the framework is built from
murmur3's fmix32 avalanche over the little-endian uint32 k-mer words, so
the host (NumPy) index builder and the device (jnp/Pallas) probes compute
bit-identical values without 64-bit integer emulation.

Replaces the `boomphf` crate's wyhash-based hashing ([dep], reference call
sites src/build_index.rs:195-197,213, src/pseudoaligner.rs:96) — the MPHF
is self-contained, so only internal consistency matters, and a 32-bit mix
needs no 64-bit integer emulation on the device.
"""

from __future__ import annotations

import numpy as np

from ..dna import _mix32

try:
    import jax.numpy as jnp
except Exception:  # pragma: no cover - host-only usage
    jnp = None

GOLDEN32 = 0x9E3779B9


def mix32_np(h: np.ndarray) -> np.ndarray:
    # ONE NumPy fmix32 for the whole framework: dna._mix32 is the
    # implementation (hashn N-substitution and the MPHF must stay
    # bit-identical — review r5: two copies only ASKED to stay in sync)
    return _mix32(np.asarray(h))


def hash_kmer_np(words: np.ndarray, seed: int) -> np.ndarray:
    """[..., W] uint32 words -> [...] uint32 hash.  Spec shared with jnp."""
    words = np.asarray(words, dtype=np.uint32)
    h = np.full(words.shape[:-1], np.uint32(seed), dtype=np.uint32)
    for j in range(words.shape[-1]):
        h = mix32_np(h ^ words[..., j])
    return h


def level_seed(level: int) -> int:
    """Per-MPHF-level seed; any fixed injective-ish map works."""
    return int(mix32_np(np.uint32((level + 1) * GOLDEN32 & 0xFFFFFFFF))[()])


# --- jnp mirrors (bit-identical) -------------------------------------------

if jnp is not None:

    def mix32_jnp(h):
        h = h.astype(jnp.uint32)
        h = h ^ (h >> 16)
        h = h * jnp.uint32(0x85EBCA6B)
        h = h ^ (h >> 13)
        h = h * jnp.uint32(0xC2B2AE35)
        h = h ^ (h >> 16)
        return h

    def hash_kmer_jnp(words, seed):
        """words: [..., W] uint32, seed: uint32 scalar -> [...] uint32."""
        h = jnp.broadcast_to(jnp.uint32(seed), words.shape[:-1])
        for j in range(words.shape[-1]):
            h = mix32_jnp(h ^ words[..., j])
        return h
