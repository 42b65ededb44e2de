"""Device-side k-mer extraction: [B, L] base codes -> packed kmer words.

Vectorized equivalent of `DnaString::get_kmer` over every read position
(reference seed scan call site: src/pseudoaligner.rs:93 [dep]).  Instead of
extracting one k-mer at a time in a scalar loop, the whole [B, P] k-mer
matrix (P = L-k+1) is produced with k shift-or passes of [B, P] uint32
vector ops — VPU-friendly, no gathers.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..dna import kmer_words


def all_kmers(reads: jnp.ndarray, k: int) -> jnp.ndarray:
    """reads: [B, L] integer base codes -> [B, P, W] uint32 kmer words.

    Word layout matches dna.pack_kmers (little-endian uint32 words,
    leftmost base most significant).
    """
    B, L = reads.shape
    P = L - k + 1
    if P < 1:
        # explicit raise: under python -O the old assert vanished and a
        # [B, 0, W] kmer matrix flowed on silently (review r5)
        raise ValueError(f"batch width {L} below k={k}")
    W = kmer_words(k)
    r = reads.astype(jnp.uint32)
    words = [jnp.zeros((B, P), jnp.uint32) for _ in range(W)]
    for i in range(k):
        bitpos = 2 * (k - 1 - i)
        w, shift = bitpos // 32, bitpos % 32
        words[w] = words[w] | (r[:, i : i + P] << jnp.uint32(shift))
    return jnp.stack(words, axis=-1)
