"""Device MPHF probe — the hottest op of the serving path.

Vectorized equivalent of `NoKeyBoomHashMap::get` / `Mphf::try_hash`
(reference probe site: src/pseudoaligner.rs:96 [dep]).  Per level:
32-bit fmix hash -> mask -> one gather for the bit word, one for the rank
prefix, `lax.population_count` for the in-word rank.  Level metadata is
static (baked into the trace), so the level loop is unrolled.

Probes of alien keys can return a false-positive slot (as in BBHash); the
`verified_lookup` wrapper resolves truth with a single gather of the
slot-ordered packed keys (the reference instead verifies against the graph
sequence, src/pseudoaligner.rs:99-107 — one extra indirection; storing
keys trades ~8 bytes/kmer of HBM for fewer dependent gathers).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .hashing import hash_kmer_jnp


class MphfMeta(NamedTuple):
    """Static per-level metadata (python ints -> trace constants)."""

    seeds: tuple[int, ...]
    masks: tuple[int, ...]
    word_offsets: tuple[int, ...]
    key_offsets: tuple[int, ...]


def mphf_probe(
    words: jnp.ndarray,  # [..., W] uint32 kmer words
    bits: jnp.ndarray,  # [total_words] uint32
    ranks: jnp.ndarray,  # [total_words] uint32
    meta: MphfMeta,
) -> jnp.ndarray:
    """Probe -> [...] int32 candidate slot, -1 if no level hit."""
    out = jnp.full(words.shape[:-1], -1, dtype=jnp.int32)
    for lv in range(len(meta.seeds)):
        h = hash_kmer_jnp(words, jnp.uint32(meta.seeds[lv])) & jnp.uint32(meta.masks[lv])
        w = jnp.int32(meta.word_offsets[lv]) + (h >> 5).astype(jnp.int32)
        word = jnp.take(bits, w, axis=0)
        bitpos = h & jnp.uint32(31)
        bit = (word >> bitpos) & jnp.uint32(1)
        below = word & ((jnp.uint32(1) << bitpos) - jnp.uint32(1))
        rank = jnp.take(ranks, w, axis=0).astype(jnp.int32) + jax.lax.population_count(
            below
        ).astype(jnp.int32)
        hit = (out < 0) & (bit == 1)
        out = jnp.where(hit, jnp.int32(meta.key_offsets[lv]) + rank, out)
    return out


def mphf_probe_dynamic(
    words: jnp.ndarray,  # [..., W] uint32
    bits: jnp.ndarray,
    ranks: jnp.ndarray,
    seeds: jnp.ndarray,  # [n_levels] uint32 (device values, not static)
    masks: jnp.ndarray,  # [n_levels] uint32
    word_offsets: jnp.ndarray,  # [n_levels] int32
    key_offsets: jnp.ndarray,  # [n_levels] int32
    n_levels: int,  # static trip count (padded levels must have mask=0
    #                 and point at a zero word so they can never hit)
) -> jnp.ndarray:
    """Probe with per-shard level metadata held in (small) device arrays —
    used by the k-mer-partitioned mode where each mesh shard carries its
    own sub-MPHF (parallel/sharded_index.py)."""
    out = jnp.full(words.shape[:-1], -1, dtype=jnp.int32)
    for lv in range(n_levels):
        h = hash_kmer_jnp(words, seeds[lv]) & masks[lv]
        w = word_offsets[lv] + (h >> 5).astype(jnp.int32)
        word = jnp.take(bits, w, axis=0)
        bitpos = h & jnp.uint32(31)
        bit = (word >> bitpos) & jnp.uint32(1)
        below = word & ((jnp.uint32(1) << bitpos) - jnp.uint32(1))
        rank = jnp.take(ranks, w, axis=0).astype(jnp.int32) + jax.lax.population_count(
            below
        ).astype(jnp.int32)
        hit = (out < 0) & (bit == 1)
        out = jnp.where(hit, key_offsets[lv] + rank, out)
    return out


def verified_lookup(
    words: jnp.ndarray,  # [..., W] uint32
    bits: jnp.ndarray,
    ranks: jnp.ndarray,
    meta: MphfMeta,
    kmer_keys: jnp.ndarray,  # [n_kmers, W] uint32, slot-ordered
    kmer_node: jnp.ndarray,  # [n_kmers] int32
    kmer_offset: jnp.ndarray,  # [n_kmers] int32
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact lookup: returns (node [...], offset [...]) int32, -1 on miss."""
    slot = mphf_probe(words, bits, ranks, meta)
    safe = jnp.maximum(slot, 0)
    stored = jnp.take(kmer_keys, safe, axis=0)  # [..., W]
    ok = (slot >= 0) & jnp.all(stored == words, axis=-1)
    node = jnp.where(ok, jnp.take(kmer_node, safe, axis=0), jnp.int32(-1))
    off = jnp.where(ok, jnp.take(kmer_offset, safe, axis=0), jnp.int32(-1))
    return node, off
