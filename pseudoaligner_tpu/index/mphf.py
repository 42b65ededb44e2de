"""BBHash-style minimal perfect hash over k-mers (host build, NumPy).

Equivalent of `boomphf::Mphf` (BBHash, Limasset et al. 2017;
[dep], reference call sites src/build_index.rs:195-197 and probe at
src/pseudoaligner.rs:96).  Differences by design, for the device probe path:

- level sizes are powers of two (bit positions come from a 32-bit hash
  masked by `size-1`), so the device probe needs no 64-bit modulo;
- per-word rank prefixes are precomputed at build time, so a probe is
  `hash -> gather bit word -> gather rank word -> popcount` per level —
  O(levels) gathers, no rank scan;
- all levels are concatenated into flat uint32 arrays that live in HBM.

gamma=1.7 matches the reference call (src/build_index.rs:197); with pow2
rounding the effective load factor is <= 1/1.7, so level counts converge
in ~3-6 levels.  Like the reference's MPHF, a probe of an alien key can
return a false positive index; callers must verify (the reference verifies
against the graph at src/pseudoaligner.rs:99-107; here the packed key words
are stored alongside for one-gather verification).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.hashing import hash_kmer_np, level_seed

MAX_LEVELS = 48


@dataclass
class Mphf:
    """Flat MPHF image: concatenated level bitvectors + rank prefixes."""

    n_keys: int
    # per-level metadata, shape [n_levels]
    seeds: np.ndarray  # uint32
    masks: np.ndarray  # uint32 (size-1, pow2 sizes)
    word_offsets: np.ndarray  # uint32: first word of each level in `bits`
    key_offsets: np.ndarray  # uint32: keys placed before this level
    # flat arrays
    bits: np.ndarray  # uint32 bitvector words, all levels concatenated
    ranks: np.ndarray  # uint32: set bits within level before each word

    @property
    def n_levels(self) -> int:
        return len(self.seeds)

    def lookup(self, words: np.ndarray) -> np.ndarray:
        """Vectorized probe: [n, W] kmer words -> [n] int64 slot or -1.

        NumPy mirror of the device probe in ops/mphf_lookup.py (bit-identical
        control flow).  Alien keys may return a false-positive slot.
        """
        words = np.asarray(words, dtype=np.uint32)
        n = words.shape[0]
        out = np.full(n, -1, dtype=np.int64)
        for lv in range(self.n_levels):
            h = hash_kmer_np(words, int(self.seeds[lv])) & self.masks[lv]
            w = int(self.word_offsets[lv]) + (h >> np.uint32(5))
            bit = (self.bits[w] >> (h & np.uint32(31))) & np.uint32(1)
            below = self.bits[w] & ((np.uint32(1) << (h & np.uint32(31))) - np.uint32(1))
            rank = self.ranks[w].astype(np.int64) + _popcount32_np(below)
            hit = (out < 0) & (bit == 1)
            out[hit] = int(self.key_offsets[lv]) + rank[hit]
        return out


def _popcount32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32, copy=True)
    x = x - ((x >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2)) & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    with np.errstate(over="ignore"):
        x = (x * np.uint32(0x01010101)) >> np.uint32(24)
    return x.astype(np.int64)


def _next_pow2(x: int) -> int:
    return 1 << max(6, (x - 1).bit_length())


def build_mphf(
    keys: np.ndarray, gamma: float = 1.7, native: bool | None = None
) -> tuple[Mphf, np.ndarray]:
    """Build the MPHF over unique keys.

    keys: [n, W] uint32 kmer words (must be distinct).
    Returns (mphf, slot_of_key): slot_of_key[i] is the MPHF slot assigned to
    keys[i] — the caller scatters its values (and the keys themselves, for
    probe verification) into slot order.

    Prefers the native C++ build (pa_mphf; bit-identical by construction —
    the level assignment is deterministic given the keys) and falls back to
    the NumPy path below; `native=False` forces NumPy (tests diff the two).
    """
    if native is not False and len(keys):
        try:
            from .native import mphf_native

            r = mphf_native(np.asarray(keys, dtype=np.uint32), gamma)
            return (
                Mphf(
                    n_keys=r["n_keys"],
                    seeds=r["seeds"],
                    masks=r["masks"],
                    word_offsets=r["word_offsets"],
                    key_offsets=r["key_offsets"],
                    bits=r["bits"],
                    ranks=r["ranks"],
                ),
                r["slot_of_key"],
            )
        except Exception as e:
            if native:
                raise
            # leave a trace: a silent fallback turns toolchain/ABI
            # breakage into an unexplained ~25x build slowdown at scale
            # (review r5; build_index logs the same way)
            import logging

            logging.getLogger(__name__).warning(
                "native MPHF build unavailable (%s); NumPy fallback", e)
    keys = np.asarray(keys, dtype=np.uint32)
    n = keys.shape[0]
    slot_of_key = np.full(n, -1, dtype=np.int64)

    remaining = np.arange(n, dtype=np.int64)
    seeds, masks, word_offsets, key_offsets = [], [], [], []
    bits_parts, ranks_parts = [], []
    word_off = 0
    key_off = 0

    for lv in range(MAX_LEVELS):
        m = len(remaining)
        if m == 0:
            break
        # gamma=1.7 for the big early levels (memory-bound); grow the
        # oversizing on the tail so the level count — and with it the
        # device probe's unrolled depth — stays small.  A few extra KB on
        # tiny tail levels buys ~2x fewer probe steps per lookup.
        g = gamma if lv < 3 else max(gamma, 8.0)
        size = _next_pow2(int(np.ceil(g * m)))
        seed = level_seed(lv)
        h = hash_kmer_np(keys[remaining], seed) & np.uint32(size - 1)
        counts = np.bincount(h, minlength=size)
        uniq = counts[h] == 1

        nwords = size // 32
        bitvec = np.zeros(nwords, dtype=np.uint32)
        hu = h[uniq]
        np.bitwise_or.at(bitvec, hu >> np.uint32(5), np.uint32(1) << (hu & np.uint32(31)))

        pop = _popcount32_np(bitvec)
        rank = np.zeros(nwords, dtype=np.uint32)
        if nwords > 1:
            rank[1:] = np.cumsum(pop[:-1]).astype(np.uint32)

        below = bitvec[hu >> np.uint32(5)] & (
            (np.uint32(1) << (hu & np.uint32(31))) - np.uint32(1)
        )
        slot_of_key[remaining[uniq]] = (
            key_off + rank[hu >> np.uint32(5)].astype(np.int64) + _popcount32_np(below)
        )

        seeds.append(seed)
        masks.append(size - 1)
        word_offsets.append(word_off)
        key_offsets.append(key_off)
        bits_parts.append(bitvec)
        ranks_parts.append(rank)
        word_off += nwords
        key_off += int(uniq.sum())
        remaining = remaining[~uniq]
    # converging exactly at the last level is success (the native build,
    # pa_mphf, accepts it too — the for/else form wrongly raised here)
    if len(remaining):
        raise RuntimeError(
            f"MPHF did not converge in {MAX_LEVELS} levels ({len(remaining)} keys left)"
        )

    assert key_off == n, (key_off, n)
    assert (slot_of_key >= 0).all()
    # sanity: the slot assignment is a permutation of 0..n-1
    mphf = Mphf(
        n_keys=n,
        seeds=np.asarray(seeds, dtype=np.uint32),
        masks=np.asarray(masks, dtype=np.uint32),
        word_offsets=np.asarray(word_offsets, dtype=np.uint32),
        key_offsets=np.asarray(key_offsets, dtype=np.uint32),
        bits=np.concatenate(bits_parts) if bits_parts else np.zeros(0, np.uint32),
        ranks=np.concatenate(ranks_parts) if ranks_parts else np.zeros(0, np.uint32),
    )
    return mphf, slot_of_key
