"""Bucketized two-choice cuckoo hash table — the speed-mode k-mer index.

Motivation: the device probe is bound by random gathers, and the BBHash
MPHF probe (7 levels x 2 word-gathers + key + value gathers ~ 17 gather
ops) needs ~8x more of them than a structure that answers in ~2 row
gathers (the per-gather cost on the H100 is not measured yet).  This
table stores (key, node, offset) together in 4-slot buckets; a probe
gathers bucket h1(k) and bucket h2(k) (two [B]-index row gathers) and
compares keys in registers.  Memory is ~the same as MPHF+keys+values
(which the serving path stores anyway for verification): the MPHF remains
as the memory-lean option (`AlignerConfig.seed_index = "mphf"`), matching
the reference's NoKeyBoomHashMap memory/speed tradeoff the other way
(reference: src/build_index.rs:220, src/pseudoaligner.rs:96 [dep]).

Layout: buckets [n_buckets, SLOTS * (W + 2)] uint32 — per slot the k-mer
words (little-endian, as everywhere) then node then offset.  Empty slots
hold the all-ones key (never a valid k-mer of <=64 bases... all-ones IS a
valid poly-T k-mer for k=16/32/64 word-filling sizes — so emptiness is
tracked by node == EMPTY sentinel instead).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.hashing import hash_kmer_np

SLOTS = 4
EMPTY = 0xFFFFFFFF
H1_SEED = 0x1357_9BDF
H2_SEED = 0x2468_ACE0
MAX_KICKS = 64


@dataclass
class CuckooIndex:
    buckets: np.ndarray  # [n_buckets, SLOTS*(W+2)] uint32
    mask: int  # n_buckets - 1
    W: int

    @property
    def n_buckets(self) -> int:
        return self.buckets.shape[0]


def _bucket_hashes(keys: np.ndarray, mask: int):
    h1 = hash_kmer_np(keys, H1_SEED) & np.uint32(mask)
    h2 = hash_kmer_np(keys, H2_SEED) & np.uint32(mask)
    return h1, h2


def build_cuckoo(
    keys: np.ndarray, nodes: np.ndarray, offsets: np.ndarray, load: float = 0.95
) -> CuckooIndex:
    """load is a REQUEST: power-of-two bucket rounding lands the actual
    load in [load/2, load].  0.95 keeps the table minimal (two-choice
    4-slot placement is feasible to ~0.98; overflow falls back to a
    bigger table) — at 52M keys this halves both the table (2.15 ->
    1.07GB) and its serve-time HBM upload.

    keys: [n, W] uint32 (distinct)."""
    n, W = keys.shape
    need = max(SLOTS * 2, int(np.ceil(n / load / SLOTS)) * SLOTS)
    nb = 1 << max(1, (need // SLOTS - 1).bit_length())
    mask = nb - 1

    # slots hold key INDICES during construction (so evictions reuse the
    # precomputed hashes); materialized into rows at the end
    slot_idx = np.full((nb, SLOTS), -1, dtype=np.int64)
    used = np.zeros(nb, dtype=np.int8)

    h1, h2 = _bucket_hashes(keys, mask)

    # bulk pass: greedy placement into the emptier of the two buckets,
    # vectorized round by round; leftovers go through scalar cuckoo kicks
    pending = np.arange(n)
    rng = np.random.default_rng(0xC0FFEE)
    for _ in range(8):
        if len(pending) == 0:
            break
        cnt1 = used[h1[pending]]
        cnt2 = used[h2[pending]]
        tgt = np.where(cnt1 <= cnt2, h1[pending], h2[pending]).astype(np.int64)
        # one item per bucket per round: first occurrence wins
        order = np.argsort(tgt, kind="stable")
        tgt_sorted = tgt[order]
        first = np.ones(len(tgt_sorted), dtype=bool)
        first[1:] = tgt_sorted[1:] != tgt_sorted[:-1]
        winners = pending[order[first]]
        wt = tgt_sorted[first]
        fits = used[wt] < SLOTS
        winners, wt = winners[fits], wt[fits]
        s = used[wt].astype(np.int64)
        slot_idx[wt, s] = winners
        used[wt] += 1
        placed = np.zeros(n, dtype=bool)
        placed[winners] = True
        pending = pending[~placed[pending]]

    # scalar cuckoo for the tail (hashes looked up, never recomputed)
    for i in pending:
        cur = int(i)
        b = int(h1[cur])
        ok = False
        for _kick in range(MAX_KICKS):
            if used[b] < SLOTS:
                slot_idx[b, used[b]] = cur
                used[b] += 1
                ok = True
                break
            s = int(rng.integers(0, SLOTS))
            victim = int(slot_idx[b, s])
            slot_idx[b, s] = cur
            cur = victim
            b = int(h2[cur]) if b == int(h1[cur]) else int(h1[cur])
        if not ok:
            # extremely unlikely at load<=0.85; grow and rebuild
            return build_cuckoo(keys, nodes, offsets, load=load / 2)

    flat = slot_idx.reshape(-1)
    filled = flat >= 0
    safe = np.where(filled, flat, 0)
    slot_key = np.where(filled[:, None], keys[safe], 0).reshape(nb, SLOTS, W)
    slot_node = np.where(filled, nodes[safe].astype(np.uint32), EMPTY).reshape(
        nb, SLOTS, 1
    )
    slot_off = np.where(filled, offsets[safe].astype(np.uint32), 0).reshape(
        nb, SLOTS, 1
    )
    rows = np.concatenate([slot_key, slot_node, slot_off], axis=2).reshape(
        nb, SLOTS * (W + 2)
    )
    return CuckooIndex(buckets=rows.astype(np.uint32), mask=mask, W=W)


def build_cuckoo_fast(
    keys: np.ndarray, nodes: np.ndarray, offsets: np.ndarray, load: float = 0.95
) -> CuckooIndex:
    """Native (C++) cuckoo build with NumPy fallback.

    The probe is placement-invariant (a present key matches in exactly one
    slot of its two buckets, an absent key in none), so any valid placement
    yields bit-identical lookups; the native build is deterministic but not
    slot-identical to `build_cuckoo`.  At 27M keys: ~50s NumPy -> ~2s C++.
    """
    try:
        from .native import cuckoo_native
    except Exception:
        return build_cuckoo(keys, nodes, offsets, load)
    n, W = keys.shape
    need = max(SLOTS * 2, int(np.ceil(n / load / SLOTS)) * SLOTS)
    nb = 1 << max(1, (need // SLOTS - 1).bit_length())
    while True:
        try:
            rows = cuckoo_native(keys, nodes, offsets, nb)
            return CuckooIndex(buckets=rows, mask=nb - 1, W=W)
        except RuntimeError:
            nb *= 2  # placement failed (never seen at load<=0.75); grow
        except Exception as e:
            # build/load failures (no toolchain, stale .so, missing
            # symbol) are NOT RuntimeError and used to crash the default
            # serving path instead of degrading (review r5)
            import logging

            logging.getLogger(__name__).warning(
                "native cuckoo build unavailable (%s); NumPy fallback", e)
            return build_cuckoo(keys, nodes, offsets, load)


def cuckoo_lookup_np(ci: CuckooIndex, queries: np.ndarray):
    """NumPy mirror of the device probe: [n, W] -> (node, offset) or -1."""
    n, W = queries.shape
    node = np.full(n, -1, dtype=np.int64)
    off = np.full(n, -1, dtype=np.int64)
    h1, h2 = _bucket_hashes(queries, ci.mask)
    for h in (h1, h2):
        rows = ci.buckets[h].reshape(n, SLOTS, W + 2)
        for s in range(SLOTS):
            keym = np.all(rows[:, s, :W] == queries, axis=1)
            hit = keym & (rows[:, s, W] != EMPTY) & (node < 0)
            node[hit] = rows[hit, s, W]
            off[hit] = rows[hit, s, W + 1]
    return node, off


# ---------------------------------------------------------------------------
# single-probe bucket table ("bucket1" seed mode)
# ---------------------------------------------------------------------------

B1_SLOTS = 16
B1_SEED = 0x9E37_79B9


def build_bucket1(
    keys: np.ndarray, nodes: np.ndarray, offsets: np.ndarray,
    mean_load: float = 4.0,
):
    """Single-hash bucket table: ONE row gather answers a probe.

    A probe reads all 64 words of the 256B row, where the cuckoo probe
    reads 18; not measured on the H100.  Kept as a tested experimental
    mode (seed_index="bucket1");
    its sort-based build is notably fast (7.4s vs 48.6s cuckoo init at
    52M keys).  Zero overflow by construction: buckets never exceed
    B1_SLOTS — on overflow the build re-salts the hash (4 tries) then
    doubles the table.  Deterministic.

    Returns (rows [nb, B1_SLOTS*(W+2)] uint32, mask, seed).
    """
    n, W = keys.shape
    nb = 1 << max(1, int(max(1, np.ceil(n / mean_load)) - 1).bit_length())
    while True:
        for salt in range(4):
            seed = np.uint32((B1_SEED + 0x85EB_CA6B * salt) & 0xFFFFFFFF)
            h = (hash_kmer_np(keys, seed) & np.uint32(nb - 1)).astype(np.int64)
            order = np.argsort(h, kind="stable")
            hs = h[order]
            first = np.ones(n, dtype=bool)
            first[1:] = hs[1:] != hs[:-1]
            starts = np.nonzero(first)[0]
            lens = np.diff(np.append(starts, n))
            if len(lens) and lens.max() > B1_SLOTS:
                continue
            rank = np.arange(n, dtype=np.int64) - np.repeat(starts, lens)
            rows = np.zeros((nb, B1_SLOTS, W + 2), dtype=np.uint32)
            rows[:, :, W] = EMPTY
            ki = order
            rows[hs, rank, :W] = keys[ki]
            rows[hs, rank, W] = nodes[ki].astype(np.uint32)
            rows[hs, rank, W + 1] = offsets[ki].astype(np.uint32)
            return (
                rows.reshape(nb, B1_SLOTS * (W + 2)),
                nb - 1,
                int(seed),
            )
        nb *= 2


def bucket1_lookup_np(rows, mask, seed, queries: np.ndarray):
    """NumPy mirror of the device single-probe (tests)."""
    n, W = queries.shape
    node = np.full(n, -1, dtype=np.int64)
    off = np.full(n, -1, dtype=np.int64)
    h = (hash_kmer_np(queries, np.uint32(seed)) & np.uint32(mask)).astype(
        np.int64
    )
    r = rows[h].reshape(n, B1_SLOTS, W + 2)
    for s in range(B1_SLOTS):
        keym = np.all(r[:, s, :W] == queries, axis=1)
        hit = keym & (r[:, s, W] != EMPTY) & (node < 0)
        node[hit] = r[hit, s, W]
        off[hit] = r[hit, s, W + 1]
    return node, off
