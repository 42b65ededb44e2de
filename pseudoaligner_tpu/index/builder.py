"""Index construction: transcriptome -> flat IndexImage (host, NumPy).

Re-design of the reference build pipeline
(reference: src/build_index.rs:27-91 plus the [dep] debruijn primitives it
drives — `filter_kmers`, `compress_kmers_with_hash`/`ScmapCompress`,
`compress_graph`, `BaseGraph`; see SURVEY.md section 2.2).

The reference shards super-k-mers by MSP bucket and assembles shards in
parallel purely as a memory/parallelism strategy; the merged + recompressed
graph is invariant to the sharding (each distinct k-mer lands wholly in one
shard, src/build_index.rs:127-151).  This builder therefore computes the
same final graph directly from a global k-mer census, fully vectorized:

1. census: every (kmer, tx, exts) occurrence, sorted by (kmer, tx);
2. per-kmer summarize: union of exts + sorted-deduped tx list, the exact
   semantics of `CountFilterEqClass::summarize` (src/equiv_classes.rs:62-91)
   under MIN_KMERS=1/STRANDED=true/REPORT_ALL_KMER=false (src/config.rs);
3. equivalence-class interning by content (hash + exact verification) —
   ids are assigned deterministically by first appearance in sorted-kmer
   order, unlike the reference's race-order DashMap ids
   (src/equiv_classes.rs:84-90); class *content* is identical;
4. unitig compression with the ScmapCompress join rule — adjacent kmers
   merge iff the extension is unique on both sides and the EC ids are
   equal (src/build_index.rs:171,178 [dep]) — done by pointer doubling
   (O(log n) vector passes), with deterministic cycle breaking;
5. dense edge tables, CSR eq classes, MPHF + slot-ordered values/keys.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from .. import dna
from ..config import U32_MAX
from ..ops.hashing import mix32_np
from .image import IndexImage
from .mphf import build_mphf


@dataclass
class CensusProduct:
    """Stage-A output: per-distinct-kmer summary + join structure.

    Produced either by the vectorized NumPy path (`census_numpy`) or by the
    native C++ builder (`native/`); stage B (`assemble`) is shared.
    """

    kmer_words: np.ndarray  # [nk, W] uint32, sorted ascending
    kmer_exts: np.ndarray  # [nk] uint8
    ec_of_kmer: np.ndarray  # [nk] uint32
    ec_offsets: np.ndarray  # [M+1] uint32
    ec_txs: np.ndarray  # [sum] uint32
    nxt: np.ndarray  # [nk] int64 — ScmapCompress join successor (-1 none),
    #                  self-loops and cycles already broken deterministically

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# word-vector helpers ([n, W] uint32 little-endian words)
# ---------------------------------------------------------------------------


def _shl2_or(words: np.ndarray, base, k: int) -> np.ndarray:
    """(kmer << 2 | base) masked to 2k bits — the right-successor kmer."""
    w = words
    n, W = w.shape
    out = np.empty_like(w)
    out[:, 0] = (w[:, 0] << np.uint32(2)) | np.asarray(base, np.uint32)
    for j in range(1, W):
        out[:, j] = (w[:, j] << np.uint32(2)) | (w[:, j - 1] >> np.uint32(30))
    used = 2 * k - 32 * (W - 1)
    out[:, W - 1] &= np.uint32((1 << used) - 1)
    return out


def _shr2_or_top(words: np.ndarray, base, k: int) -> np.ndarray:
    """(kmer >> 2 | base << 2(k-1)) — the left-predecessor kmer."""
    w = words
    n, W = w.shape
    out = np.empty_like(w)
    for j in range(W - 1):
        out[:, j] = (w[:, j] >> np.uint32(2)) | (w[:, j + 1] << np.uint32(30))
    out[:, W - 1] = w[:, W - 1] >> np.uint32(2)
    hb = 2 * (k - 1)
    tw, ts = hb // 32, hb % 32
    out[:, tw] |= np.asarray(base, np.uint32) << np.uint32(ts)
    return out


def _first_base(words: np.ndarray, k: int) -> np.ndarray:
    hb = 2 * (k - 1)
    tw, ts = hb // 32, hb % 32
    return (words[:, tw] >> np.uint32(ts)) & np.uint32(3)


def _last_base(words: np.ndarray) -> np.ndarray:
    return words[:, 0] & np.uint32(3)


def _lexsort_words(words: np.ndarray, *minor_keys) -> np.ndarray:
    """Sort order by kmer value (primary) then minor keys (in given order)."""
    keys = tuple(reversed(minor_keys)) + tuple(
        words[:, j] for j in range(words.shape[1])
    )
    return np.lexsort(keys)


def vector_lookup(sorted_keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Exact lookup of `queries` in unique `sorted_keys` (both [*, W] words).

    Returns int64 indices into sorted_keys, -1 where absent.  Implemented as
    a sort-merge join (fully vectorized — the host-side analog of the
    device MPHF probe).
    """
    nk, nq = len(sorted_keys), len(queries)
    if nq == 0:
        return np.zeros(0, dtype=np.int64)
    if nk == 0:
        # documented contract: -1 where absent (the fallback's row-0
        # compare below would IndexError on a zero-row table; the
        # native path already handles this — review r5)
        return np.full(nq, -1, dtype=np.int64)
    try:
        from .native import lookup_native

        return lookup_native(sorted_keys, queries)
    except Exception:
        pass
    comb = np.concatenate([sorted_keys, queries], axis=0)
    tag = np.concatenate(
        [np.zeros(nk, dtype=np.uint8), np.ones(nq, dtype=np.uint8)]
    )
    order = _lexsort_words(comb, tag)
    sorted_tag = tag[order]
    is_key = sorted_tag == 0
    key_rank = np.where(is_key, np.cumsum(is_key) - 1, -1)
    last_key = np.maximum.accumulate(key_rank)
    qpos = np.nonzero(~is_key)[0]
    qorig = order[qpos] - nk
    cand = last_key[qpos]
    ok = cand >= 0
    qw = comb[order[qpos]]
    cmp = np.all(sorted_keys[np.maximum(cand, 0)] == qw, axis=1)
    ok &= cmp
    out = np.full(nq, -1, dtype=np.int64)
    out[qorig[ok]] = cand[ok]
    return out


# ---------------------------------------------------------------------------
# census
# ---------------------------------------------------------------------------


def _census(seqs: list[np.ndarray], k: int):
    """All (kmer, tx, ext) occurrences across the transcriptome.

    Equivalent of the MSP partition + filter_kmers input assembly
    (reference: src/build_index.rs:44-48,127-151,157-170): an occurrence's
    exts are its in-transcript neighbors (slice flank exts reconstruct
    exactly this, see SURVEY.md section 7.2 note).
    """
    W = dna.kmer_words(k)
    words_parts, tx_parts, ext_parts = [], [], []
    for tx_id, codes in enumerate(seqs):
        n = len(codes)
        if n < k:
            continue
        num = n - k + 1
        kw = dna.pack_kmers(codes, k)
        ext = np.zeros(num, dtype=np.uint8)
        c = codes.astype(np.uint8)
        # left neighbor exists for occurrences 1..num-1
        ext[1:] |= np.uint8(1) << (c[:num - 1] + np.uint8(4))
        # right neighbor exists for occurrences 0..num-2
        ext[: num - 1] |= np.uint8(1) << c[k:]
        words_parts.append(kw)
        tx_parts.append(np.full(num, tx_id, dtype=np.uint32))
        ext_parts.append(ext)
    if not words_parts:
        return (
            np.zeros((0, W), np.uint32),
            np.zeros(0, np.uint32),
            np.zeros(0, np.uint8),
        )
    return (
        np.concatenate(words_parts),
        np.concatenate(tx_parts),
        np.concatenate(ext_parts),
    )


# ---------------------------------------------------------------------------
# equivalence-class interning
# ---------------------------------------------------------------------------


def _intern_eq_classes(pair_gid: np.ndarray, pair_tx: np.ndarray, n_groups: int):
    """Intern per-kmer tx lists into dense EC ids.

    pair_gid/pair_tx: deduped (kmer-group, tx) pairs, sorted by (gid, tx) —
    each gid's slice is its sorted tx list.  Returns (ec_of_group [n_groups],
    ec_offsets, ec_txs) with EC ids ordered by first appearance in gid order.

    Equivalent of CountFilterEqClass's DashMap interner
    (src/equiv_classes.rs:16-57,84-90) with deterministic id assignment.
    """
    total = len(pair_gid)
    group_start = np.searchsorted(pair_gid, np.arange(n_groups), side="left")
    group_len = np.diff(np.append(group_start, total)).astype(np.int64)

    # content hash per group: order-independent-enough (lists are sorted, so
    # use order-dependent mixing via position for extra strength)
    pos_in_group = np.arange(total, dtype=np.uint32) - np.repeat(
        group_start.astype(np.uint32), group_len
    )
    m1 = mix32_np(pair_tx * np.uint32(0x9E3779B9) ^ (pos_in_group + np.uint32(1)))
    m2 = mix32_np(pair_tx ^ np.uint32(0x85EBCA6B) ^ (pos_in_group * np.uint32(0xC2B2AE35)))
    with np.errstate(over="ignore"):
        h1 = np.add.reduceat(m1, group_start) if total else np.zeros(0, np.uint32)
        h2 = np.bitwise_xor.reduceat(m2, group_start) if total else np.zeros(0, np.uint32)
    sig = np.empty(n_groups, dtype=[("h1", "u4"), ("h2", "u4"), ("len", "i8")])
    sig["h1"], sig["h2"], sig["len"] = h1, h2, group_len

    _, rep_first, inverse = np.unique(sig, return_index=True, return_inverse=True)
    # exact verification: every group must equal its representative's content
    rep_of_group = rep_first[inverse]
    rep_start_rep = np.repeat(group_start[rep_of_group], group_len)
    same = pair_tx == pair_tx[rep_start_rep + pos_in_group.astype(np.int64)]
    if not same.all():
        raise RuntimeError("EC hash collision detected — interning aborted")

    # relabel classes by first appearance (ascending rep group index)
    order = np.argsort(rep_first, kind="stable")
    relabel = np.empty_like(order)
    relabel[order] = np.arange(len(order))
    ec_of_group = relabel[inverse].astype(np.uint32)

    reps_sorted = rep_first[order]
    ec_lens = group_len[reps_sorted]
    ec_offsets = np.zeros(len(order) + 1, dtype=np.uint32)
    ec_offsets[1:] = np.cumsum(ec_lens).astype(np.uint32)
    # vectorized CSR-row gather (repeat-starts + arange-offsets, same
    # pattern as census_sharded's merge): the per-class slice list
    # built millions of Python slice objects at transcriptome scale
    # (review r5)
    total_ec = int(ec_lens.sum())
    if total_ec:
        src = np.repeat(
            group_start[reps_sorted] - ec_offsets[:-1].astype(np.int64),
            ec_lens,
        ) + np.arange(total_ec, dtype=np.int64)
        ec_txs = pair_tx[src]
    else:
        ec_txs = np.zeros(0, np.uint32)
    return ec_of_group, ec_offsets, ec_txs.astype(np.uint32)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def build_index(
    seqs: list[np.ndarray],
    tx_names: list[str],
    tx_gene_map: dict[str, str],
    k: int = 20,
    native: str = "auto",
    n_threads: int | None = None,
) -> IndexImage:
    """Build the full index image.  See module docstring.

    Equivalent of `build_index` (reference: src/build_index.rs:27-91).
    native: "auto" (use the C++ census when the library is available),
    "never", or "require".
    """
    if len(seqs) >= U32_MAX:
        raise ValueError(f"Too many ({len(seqs)}) sequences to handle.")

    census = None
    graph = None
    if native in ("auto", "require"):
        try:
            from .native import census_native, graph_native_k

            census = census_native(seqs, k, n_threads=n_threads)
            log.info("native census: %d distinct k-mers", len(census.kmer_exts))
            graph = graph_native_k(census, k)
            log.info("native graph: %d nodes", len(graph["node_len"]))
        except Exception as e:  # pragma: no cover - environment dependent
            if native == "require":
                raise
            log.info("native builder unavailable (%s); using NumPy path", e)
    if census is None:
        census = census_numpy(seqs, k)
    if graph is not None:
        return assemble_native(census, graph, k, tx_names, tx_gene_map)
    return assemble(census, k, tx_names, tx_gene_map)


def assemble_native(
    census: CensusProduct,
    graph: dict,
    k: int,
    tx_names: list[str],
    tx_gene_map: dict[str, str],
) -> IndexImage:
    """Stage B when the native builder supplied the graph arrays: only the
    MPHF build + slot scatter remain on the NumPy side."""
    W = dna.kmer_words(k)
    nk = len(census.kmer_exts)
    log.info("building MPHF over %d k-mers", nk)
    mphf, slot_of_key = build_mphf(census.kmer_words, gamma=1.7)
    kmer_node = np.zeros(nk, dtype=np.uint32)
    kmer_offset = np.zeros(nk, dtype=np.uint32)
    kmer_keys = np.zeros((nk, W), dtype=np.uint32)
    kmer_node[slot_of_key] = graph["kmer_node"]
    kmer_offset[slot_of_key] = graph["kmer_offset"]
    kmer_keys[slot_of_key] = census.kmer_words
    if len(graph["seq_pool"]) >= U32_MAX:
        # same uint32 node_start ceiling as the NumPy path (review r5)
        raise ValueError(
            f"sequence pool has {len(graph['seq_pool'])} bases; uint32 "
            f"node_start supports < {U32_MAX}"
        )
    return IndexImage(
        k=k,
        node_start=graph["node_start"],
        node_len=graph["node_len"],
        node_exts=graph["node_exts"],
        node_ec=graph["node_ec"],
        seq_pool=graph["seq_pool"],
        l_edge=graph["l_edge"],
        r_edge=graph["r_edge"],
        ec_offsets=census.ec_offsets,
        ec_txs=census.ec_txs,
        mphf=mphf,
        kmer_node=kmer_node,
        kmer_offset=kmer_offset,
        kmer_keys=kmer_keys,
        tx_names=list(tx_names),
        tx_gene_mapping=dict(tx_gene_map),
    )


def _summarize_occurrences(ow, ot, oe):
    """Collapse (kmer, tx, ext) occurrence arrays to per-kmer summaries.

    Returns (kmer_words, kmer_exts, pair_gid, pair_tx): distinct k-mers
    in lexsorted order, OR-folded exts, and the deduplicated (kmer, tx)
    pairs (gid = index into the distinct-kmer order).  The ONE summarize
    core shared by census_numpy (globally) and census_sharded (per
    shard) — the paths are required to stay bit-identical, so the
    sort/boundary/reduceat/keep sequence must not fork (review r5)."""
    order = _lexsort_words(ow, ot)
    sw, st, se = ow[order], ot[order], oe[order]
    new_kmer = np.ones(len(sw), dtype=bool)
    new_kmer[1:] = np.any(sw[1:] != sw[:-1], axis=1)
    starts = np.nonzero(new_kmer)[0]
    gid = np.cumsum(new_kmer) - 1  # kmer-group id per occurrence
    keep = new_kmer.copy()
    keep[1:] |= st[1:] != st[:-1]
    return sw[starts], np.bitwise_or.reduceat(se, starts), gid[keep], st[keep]


def census_numpy(seqs: list[np.ndarray], k: int) -> CensusProduct:
    """Stage A, vectorized NumPy implementation."""

    log.info("k-mer census over %d sequences", len(seqs))
    occ_words, occ_tx, occ_ext = _census(seqs, k)
    n_occ = len(occ_tx)
    log.info("census: %d occurrences", n_occ)

    if n_occ == 0:
        raise ValueError("no k-mers: all sequences shorter than k")

    kmer_words_arr, kmer_exts, pair_gid, pair_tx = _summarize_occurrences(
        occ_words, occ_tx, occ_ext
    )
    nk = len(kmer_words_arr)

    log.info("%d distinct k-mers; interning equivalence classes", nk)
    ec_of_kmer, ec_offsets, ec_txs = _intern_eq_classes(pair_gid, pair_tx, nk)
    n_ecs = len(ec_offsets) - 1
    log.info("%d equivalence classes", n_ecs)

    nxt = _join_successors(kmer_words_arr, kmer_exts, ec_of_kmer, k)

    return CensusProduct(
        kmer_words=kmer_words_arr,
        kmer_exts=kmer_exts.astype(np.uint8),
        ec_of_kmer=ec_of_kmer,
        ec_offsets=ec_offsets,
        ec_txs=ec_txs,
        nxt=nxt,
    )


def _join_successors(kmer_words_arr, kmer_exts, ec_of_kmer, k):
    """ScmapCompress join successors with self-loops/cycles broken
    (see module docstring point 4)."""
    nk = len(kmer_exts)
    log.info("compressing unitigs")
    rext = kmer_exts & np.uint8(0x0F)
    lext = kmer_exts >> np.uint8(4)
    popc4 = np.array([bin(i).count("1") for i in range(16)], dtype=np.uint8)
    base4 = np.array([-1, 0, 1, -1, 2, -1, -1, -1, 3, -1, -1, -1, -1, -1, -1, -1],
                     dtype=np.int8)  # unique-bit -> base
    r_unique = popc4[rext] == 1
    l_unique = popc4[lext] == 1
    r_base = base4[rext]  # valid only where r_unique
    l_base = base4[lext]

    nxt = np.full(nk, -1, dtype=np.int64)
    src = np.nonzero(r_unique)[0]
    if len(src):
        succ_words = _shl2_or(kmer_words_arr[src], r_base[src].astype(np.uint32), k)
        succ_idx = vector_lookup(kmer_words_arr, succ_words)
        # every observed extension's target k-mer exists in the census
        assert (succ_idx >= 0).all(), "dangling right extension"
        ok = (
            l_unique[succ_idx]
            & (l_base[succ_idx].astype(np.uint32) == _first_base(kmer_words_arr[src], k))
            & (ec_of_kmer[src] == ec_of_kmer[succ_idx])
        )
        nxt[src[ok]] = succ_idx[ok]

    # break self-loops, then longer cycles (deterministically at cycle min)
    self_loop = nxt == np.arange(nk)
    nxt[self_loop] = -1

    prv = np.full(nk, -1, dtype=np.int64)
    has_nxt = nxt >= 0
    prv[nxt[has_nxt]] = np.nonzero(has_nxt)[0]

    # cycle detection via pointer doubling on prv
    steps = max(1, int(np.ceil(np.log2(max(nk, 2)))) + 1)
    up = np.where(prv >= 0, prv, np.arange(nk))
    for _ in range(steps):
        up = up[up]
    in_cycle = prv[up] >= 0  # head never reached
    if in_cycle.any():
        cyc = np.nonzero(in_cycle)[0]
        # min over each cycle via jump-doubling min-propagation
        m = cyc.copy()
        jump = nxt[cyc]
        pos_in_cyc = np.full(nk, -1, dtype=np.int64)
        pos_in_cyc[cyc] = np.arange(len(cyc))
        jmp = pos_in_cyc[jump]
        for _ in range(steps):
            m = np.minimum(m, m[jmp])
            jmp = jmp[jmp]
        # break the edge entering each cycle's min element: x -> m becomes
        # no-edge, making m the chain head (deterministic decomposition; the
        # reference's cycle rotation is likewise arbitrary, see SURVEY.md
        # section 7.2 point on canonical ids)
        brk = cyc[nxt[cyc] == m]  # the unique x per cycle with nxt[x] == min
        nxt[brk] = -1

    return nxt


def census_sharded(seqs: list[np.ndarray], k: int) -> CensusProduct:
    """Stage A via the reference's MSP shard decomposition — the unit of
    the distributed build (reference: src/build_index.rs:44-71; SURVEY.md
    section 2.3 "Sharding").  Super-k-mers are bucketed by minimizer,
    buckets grouped into shards (`group_by_slices`), each shard summarized
    independently (a distinct k-mer lands wholly in one shard), and shard
    summaries merged.  Produces a CensusProduct bit-identical to the
    global paths — each shard's summary can equally be computed on a
    different host."""
    from ..config import MIN_SHARD_SEQUENCES
    from .msp import group_by_slices, partition_contigs


    # per-contig occurrence exts (identical to the flank+interior union)
    runs = []  # (bucket, tx, start, end)
    for tx, codes in enumerate(seqs):
        for b, _, (s0, e0), _ in partition_contigs(codes, tx, k):
            runs.append((b, tx, s0, e0))
    runs.sort(key=lambda r: r[0])
    if not runs:
        # same explicit error as census_numpy (the empty concatenate
        # below would raise an opaque ValueError instead — review r5)
        raise ValueError("no k-mers: all sequences shorter than k")
    shards = group_by_slices(runs, lambda r: r[0], MIN_SHARD_SEQUENCES)
    log.info("sharded census: %d super-kmer runs in %d shards",
             len(runs), len(shards))

    sh_words, sh_exts, sh_ptx, sh_plen = [], [], [], []
    for shard in shards:
        w_parts, t_parts, e_parts = [], [], []
        for b, tx, s0, e0 in shard:
            codes = seqs[tx]
            num = e0 - s0 - k + 1
            kw = dna.pack_kmers(codes[s0:e0], k)
            ext = np.zeros(num, dtype=np.uint8)
            # no copy on the standard uint8 path: the astype ran once
            # per super-k-mer RUN (~len/30 full-sequence copies per
            # transcript — review r5)
            c = codes if codes.dtype == np.uint8 else codes.astype(np.uint8)
            # occurrence exts come from the FULL contig neighborhood
            pos = np.arange(s0, s0 + num)
            has_l = pos > 0
            ext[has_l] |= np.uint8(1) << (c[pos[has_l] - 1] + np.uint8(4))
            has_r = pos + k < len(codes)
            ext[has_r] |= np.uint8(1) << c[pos[has_r] + k]
            w_parts.append(kw)
            t_parts.append(np.full(num, tx, dtype=np.uint32))
            e_parts.append(ext)
        kwords, kexts, pair_gid, pair_tx = _summarize_occurrences(
            np.concatenate(w_parts),
            np.concatenate(t_parts),
            np.concatenate(e_parts),
        )
        sh_words.append(kwords)
        sh_exts.append(kexts)
        sh_ptx.append(pair_tx)
        counts = np.bincount(pair_gid, minlength=len(kwords))
        sh_plen.append(counts.astype(np.int64))

    # merge shard summaries: distinct k-mers are shard-exclusive
    all_words = np.concatenate(sh_words)
    all_exts = np.concatenate(sh_exts)
    all_plen = np.concatenate(sh_plen)
    all_ptx = np.concatenate(sh_ptx)
    nk = len(all_words)
    order = _lexsort_words(all_words)
    kmer_words_arr = all_words[order]
    kmer_exts = all_exts[order]

    # reorder the variable-length tx lists to the merged kmer order
    starts_in = np.zeros(nk, dtype=np.int64)
    np.cumsum(all_plen[:-1], out=starts_in[1:])
    lens_o = all_plen[order]
    total = int(all_plen.sum())
    src = np.repeat(starts_in[order], lens_o) + (
        np.arange(total) - np.repeat(np.concatenate([[0], np.cumsum(lens_o[:-1])]),
                                     lens_o)
    )
    pair_tx = all_ptx[src]
    pair_gid = np.repeat(np.arange(nk), lens_o)

    ec_of_kmer, ec_offsets, ec_txs = _intern_eq_classes(pair_gid, pair_tx, nk)
    nxt = _join_successors(kmer_words_arr, kmer_exts, ec_of_kmer, k)
    return CensusProduct(
        kmer_words=kmer_words_arr,
        kmer_exts=kmer_exts.astype(np.uint8),
        ec_of_kmer=ec_of_kmer,
        ec_offsets=ec_offsets,
        ec_txs=ec_txs,
        nxt=nxt,
    )


def assemble(
    census: CensusProduct,
    k: int,
    tx_names: list[str],
    tx_gene_map: dict[str, str],
) -> IndexImage:
    """Stage B: chains -> nodes, sequence pool, edge tables, MPHF."""
    W = dna.kmer_words(k)
    kmer_words_arr = census.kmer_words
    kmer_exts = census.kmer_exts
    ec_of_kmer = census.ec_of_kmer
    ec_offsets = census.ec_offsets
    ec_txs = census.ec_txs
    nxt = census.nxt
    nk = len(kmer_exts)
    steps = max(1, int(np.ceil(np.log2(max(nk, 2)))) + 1)

    prv = np.full(nk, -1, dtype=np.int64)
    has_nxt = nxt >= 0
    prv[nxt[has_nxt]] = np.nonzero(has_nxt)[0]

    # chain head + position via pointer doubling
    up = np.where(prv >= 0, prv, np.arange(nk))
    dist = (prv >= 0).astype(np.int64)
    for _ in range(steps):
        dist = dist + dist[up]
        up = up[up]
    head = up

    heads_mask = prv < 0
    heads = np.nonzero(heads_mask)[0]
    n_nodes = len(heads)
    node_rank = np.full(nk, -1, dtype=np.int64)
    node_rank[heads] = np.arange(n_nodes)
    node_of = node_rank[head]
    assert (node_of >= 0).all()

    len_kmers = np.bincount(node_of, minlength=n_nodes).astype(np.int64)
    node_len = (len_kmers + k - 1).astype(np.uint32)
    node_start = np.zeros(n_nodes, dtype=np.int64)
    if n_nodes > 1:
        node_start[1:] = np.cumsum(node_len[:-1].astype(np.int64))
    total_bases = int(node_len.astype(np.int64).sum())
    if total_bases >= U32_MAX:
        # node_start is stored uint32 (IndexImage contract): a >=4.29G-
        # base pool would wrap the offsets and gather windows from wrong
        # positions — silent corruption; fail loud instead (review r5)
        raise ValueError(
            f"sequence pool has {total_bases} bases; uint32 node_start "
            f"supports < {U32_MAX}"
        )

    log.info("%d unitig nodes, %d pool bases", n_nodes, total_bases)

    # sequence pool
    seq_pool = np.zeros(total_bases, dtype=np.uint8)
    hw = kmer_words_arr[heads]
    for i in range(k):
        bitpos = 2 * (k - 1 - i)
        word, shift = bitpos // 32, bitpos % 32
        seq_pool[node_start.astype(np.int64) + i] = (
            (hw[:, word] >> np.uint32(shift)) & np.uint32(3)
        ).astype(np.uint8)
    non_head = np.nonzero(~heads_mask)[0]
    if len(non_head):
        pos = node_start.astype(np.int64)[node_of[non_head]] + k - 1 + dist[non_head]
        seq_pool[pos] = _last_base(kmer_words_arr[non_head]).astype(np.uint8)

    # tails
    tail_of_node = np.full(n_nodes, -1, dtype=np.int64)
    is_tail = dist == len_kmers[node_of] - 1
    tail_of_node[node_of[is_tail]] = np.nonzero(is_tail)[0]
    assert (tail_of_node >= 0).all()

    node_exts = ((kmer_exts[heads] & np.uint8(0xF0)) | (kmer_exts[tail_of_node] & np.uint8(0x0F)))
    node_ec = ec_of_kmer[heads].astype(np.uint32)

    # edge tables
    l_edge = np.full((n_nodes, 4), -1, dtype=np.int32)
    r_edge = np.full((n_nodes, 4), -1, dtype=np.int32)
    tails_w = kmer_words_arr[tail_of_node]
    heads_w = kmer_words_arr[heads]
    t_rext = kmer_exts[tail_of_node] & np.uint8(0x0F)
    h_lext = kmer_exts[heads] >> np.uint8(4)
    for b in range(4):
        mask = (t_rext >> np.uint8(b)) & np.uint8(1) == 1
        if mask.any():
            tgt = _shl2_or(tails_w[mask], np.uint32(b), k)
            idx = vector_lookup(kmer_words_arr, tgt)
            assert (idx >= 0).all()
            assert (dist[idx] == 0).all(), "right edge target must be a node head"
            r_edge[np.nonzero(mask)[0], b] = node_of[idx].astype(np.int32)
        mask = (h_lext >> np.uint8(b)) & np.uint8(1) == 1
        if mask.any():
            tgt = _shr2_or_top(heads_w[mask], np.uint32(b), k)
            idx = vector_lookup(kmer_words_arr, tgt)
            assert (idx >= 0).all()
            assert (dist[idx] == len_kmers[node_of[idx]] - 1).all(), (
                "left edge target must be a node tail"
            )
            l_edge[np.nonzero(mask)[0], b] = node_of[idx].astype(np.int32)

    # --- MPHF over all distinct kmers, values = (node, offset) ---
    log.info("building MPHF over %d k-mers", nk)
    mphf, slot_of_key = build_mphf(kmer_words_arr, gamma=1.7)
    kmer_node = np.zeros(nk, dtype=np.uint32)
    kmer_offset = np.zeros(nk, dtype=np.uint32)
    kmer_keys = np.zeros((nk, W), dtype=np.uint32)
    kmer_node[slot_of_key] = node_of.astype(np.uint32)
    kmer_offset[slot_of_key] = dist.astype(np.uint32)
    kmer_keys[slot_of_key] = kmer_words_arr

    return IndexImage(
        k=k,
        node_start=node_start.astype(np.uint32),
        node_len=node_len,
        node_exts=node_exts.astype(np.uint8),
        node_ec=node_ec,
        seq_pool=seq_pool,
        l_edge=l_edge,
        r_edge=r_edge,
        ec_offsets=ec_offsets,
        ec_txs=ec_txs,
        mphf=mphf,
        kmer_node=kmer_node,
        kmer_offset=kmer_offset,
        kmer_keys=kmer_keys,
        tx_names=list(tx_names),
        tx_gene_mapping=dict(tx_gene_map),
    )
