"""K-mer-partitioned index mode: sharded lookup with all-to-all exchange.

BASELINE config 5.  The k-mer index (MPHF bitvectors + slot-ordered keys
and values — the dominant memory component at transcriptome scale) is
partitioned across the mesh by a hash of the k-mer; each device holds one
sub-index plus the (much smaller) replicated graph.  Mapping a read batch:

1. every device packs its read shard's [b, P] k-mers and computes each
   k-mer's owner shard (`hash & (S-1)`);
2. queries are bucketed by owner into fixed-capacity send buffers and
   exchanged with `jax.lax.all_to_all` (NCCL over NVLink between GPUs; the
   EP-shaped dispatch of
   SURVEY.md section 2.3);
3. each device probes its local sub-MPHF (per-shard level metadata lives
   in device arrays — ops/mphf_lookup.mphf_probe_dynamic — since shards'
   level structures differ) and verifies against its local keys;
4. results return via a second all-to-all and are scattered back into the
   [b, P] seed tables; the walk + EC stages then run exactly as in the
   replicated mode (ops/map_kernel.map_batch_with_seeds).

Send buffers have capacity `slack * ceil(bP/S)` per destination; the hash
distributes near-uniformly so overflow is vanishingly rare — it is
reported per batch (`overflow` output) so the host can re-run an affected
batch through the replicated path.  The reference has no counterpart
(single-process; SURVEY.md section 2.3): this layer is what lets the index
scale beyond one chip's HBM.
"""

from __future__ import annotations

from dataclasses import dataclass

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import AlignerConfig
from ..index.image import IndexImage
from ..index.mphf import build_mphf
from ..ops.hashing import hash_kmer_jnp, hash_kmer_np
from ..ops.kmers import all_kmers
from ..ops.map_kernel import (
    DeviceIndex,
    MapMeta,
    MapResult,
    device_index_from_image,
    exact_meta,
    lens_link_dtype,
    map_batch_with_seeds,
    next_hit_table,
    pack_reads_host,
    unpack_reads,
)
from ..ops.mphf_lookup import mphf_probe_dynamic
from .mesh import READS_AXIS, tx_compat_counts

OWNER_SEED = 0xA5A5_5A5A


class ShardedLookup(NamedTuple):
    """Stacked per-shard sub-index arrays; axis 0 is the mesh axis."""

    bits: jnp.ndarray  # [S, max_bits_words] uint32
    ranks: jnp.ndarray  # [S, max_bits_words] uint32
    seeds: jnp.ndarray  # [S, n_levels] uint32
    masks: jnp.ndarray  # [S, n_levels] uint32
    word_offsets: jnp.ndarray  # [S, n_levels] int32
    key_offsets: jnp.ndarray  # [S, n_levels] int32
    keys: jnp.ndarray  # [S, max_keys, W] uint32
    values: jnp.ndarray  # [S, max_keys, 2] int32 (node, offset)


@dataclass(frozen=True)
class KPartMeta:
    n_shards: int
    n_levels: int
    cap: int  # per-destination send capacity
    node_block: int = 0  # nodes per graph shard (0 = graph replicated)


class GraphShards(NamedTuple):
    """Graph arrays partitioned by contiguous node-id blocks; axis 0 is the
    mesh axis.  Each shard holds its block's node rows (start column
    rebased to the shard-local pool slice) and packed pool rows."""

    node_rows: jnp.ndarray  # [S, Nb, 12] int32
    pools: jnp.ndarray  # [S, Rmax, 8] uint32


def build_sharded_graph(image: IndexImage, meta: MapMeta, n_shards: int):
    """Partition node rows + sequence pool into contiguous node blocks.

    The node-id space is split into S equal blocks; block s owns nodes
    [s*Nb, (s+1)*Nb) and the pool bases their sequences span.  The layout
    relies on node_start being nondecreasing in node id (both builders
    emit nodes in that order).  Returns (GraphShards, node_block)."""
    from ..ops.map_kernel import _pack_pool_rows

    N = image.n_nodes
    S = n_shards
    Nb = (N + S - 1) // S
    starts = image.node_start.astype(np.int64)
    lens_ = image.node_len.astype(np.int64)
    # the real invariant the block slicing relies on: the pool is a strict
    # contiguous concatenation of node sequences, so each block's slice
    # [starts[lo], starts[hi-1]+lens[hi-1]) covers EVERY member's span
    # (nondecreasing starts alone would allow an earlier node to extend
    # past the slice end and silently read a truncated window)
    # explicit raise, not assert: python -O would strip the check and
    # let a non-contiguous pool silently map against truncated windows
    if not np.all(starts[1:] == starts[:-1] + lens_[:-1]):
        raise ValueError(
            "seq_pool must be the contiguous concatenation of node "
            "sequences"
        )
    pool_pad = meta.pool_pad

    node_blocks, pool_blocks = [], []
    for s in range(S):
        lo, hi = s * Nb, min(N, (s + 1) * Nb)
        nr = np.zeros((Nb, 12), dtype=np.int32)
        if lo < hi:
            base = starts[lo]
            end = starts[hi - 1] + lens_[hi - 1]
            pool_blocks.append(
                _pack_pool_rows(image.seq_pool[base:end], pool_pad,
                                pool_pad, stride=meta.pool_stride)
            )
            n = hi - lo
            nr[:n, 0] = (starts[lo:hi] - base + pool_pad).astype(np.int32)
            nr[:n, 1] = image.node_len[lo:hi]
            nr[:n, 2] = image.node_exts[lo:hi]
            nr[:n, 3] = image.node_ec[lo:hi]
            # column order must match device_index_from_image's node_row
            # (r_edge at 4:8 — the forward walk's contiguous prefix)
            nr[:n, 4:8] = image.r_edge[lo:hi]
            nr[:n, 8:12] = image.l_edge[lo:hi]
        else:
            pool_blocks.append(
                _pack_pool_rows(np.zeros(0, np.uint8), pool_pad,
                                pool_pad, stride=meta.pool_stride)
            )
        node_blocks.append(nr)

    rmax = max(p.shape[0] for p in pool_blocks)
    pools = np.zeros((S, rmax, 8), dtype=np.uint32)
    for s, p in enumerate(pool_blocks):
        pools[s, : p.shape[0]] = p
    return GraphShards(np.stack(node_blocks), pools), Nb


def _routed_fetch_factory(meta: MapMeta, node_rows, pools, axis: str,
                          S: int, node_block: int):
    """Walk-loop graph access for the sharded graph: one all_to_all
    round-trip per fetch.

    Each lane sends (node, delta) to the node's owner shard — slot = lane
    id, so buffers are overflow-free by construction (a lane sends at most
    one request).  The owner gathers the node row from its local block and
    extracts the compare window from its local pool slice (the window is
    computed owner-side because only the owner knows node_start), then the
    response rides a second all_to_all home.  This is the "move the
    computation to the data" alternative to replicating the graph, and is
    what lets graph+pool HBM scale with the mesh (SURVEY.md §7.3 item 6).
    """
    from ..ops.map_kernel import _extract_pool_window_rows

    def fetch(node, delta, want_win):
        B = node.shape[0]
        me = jax.lax.axis_index(axis)
        n = jnp.clip(node, 0, None)
        owner = jnp.minimum(n // node_block, S - 1).astype(jnp.int32)
        lane = jnp.arange(B)
        d = jnp.broadcast_to(jnp.asarray(delta, dtype=jnp.int32), n.shape)
        req = jnp.stack([n, d], axis=-1)
        send = jnp.zeros((S, B, 2), jnp.int32)
        send = send.at[owner, lane].set(req)
        recv = jax.lax.all_to_all(send, axis, 0, 0, tiled=True)  # [S, B, 2]
        rn = recv[..., 0].reshape(S * B)
        rd = recv[..., 1].reshape(S * B)
        ln = jnp.clip(rn - me * node_block, 0, node_rows.shape[0] - 1)
        nrow = jnp.take(node_rows, ln, axis=0)  # [S*B, 12]
        if want_win:
            q = jnp.clip(nrow[:, 0] + rd, 0, None)
            win = _extract_pool_window_rows(meta, pools, q)
            resp = jnp.concatenate(
                [nrow, jax.lax.bitcast_convert_type(win, jnp.int32)], axis=-1
            )
        else:
            resp = nrow
        back = jax.lax.all_to_all(
            resp.reshape(S, B, -1), axis, 0, 0, tiled=True
        )
        mine = back[owner, lane]  # [B, 12(+cmp_words)]
        out_row = mine[:, :12]
        out_win = (
            jax.lax.bitcast_convert_type(mine[:, 12:], jnp.uint32)
            if want_win
            else None
        )
        return out_row, out_win

    return fetch


def build_sharded_lookup(image: IndexImage, n_shards: int):
    """Partition the k-mer index by owner hash; build per-shard sub-MPHFs."""
    keys = image.kmer_keys
    owner = hash_kmer_np(keys, OWNER_SEED) & np.uint32(n_shards - 1)
    W = keys.shape[1]

    shard_data = []
    for s in range(n_shards):
        sel = np.nonzero(owner == s)[0]
        skeys = keys[sel]
        mphf, slot_of_key = build_mphf(skeys) if len(sel) else (None, None)
        values = np.zeros((max(1, len(sel)), 2), dtype=np.int32)
        ordered_keys = np.zeros((max(1, len(sel)), W), dtype=np.uint32)
        if len(sel):
            values[slot_of_key, 0] = image.kmer_node[sel].astype(np.int32)
            values[slot_of_key, 1] = image.kmer_offset[sel].astype(np.int32)
            ordered_keys[slot_of_key] = skeys
        shard_data.append((mphf, ordered_keys, values))

    n_levels = max(
        (m.n_levels for m, _, _ in shard_data if m is not None), default=1
    )
    max_keys = max(k.shape[0] for _, k, _ in shard_data)
    max_words = max(
        (len(m.bits) for m, _, _ in shard_data if m is not None), default=0
    ) + 1  # +1 zero word as the never-hit target for padded levels

    S = n_shards
    bits = np.zeros((S, max_words), dtype=np.uint32)
    ranks = np.zeros((S, max_words), dtype=np.uint32)
    seeds = np.zeros((S, n_levels), dtype=np.uint32)
    masks = np.zeros((S, n_levels), dtype=np.uint32)
    word_offsets = np.full((S, n_levels), max_words - 1, dtype=np.int32)
    key_offsets = np.zeros((S, n_levels), dtype=np.int32)
    keyarr = np.zeros((S, max_keys, W), dtype=np.uint32)
    valarr = np.zeros((S, max_keys, 2), dtype=np.int32)

    for s, (m, okeys, vals) in enumerate(shard_data):
        keyarr[s, : okeys.shape[0]] = okeys
        valarr[s, : vals.shape[0]] = vals
        if m is None:
            continue
        nl = m.n_levels
        bits[s, : len(m.bits)] = m.bits
        ranks[s, : len(m.ranks)] = m.ranks
        seeds[s, :nl] = m.seeds
        masks[s, :nl] = m.masks
        word_offsets[s, :nl] = m.word_offsets.astype(np.int32)
        key_offsets[s, :nl] = m.key_offsets.astype(np.int32)

    return (
        ShardedLookup(bits, ranks, seeds, masks, word_offsets, key_offsets,
                      keyarr, valarr),
        n_levels,
    )


def _routed_seed_tables(
    meta: MapMeta,
    kmeta: KPartMeta,
    lookup: ShardedLookup,
    reads,
    lens,
    axis: str,
):
    """All-position seed tables via all-to-all routed sub-index probes.

    Runs inside shard_map: `lookup` fields are the LOCAL shard's blocks
    (leading axis of size 1)."""
    B, L = reads.shape
    P_ = meta.n_positions
    S, CAP = kmeta.n_shards, kmeta.cap
    W = lookup.keys.shape[-1]

    kmers = all_kmers(reads, meta.k)  # [B, P, W]
    flat = kmers.reshape(B * P_, W)
    n = B * P_
    owner = (hash_kmer_jnp(flat, jnp.uint32(OWNER_SEED)) & jnp.uint32(S - 1)).astype(
        jnp.int32
    )
    # route only VALID positions: zero-padded read tails all produce the
    # IDENTICAL poly-A k-mer, which hashes to ONE owner — without this
    # mask a short-read batch skews ~P-L positions per lane onto a single
    # destination and overflows its CAP bucket.  Invalid positions take
    # owner S (no destination -> the scatter's dump slot); their table
    # entries stay -1, exactly what next_hit_table expects for them.
    pos_grid = jnp.arange(P_, dtype=jnp.int32)[None, :]
    valid = (pos_grid <= (lens[:, None] - meta.k)).reshape(n)
    owner = jnp.where(valid, owner, jnp.int32(S))

    # bucket queries by owner: stable sort by owner, then position within
    # bucket = rank among same-owner entries
    order = jnp.argsort(owner, stable=True)
    owner_sorted = owner[order]
    pos_in_bucket = jnp.arange(n, dtype=jnp.int32) - jnp.searchsorted(
        owner_sorted, owner_sorted, side="left"
    ).astype(jnp.int32)
    dropped_sorted = (pos_in_bucket >= CAP) & (owner_sorted < S)
    overflow = jnp.sum(dropped_sorted.astype(jnp.int32))
    # per-lane dropped mask: lanes with any un-routed valid k-mer take
    # the -3 exact-fallback channel (compact mode) instead of a batch
    # error — routing overflow degrades to a host re-map of those rows
    dropped_flat = jnp.zeros(n, bool).at[order].set(dropped_sorted)
    dropped_lane = jnp.any(dropped_flat.reshape(B, P_), axis=1)

    # fixed-capacity per-destination buffers with a dump slot (index CAP)
    # for overflow entries, so every scatter target is unique
    send_q = jnp.zeros((S, CAP + 1, W), dtype=jnp.uint32)
    send_src = jnp.full((S, CAP + 1), -1, dtype=jnp.int32)  # local flat position
    ok = pos_in_bucket < CAP
    dst = owner_sorted
    slot = jnp.where(ok, pos_in_bucket, CAP)
    send_q = send_q.at[dst, slot].set(flat[order])
    send_src = send_src.at[dst, slot].set(jnp.where(ok, order, -1))
    send_q = send_q[:, :CAP]
    send_src = send_src[:, :CAP]

    # exchange queries: received[s] = queries sent to me by shard s
    recv_q = jax.lax.all_to_all(send_q, axis, split_axis=0, concat_axis=0, tiled=True)

    # local probe of my sub-index
    rq = recv_q.reshape(S * CAP, W)
    slot_idx = mphf_probe_dynamic(
        rq,
        lookup.bits[0],
        lookup.ranks[0],
        lookup.seeds[0],
        lookup.masks[0],
        lookup.word_offsets[0],
        lookup.key_offsets[0],
        kmeta.n_levels,
    )
    safe = jnp.maximum(slot_idx, 0)
    stored = jnp.take(lookup.keys[0], safe, axis=0)
    okhit = (slot_idx >= 0) & jnp.all(stored == rq, axis=-1)
    vals = jnp.take(lookup.values[0], safe, axis=0)
    res_node = jnp.where(okhit, vals[:, 0], -1)
    res_off = jnp.where(okhit, vals[:, 1], -1)
    res = jnp.stack([res_node, res_off], axis=-1).reshape(S, CAP, 2)

    # exchange results back
    back = jax.lax.all_to_all(res, axis, split_axis=0, concat_axis=0, tiled=True)
    back = back.reshape(S * CAP, 2)
    src = send_src.reshape(S * CAP)

    # unscatter with a dump slot (index n) for unused buffer entries
    seed_node_flat = jnp.full(n + 1, -1, dtype=jnp.int32)
    seed_off_flat = jnp.full(n + 1, -1, dtype=jnp.int32)
    src_safe = jnp.where(src >= 0, src, n)
    seed_node_flat = seed_node_flat.at[src_safe].set(back[:, 0])
    seed_off_flat = seed_off_flat.at[src_safe].set(back[:, 1])
    seed_node = seed_node_flat[:n].reshape(B, P_)
    seed_off = seed_off_flat[:n].reshape(B, P_)
    return seed_node, seed_off, overflow, dropped_lane


def make_kpart_step(
    meta: MapMeta,
    kmeta: KPartMeta,
    mesh: Mesh,
    n_tx: int,
    axis: str = READS_AXIS,
):
    """Jitted distributed step for the k-mer-partitioned mode.

    fn(graph_idx, lookup, gshards, packed, lens) ->
        (MapResult sharded, counts replicated, overflow replicated)

    With kmeta.node_block > 0 the graph arrays ride in `gshards`
    (node-block-partitioned across the mesh) and the walk fetches node
    rows/windows through the routed all_to_all fetcher; the while-loop
    liveness is psum-reduced so every shard runs the same trip count.
    """
    shard_graph = kmeta.node_block > 0

    def local_step(idx: DeviceIndex, lookup: ShardedLookup,
                   gsh: GraphShards, packed, lens):
        reads = unpack_reads(packed, meta.read_len)
        lens = lens.astype(jnp.int32)
        seed_node, seed_off, overflow, dropped = _routed_seed_tables(
            meta, kmeta, lookup, reads, lens, axis
        )
        _, nh3 = next_hit_table(
            seed_node, seed_off, lens, meta.k, meta.n_positions
        )
        if shard_graph:
            fetch = _routed_fetch_factory(
                meta, gsh.node_rows[0], gsh.pools[0], axis,
                kmeta.n_shards, kmeta.node_block,
            )
            cond_all = lambda x: (  # noqa: E731
                jax.lax.psum(x.astype(jnp.int32), axis) > 0
            )
        else:
            fetch = cond_all = None
        res = map_batch_with_seeds(
            meta, idx, reads, lens, nh3,
            fetch=fetch, cond_all=cond_all,
        )
        if meta.distinct_cap > 0:
            # routing-overflow lanes ride the compact -3 channel: the
            # host emit pipeline re-maps them exactly, so a rare bucket
            # overflow costs a few host re-maps instead of a batch
            # error + device sync (map_batch skips the int(overflow)
            # drain in compact mode)
            ecd = res.ec_distinct
            last = jnp.where(
                dropped, jnp.asarray(-3, ecd.dtype), ecd[:, -1]
            )
            res = res._replace(ec_distinct=ecd.at[:, -1].set(last))
        if meta.tx_words > 0 and meta.distinct_cap == 0:
            # bitset TCC counts exist only on the full-output path; in
            # compact serving mode counting rides the host emit pipeline
            counts = jax.lax.psum(tx_compat_counts(res, n_tx), axis)
        else:
            counts = jnp.zeros(n_tx, jnp.int32)
        overflow = jax.lax.psum(overflow, axis)
        return res, counts, overflow

    idx_spec = jax.tree.map(lambda _: P(), DeviceIndex(*[0] * len(DeviceIndex._fields)))
    lookup_spec = jax.tree.map(
        lambda _: P(axis), ShardedLookup(*[0] * len(ShardedLookup._fields))
    )
    gsh_spec = GraphShards(node_rows=P(axis), pools=P(axis))
    out_spec = (
        MapResult(
            mapped=P(axis), coverage=P(axis), mismatches=P(axis),
            nodes=P(axis), n_nodes=P(axis), ec_bits=P(axis),
            ec_distinct=P(axis),
        ),
        P(),
        P(),
    )
    fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(idx_spec, lookup_spec, gsh_spec, P(axis), P(axis)),
        out_specs=out_spec,
        check_vma=False,
    )
    return jax.jit(fn)


class KmerPartitionedAligner:
    """Mapping engine with the k-mer index sharded across the mesh.

    shard_graph=True additionally partitions the node rows + sequence pool
    by contiguous node-id blocks (one per shard) — per-shard HBM then holds
    only 1/S of the whole index, at the cost of one all_to_all round-trip
    per walk iteration (the scale-out mode for indexes beyond one chip's
    HBM).  shard_graph=False replicates the graph (fastest per chip).
    """

    def __init__(
        self,
        image: IndexImage,
        config: AlignerConfig,
        mesh: Mesh,
        slack: float = 4.0,
        shard_graph: bool = False,
    ):
        from .mesh import shard_batch

        self.mesh = mesh
        S = int(mesh.devices.size)
        if S & (S - 1):
            raise ValueError("mesh size must be a power of two")
        import dataclasses

        dev, meta = device_index_from_image(image, config)
        # lazy_seeds (and the two-tier seed knob riding on it) must be off
        # here: in-loop lazy probes would hit the dummy cuckoo table (the
        # routed tables already cover EVERY position, so the eager
        # next-hit path is complete).  Compact outputs + walk caps pass
        # through from the config: the -3 exact-fallback channel works
        # per lane exactly as in the replicated engine.
        meta = dataclasses.replace(
            meta, lazy_seeds=False, seed_compact=0.0
        )
        self.meta = meta
        self.config = config
        self.image = image  # host-side: serving_aligner's emit/remap needs it
        self.n_tx = len(image.tx_names)

        lookup_np, n_levels = build_sharded_lookup(image, S)
        b_local = config.batch_size // S
        per_dev_queries = b_local * meta.n_positions
        cap = max(64, int(slack * per_dev_queries / S))
        # round capacity to a multiple of 8 for friendlier layouts
        cap = (cap + 7) // 8 * 8
        node_block = 0
        gsh_np = GraphShards(
            node_rows=np.zeros((S, 1, 12), np.int32),
            pools=np.zeros((S, 1, 8), np.uint32),
        )
        if shard_graph:
            gsh_np, node_block = build_sharded_graph(image, meta, S)
        self.kmeta = KPartMeta(
            n_shards=S, n_levels=n_levels, cap=cap, node_block=node_block
        )

        repl = NamedSharding(mesh, P())
        shrd = NamedSharding(mesh, P(READS_AXIS))
        # the sharded lookup's (and sharded graph's) leading axis = mesh axis
        graph = dev._replace(
            # the replicated seed structures are unused in this mode — the
            # sharded lookup replaces them
            cuckoo=np.zeros((1, dev.cuckoo.shape[1]), np.uint32),
            cuckoo_vals=np.zeros(2, np.uint32),
            mphf_bits=np.zeros(1, np.uint32),
            mphf_ranks=np.zeros(1, np.uint32),
            kmer_keys=np.zeros((1, image.kmer_keys.shape[1]), np.uint32),
            kmer_node=np.zeros(1, np.int32),
            kmer_offset=np.zeros(1, np.int32),
        )
        if shard_graph:
            # graph arrays ride sharded in gshards instead
            graph = graph._replace(
                pool_rows=np.zeros((1, 8), np.uint32),
                node_row=np.zeros((1, 12), np.int32),
            )
        self.dev = jax.tree.map(lambda a: jax.device_put(jnp.asarray(a), repl), graph)
        self.lookup = jax.tree.map(
            lambda a: jax.device_put(jnp.asarray(a), shrd), lookup_np
        )
        self.gshards = jax.tree.map(
            lambda a: jax.device_put(jnp.asarray(a), shrd), gsh_np
        )
        self._step = make_kpart_step(meta, self.kmeta, mesh, self.n_tx)
        self._exact_step = None  # built on map_exact's first call
        self._shard_batch = shard_batch

    def serving_aligner(self):
        """A Pseudoaligner whose device step routes through this sharded
        engine: the FULL serving surface (map_fastq, emit_fastq, paired,
        count, tcc) over a k-mer-partitioned index.  Host-side emit,
        overflow remap and record semantics are shared with the
        replicated engine — kpart results are bit-identical to it
        (tests/test_fuzz_kpart_identity), so output bytes are too."""
        from ..models.aligner import Pseudoaligner

        return Pseudoaligner(
            self.image, self.config,
            map_step=lambda codes, lens: self.map_batch(codes, lens)[0],
            meta=self.meta,
            remap_step=self.map_exact,
        )

    def map_exact(self, reads: np.ndarray, lens: np.ndarray) -> MapResult:
        """Exact pass over the same sharded arrays (uncapped walks, full
        outputs) for the serving aligner's re-map of flagged reads when
        the native host mapper is unavailable; row j of the result is
        read j.  The index stays sharded.  Each device takes at most
        cap // n_positions reads per step — a read routes at most
        n_positions queries — so no bucket can overflow (this
        full-output pass has no -3 channel to fall back on)."""
        if self._exact_step is None:
            self._exact_step = make_kpart_step(
                exact_meta(self.meta), self.kmeta, self.mesh, self.n_tx)
        S = self.kmeta.n_shards
        B, L = self.config.batch_size, self.meta.read_len
        b_local = B // S
        per = max(1, min(b_local, self.kmeta.cap // self.meta.n_positions))
        outs = []
        for c0 in range(0, len(reads), per * S):
            m = min(per * S, len(reads) - c0)
            # read j -> device j % S, so every device takes <= per reads
            j = np.arange(m)
            pos = (j % S) * b_local + j // S
            codes = np.zeros((B, L), np.uint8)
            codes[pos] = reads[c0:c0 + m]
            ls = np.zeros(B, lens_link_dtype(L))
            ls[pos] = lens[c0:c0 + m]
            r, l = self._shard_batch(pack_reads_host(codes), ls, self.mesh)
            res = self._exact_step(self.dev, self.lookup, self.gshards, r,
                                   l)[0]
            outs.append(jax.tree.map(lambda a: a[pos], res))
        return jax.tree.map(lambda *a: jnp.concatenate(a), *outs)

    def map_batch(self, reads: np.ndarray, lens: np.ndarray):
        nd = int(self.mesh.devices.size)
        if reads.shape[0] % nd:
            raise ValueError(
                f"batch {reads.shape[0]} not divisible by mesh size {nd}"
            )
        packed = pack_reads_host(np.asarray(reads, dtype=np.uint8))
        ldt = lens_link_dtype(self.meta.read_len)
        r, l = self._shard_batch(packed, np.asarray(lens).astype(ldt),
                                 self.mesh)
        res, counts, overflow = self._step(
            self.dev, self.lookup, self.gshards, r, l
        )
        if self.meta.distinct_cap == 0 and int(overflow) > 0:
            # full-output mode has no -3 fallback channel; compact mode
            # flags overflowed lanes -3 instead (exact host re-map), so
            # serving never blocks on this device scalar
            raise RuntimeError(
                f"kpart routing overflow ({int(overflow)} queries) — "
                "increase slack or re-run batch via the replicated path"
            )
        return res, counts
