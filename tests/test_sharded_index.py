"""K-mer-partitioned (sharded-lookup) mode vs replicated mode — identical
results on the virtual 8-device CPU mesh (BASELINE config 5)."""

import numpy as np
import pytest

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.models.aligner import Pseudoaligner
from pseudoaligner_tpu.parallel.mesh import make_mesh
from pseudoaligner_tpu.parallel.sharded_index import (
    KmerPartitionedAligner,
    build_sharded_lookup,
)


def _batch(small_reads, B, L):
    codes = np.zeros((B, L), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for j, (_, c) in enumerate(small_reads[:B]):
        codes[j, : len(c)] = c
        lens[j] = len(c)
    return codes, lens


def test_sharded_lookup_partition_covers_all_keys(small_index):
    lookup, n_levels = build_sharded_lookup(small_index, 4)
    total = 0
    seen = set()
    for s in range(4):
        ks = lookup.keys[s]
        nz = np.any(ks != 0, axis=1) | (
            np.arange(len(ks)) < 1
        )  # count real keys (kmer 0 can be a real key only once)
        for row in ks[np.any(ks != 0, axis=1)]:
            seen.add(tuple(row))
    all_keys = {tuple(r) for r in small_index.kmer_keys if tuple(r) != (0, 0)}
    assert all_keys <= seen


@pytest.mark.parametrize("nd", [2, 8])
def test_kpart_matches_replicated(small_index, small_reads, nd):
    cfg = AlignerConfig(k=20, batch_size=64, max_read_len=64, max_nodes=64,
                    distinct_cap=0)
    B, L = 64, 64
    codes, lens = _batch(small_reads, B, L)

    single = Pseudoaligner(small_index, cfg)
    base = single.map_batch_device(codes, lens)

    mesh = make_mesh(nd)
    kp = KmerPartitionedAligner(small_index, cfg, mesh)
    res, counts = kp.map_batch(codes, lens)

    assert np.array_equal(np.asarray(base.mapped), np.asarray(res.mapped))
    assert np.array_equal(np.asarray(base.coverage), np.asarray(res.coverage))
    assert np.array_equal(np.asarray(base.mismatches), np.asarray(res.mismatches))
    assert np.array_equal(np.asarray(base.ec_bits), np.asarray(res.ec_bits))
    assert np.array_equal(np.asarray(base.nodes), np.asarray(res.nodes))

    # counts equal the replicated-mode host recomputation
    bits = np.asarray(base.ec_bits)
    by = np.ascontiguousarray(bits).view(np.uint8)
    unpacked = np.unpackbits(by, axis=1, bitorder="little")[:, : small_index.n_tx]
    assert np.array_equal(np.asarray(counts), unpacked.sum(axis=0).astype(np.int32))


@pytest.mark.parametrize("nd", [2, 8])
def test_kpart_sharded_graph_matches_replicated(small_index, small_reads, nd):
    """Graph-sharded kpart (node rows + pool partitioned, routed walk
    fetches) must be bit-identical to the single-device walk."""
    cfg = AlignerConfig(k=20, batch_size=64, max_read_len=64, max_nodes=64,
                        distinct_cap=0)
    B, L = 64, 64
    codes, lens = _batch(small_reads, B, L)

    single = Pseudoaligner(small_index, cfg)
    base = single.map_batch_device(codes, lens)

    mesh = make_mesh(nd)
    kp = KmerPartitionedAligner(small_index, cfg, mesh, shard_graph=True)
    # per-shard HBM: the graph block is ~1/S of the whole
    assert kp.gshards.node_rows.shape[1] == (small_index.n_nodes + nd - 1) // nd
    res, counts = kp.map_batch(codes, lens)

    assert np.array_equal(np.asarray(base.mapped), np.asarray(res.mapped))
    assert np.array_equal(np.asarray(base.coverage), np.asarray(res.coverage))
    assert np.array_equal(np.asarray(base.mismatches), np.asarray(res.mismatches))
    assert np.array_equal(np.asarray(base.ec_bits), np.asarray(res.ec_bits))
    assert np.array_equal(np.asarray(base.nodes), np.asarray(res.nodes))


def test_kpart_default_config_serving(small_index, small_reads):
    """With a DEFAULT config (compact outputs + walk caps) the kpart mode
    keeps the serving shape: the caps and the -3 exact-fallback channel
    pass through, producing per-lane outputs identical to the
    single-device engine under the same (lazy-off, comparability)
    settings."""
    cfg = AlignerConfig(k=20, batch_size=64, max_read_len=64, max_nodes=64,
                        lazy_seeds=False, left_compact=0.0)
    assert cfg.distinct_cap > 0 and cfg.max_walk_iters > 0
    B, L = 64, 64
    codes, lens = _batch(small_reads, B, L)

    base = Pseudoaligner(small_index, cfg).map_batch_device(codes, lens)

    mesh = make_mesh(2)
    kp = KmerPartitionedAligner(small_index, cfg, mesh)
    assert kp.meta.max_walk_iters == cfg.max_walk_iters
    assert kp.meta.distinct_cap == cfg.distinct_cap
    res, _ = kp.map_batch(codes, lens)
    assert np.array_equal(np.asarray(base.coverage), np.asarray(res.coverage))
    assert np.array_equal(np.asarray(base.ec_distinct),
                          np.asarray(res.ec_distinct))


@pytest.mark.parametrize("shard_graph", [False, True])
def test_kpart_serving_surface(small_index, small_reads, tmp_path,
                               shard_graph):
    """serving_aligner(): the FULL serving surface over the sharded
    engine — single-end emit and paired emit must be byte-identical to
    the replicated engine under the same serving config (kpart+paired /
    kpart+emit fuzz combos)."""
    import io as iomod

    cfg = AlignerConfig(k=20, batch_size=64, max_read_len=64, max_nodes=9,
                        distinct_cap=3, max_walk_iters=3, max_left_iters=2,
                        lazy_seeds=False, left_compact=0.0)
    base = Pseudoaligner(small_index, cfg)
    kp = KmerPartitionedAligner(small_index, cfg, make_mesh(2),
                                shard_graph=shard_graph)
    srv = kp.serving_aligner()

    fq = tmp_path / "r.fq"
    r1 = tmp_path / "m1.fq"
    r2 = tmp_path / "m2.fq"
    dec = "ACGT"
    n = 150
    with open(fq, "w") as f, open(r1, "w") as f1, open(r2, "w") as f2:
        for i in range(n):
            a = "".join(dec[b] for b in small_reads[i][1][:60])
            b_ = "".join(dec[b] for b in small_reads[n + i][1][:60])
            f.write(f"@s{i}\n{a}\n+\n{'I' * len(a)}\n")
            f1.write(f"@p{i}\n{a}\n+\n{'I' * len(a)}\n")
            f2.write(f"@p{i}\n{b_}\n+\n{'I' * len(b_)}\n")

    buf_b, buf_k = iomod.BytesIO(), iomod.BytesIO()
    assert base.emit_fastq(str(fq), buf_b)[0] == n
    assert srv.emit_fastq(str(fq), buf_k)[0] == n
    assert buf_b.getvalue() == buf_k.getvalue()

    pb, pk = iomod.BytesIO(), iomod.BytesIO()
    assert base.emit_fastq_paired(str(r1), str(r2), pb) == n
    assert srv.emit_fastq_paired(str(r1), str(r2), pk) == n
    assert pb.getvalue() == pk.getvalue()


def test_kpart_serving_device_remap_fallback(small_index, small_transcripts,
                                             tmp_path):
    """When the native host mapper is unavailable, the kpart serving
    aligner's overflow remap must fall back to an exact DEVICE pass —
    through the engine's own exact pass, so the index stays sharded:
    no replicated copy is built on any device."""
    import io as iomod

    cfg = AlignerConfig(k=20, batch_size=64, max_read_len=64, max_nodes=4,
                        distinct_cap=3, max_walk_iters=1, max_left_iters=1,
                        lazy_seeds=False, left_compact=0.0)
    base = Pseudoaligner(small_index, cfg)
    kp = KmerPartitionedAligner(small_index, cfg, make_mesh(2))
    srv = kp.serving_aligner()
    calls = []
    exact = kp.map_exact
    srv._engine_remap = lambda c, l: calls.append(len(c)) or exact(c, l)
    # simulate a host without the C++ toolchain BEFORE first use
    srv._host_mapper_inst = None
    assert srv._host_mapper() is None

    from pseudoaligner_tpu.synth import reads, write_fastq

    fq = tmp_path / "r.fq"
    n = 128
    # reads of the indexed transcripts: some cross more nodes than the
    # walk caps allow, so the overflow remap runs
    write_fastq(str(fq), reads(small_transcripts[0], n, 60, seed=5), "s")

    buf_b, buf_k = iomod.BytesIO(), iomod.BytesIO()
    assert base.emit_fastq(str(fq), buf_b)[0] == n
    assert srv.emit_fastq(str(fq), buf_k)[0] == n
    assert buf_b.getvalue() == buf_k.getvalue()
    # the device fallback must actually have run (these caps flag rows)
    assert calls and kp._exact_step is not None
    assert not hasattr(srv, "dev") and not hasattr(srv, "_remap_step")
    # the lookup the exact pass read is still split over the mesh, one
    # block per device
    keys = kp.lookup.keys
    assert keys.sharding.spec[0] == "reads"
    assert [s.data.shape[0] for s in keys.addressable_shards] == [1, 1]


@pytest.mark.parametrize("shard_graph", [False, True])
def test_kpart_map_exact_matches_replicated(small_index, small_reads,
                                            shard_graph):
    """map_exact: uncapped full-output rows, in input order, equal to the
    replicated exact pass — over more reads than one step takes, so the
    spread over devices and the chunking both run."""
    import jax

    from pseudoaligner_tpu.models.aligner import _MAP_STEP_JIT
    from pseudoaligner_tpu.ops.map_kernel import exact_meta, pack_reads_host

    cfg = AlignerConfig(k=20, batch_size=64, max_read_len=64, max_nodes=4,
                        distinct_cap=3, max_walk_iters=1, max_left_iters=1,
                        lazy_seeds=False, left_compact=0.0)
    n = 150
    codes, lens = _batch(small_reads, n, 64)
    base = Pseudoaligner(small_index, cfg)
    want = jax.device_get(_MAP_STEP_JIT(
        exact_meta(base.meta), base.dev, pack_reads_host(codes), lens))
    kp = KmerPartitionedAligner(small_index, cfg, make_mesh(2),
                                shard_graph=shard_graph)
    got = jax.device_get(kp.map_exact(codes, lens))
    assert got.nodes.shape == want.nodes.shape == (n, 2 * 64)
    for f in ("mapped", "coverage", "mismatches", "nodes", "n_nodes"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_build_sharded_graph_blocks(small_index):
    from pseudoaligner_tpu.ops.map_kernel import device_index_from_image
    from pseudoaligner_tpu.parallel.sharded_index import build_sharded_graph

    cfg = AlignerConfig(k=20, batch_size=64, max_read_len=64)
    _, meta = device_index_from_image(small_index, cfg)
    gsh, nb = build_sharded_graph(small_index, meta, 4)
    assert gsh.node_rows.shape == (4, nb, 12)
    # every node's metadata survives partitioning (start is rebased)
    for s in range(4):
        lo, hi = s * nb, min(small_index.n_nodes, (s + 1) * nb)
        blk = gsh.node_rows[s, : hi - lo]
        assert np.array_equal(blk[:, 1], small_index.node_len[lo:hi])
        assert np.array_equal(blk[:, 3], small_index.node_ec[lo:hi])
        assert np.array_equal(blk[:, 4:8], small_index.r_edge[lo:hi])
        assert np.array_equal(blk[:, 8:12], small_index.l_edge[lo:hi])


@pytest.mark.parametrize("shard_graph", [False, True])
def test_kpart_compact_serving_mode(small_index, small_reads, shard_graph):
    """The k-mer-partitioned mode now supports the compact serving shape
    (distinct_cap + walk caps with the per-lane -3 exact-fallback
    channel): per-lane outputs must be identical to the single-device
    compact engine (left compaction off so capacities can't differ
    between the per-device and whole-batch lane sets)."""
    cfg = AlignerConfig(k=20, batch_size=64, max_read_len=64, max_nodes=9,
                        distinct_cap=4, max_walk_iters=4, max_left_iters=2,
                        left_compact=0.0, lazy_seeds=False)
    B, L = 64, 64
    codes, lens = _batch(small_reads, B, L)
    single = Pseudoaligner(small_index, cfg)
    base = single.map_batch_device(codes, lens)

    mesh = make_mesh(4)
    kp = KmerPartitionedAligner(small_index, cfg, mesh,
                                shard_graph=shard_graph)
    res, _counts = kp.map_batch(codes, lens)
    assert np.array_equal(np.asarray(base.ec_distinct),
                          np.asarray(res.ec_distinct))
    assert np.array_equal(np.asarray(base.coverage),
                          np.asarray(res.coverage))
    assert np.array_equal(np.asarray(base.mapped), np.asarray(res.mapped))


def test_kpart_short_reads_no_routing_skew(small_index, small_reads):
    """Zero-padded read tails all produce the identical poly-A k-mer;
    routing them would send ~P-L positions per lane to ONE shard and
    overflow its bucket.  Short reads (24bp at max_read_len=64) must map
    without overflow and match the single-device engine."""
    cfg = AlignerConfig(k=20, batch_size=64, max_read_len=64, max_nodes=64,
                        distinct_cap=0)
    B, L = 64, 64
    codes = np.zeros((B, L), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for j, (_, c) in enumerate(small_reads[:B]):
        c = c[:24]
        codes[j, : len(c)] = c
        lens[j] = len(c)

    base = Pseudoaligner(small_index, cfg).map_batch_device(codes, lens)
    mesh = make_mesh(8)
    kp = KmerPartitionedAligner(small_index, cfg, mesh)
    res, _ = kp.map_batch(codes, lens)  # must not raise routing overflow
    assert np.array_equal(np.asarray(base.coverage), np.asarray(res.coverage))
    assert np.array_equal(np.asarray(base.ec_bits), np.asarray(res.ec_bits))


def test_kpart_routing_overflow_lanes_fall_back(small_index, small_reads):
    """Routing overflow in compact mode degrades per lane, not per batch:
    lanes whose k-mers overflowed a destination bucket carry the -3
    exact-fallback marker and re-map on the host — final records match
    the replicated engine (no RuntimeError, no device sync)."""
    from pseudoaligner_tpu.io.fastq import ReadBatch

    cfg = AlignerConfig(k=20, batch_size=64, max_read_len=64, max_nodes=7,
                        distinct_cap=3, max_walk_iters=3, max_left_iters=2)
    B, L = 64, 64
    codes, lens = _batch(small_reads, B, L)
    # poison half the lanes with ONE repeated k-mer (poly-C): all their
    # valid positions hash to a single owner shard, overflowing its
    # fixed-capacity bucket by construction
    codes[32:] = 1
    lens[32:] = L

    mesh = make_mesh(8)
    kp = KmerPartitionedAligner(small_index, cfg, mesh)
    al = kp.serving_aligner()
    res = al.map_batch_device(codes, lens)  # must NOT raise
    ecd = np.asarray(res.ec_distinct)
    assert (ecd[32:, -1] == -3).any(), "expected -3-flagged overflow lanes"

    batch = ReadBatch(codes=codes, lens=lens,
                      ids=[f"r{i}" for i in range(B)])
    base_al = Pseudoaligner(small_index, cfg)
    recs_k = al.records_from_result(res, batch)
    recs_b = base_al.records_from_result(
        base_al.map_batch_device(codes, lens), batch)
    assert [(r.flag, r.eq_class, r.coverage) for r in recs_k] == [
        (r.flag, r.eq_class, r.coverage) for r in recs_b]
