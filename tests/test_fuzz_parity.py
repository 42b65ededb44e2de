"""Randomized device-vs-golden parity fuzz.

The bundled-FASTQ parity tests cover the reference's smoke data; this
sweep feeds the engine random transcriptomes and adversarial read shapes
(poly-A vs the zero pool padding, exactly-k reads, SNP bursts, junction
windows) and checks bit-exact agreement with the golden oracle."""

import numpy as np

from pseudoaligner_tpu.index.builder import build_index

from .test_map_device import _check_parity


def _random_transcripts(rng, n=24, lo=250, hi=900):
    seqs = [
        rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8)
        for _ in range(n)
    ]
    names = [f"TX{i}" for i in range(n)]
    return seqs, names, {nm: f"G{i % 7}" for i, nm in enumerate(names)}


def _fuzz_reads(rng, seqs, k, n=400, L=80):
    reads = []
    cat = np.concatenate(seqs)
    for i in range(n):
        kind = i % 8
        if kind == 0:  # exact window
            s = seqs[int(rng.integers(len(seqs)))]
            st = int(rng.integers(0, max(1, len(s) - L)))
            w = s[st : st + L].copy()
        elif kind == 1:  # SNP burst (up to 4 errors)
            s = seqs[int(rng.integers(len(seqs)))]
            st = int(rng.integers(0, max(1, len(s) - L)))
            w = s[st : st + L].copy()
            for _ in range(int(rng.integers(1, 5))):
                p = int(rng.integers(0, len(w)))
                w[p] = (w[p] + 1 + rng.integers(0, 3)) % 4
        elif kind == 2:  # random (mostly unmappable)
            w = rng.integers(0, 4, L).astype(np.uint8)
        elif kind == 3:  # poly-A (compares against the zero pool padding)
            w = np.zeros(int(rng.integers(k, L)), np.uint8)
        elif kind == 4:  # exactly k long
            s = seqs[int(rng.integers(len(seqs)))]
            st = int(rng.integers(0, max(1, len(s) - k)))
            w = s[st : st + k].copy()
        elif kind == 5:  # transcript tail crossing into another
            st = int(rng.integers(0, len(cat) - L))
            w = cat[st : st + L].copy()
        elif kind == 6:  # reversed window
            s = seqs[int(rng.integers(len(seqs)))]
            st = int(rng.integers(0, max(1, len(s) - L)))
            w = s[st : st + L][::-1].copy()
        else:  # short (< k: must be unmapped)
            w = rng.integers(0, 4, int(rng.integers(1, k))).astype(np.uint8)
        reads.append((f"fz{i}", np.ascontiguousarray(w, dtype=np.uint8)))
    return reads


def test_fuzz_parity_k20():
    rng = np.random.default_rng(1234)
    seqs, names, gmap = _random_transcripts(rng)
    image = build_index(seqs, names, gmap, k=20)
    reads = _fuzz_reads(rng, seqs, k=20)
    n = _check_parity(image, reads, max_read_len=96)
    assert n == len(reads)


def test_fuzz_parity_k20_second_seed():
    rng = np.random.default_rng(987)
    seqs, names, gmap = _random_transcripts(rng, n=12, lo=120, hi=400)
    image = build_index(seqs, names, gmap, k=20)
    reads = _fuzz_reads(rng, seqs, k=20, n=300, L=64)
    n = _check_parity(image, reads, max_read_len=96)
    assert n == len(reads)


def test_fuzz_parity_k64():
    rng = np.random.default_rng(55)
    seqs, names, gmap = _random_transcripts(rng, n=10, lo=200, hi=500)
    image = build_index(seqs, names, gmap, k=64)
    reads = _fuzz_reads(rng, seqs, k=64, n=200, L=96)
    n = _check_parity(image, reads, max_read_len=120)
    assert n == len(reads)


import pytest


@pytest.mark.parametrize("pool_overlap", [False, True])
@pytest.mark.parametrize("pad_L", [80, 112, 128, 144])
def test_fuzz_parity_padded_width_sweep(pad_L, pool_overlap):
    """The compare-window provisioning depends on the PADDED batch width
    (max_read_len), not the read length — sweep the width range where
    the row under-provisioning bug lived (fixed: pool_fetch_rows), on
    BOTH pool layouts (pool_overlap changes the window-fetch math and is
    a bench self-tune candidate)."""
    rng = np.random.default_rng(pad_L)
    seqs, names, gmap = _random_transcripts(rng, n=8, lo=150, hi=400)
    image = build_index(seqs, names, gmap, k=20)
    reads = _fuzz_reads(rng, seqs, k=20, n=120, L=min(72, pad_L - 8))
    n = _check_parity(image, reads, max_read_len=pad_L,
                      pool_overlap=pool_overlap)
    assert n == len(reads)


@pytest.mark.parametrize("am", [0, 1, 4])
def test_fuzz_parity_mismatch_budget(am):
    """The per-segment SNP budget (allowed_mismatches) drives segment
    math, premature stops, and re-seeding — pin parity across budgets
    on SNP-heavy reads."""
    rng = np.random.default_rng(100 + am)
    seqs, names, gmap = _random_transcripts(rng, n=8, lo=150, hi=400)
    image = build_index(seqs, names, gmap, k=20)
    reads = _fuzz_reads(rng, seqs, k=20, n=160, L=64)
    n = _check_parity(image, reads, max_read_len=80, allowed_mismatches=am)
    assert n == len(reads)


@pytest.mark.parametrize("max_nodes", [7, 8, 16])
def test_fuzz_serving_emit_parity(tmp_path, max_nodes):
    """The native serving emit pipeline (compact outputs, caps, lane
    compaction, -3/-2 host remap, signature-indirect emitter) must print
    records identical to the full-output record path on random data.
    max_nodes sweeps the node-buffer EDGE: 7 is exactly the wcap+lcap+2
    push bound at caps (3,2) — lanes that outgrow it must -3-flag
    exactly, never truncate silently."""
    import io as iomod

    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.models.aligner import Pseudoaligner

    rng = np.random.default_rng(77)
    seqs, names, gmap = _random_transcripts(rng, n=16, lo=200, hi=600)
    image = build_index(seqs, names, gmap, k=20)
    reads = _fuzz_reads(rng, seqs, k=20, n=500, L=72)
    fq = tmp_path / "fz.fq"
    dec = "ACGT"
    with open(fq, "w") as f:
        for rid, w in reads:
            s = "".join(dec[b] for b in w)
            f.write(f"@{rid}\n{s}\n+\n{'I' * len(s)}\n")

    ref = Pseudoaligner(image, AlignerConfig(
        k=20, batch_size=128, max_read_len=96, max_nodes=64,
        distinct_cap=0))
    want = "".join(
        r.format_reference_style() + "\n" for r in ref.map_fastq(str(fq))
    ).encode()

    srv = Pseudoaligner(image, AlignerConfig(
        k=20, batch_size=128, max_read_len=96, max_nodes=max_nodes,
        distinct_cap=3, max_walk_iters=3, max_left_iters=2))
    buf = iomod.BytesIO()
    n, _fl = srv.emit_fastq(str(fq), buf)
    assert n == len(reads)
    assert buf.getvalue() == want


def test_fuzz_adversarial_ids_emit_parity(tmp_path):
    """Adversarial read ids (quotes, backslashes, tabs, ASCII control
    bytes, combining marks, NBSP/ZWSP, printable unicode, very long ids)
    through the NATIVE signature-indirect emitter — its fast ASCII
    escape path must bail out to the exact python `escape_debug` mirror
    on every non-trivial id, byte-identical to the record path
    (reference format: println!("{:?}", ..) src/pseudoaligner.rs:490)."""
    import io as iomod

    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.models.aligner import Pseudoaligner

    rng = np.random.default_rng(1234)
    seqs, names, gmap = _random_transcripts(rng, n=12, lo=200, hi=500)
    image = build_index(seqs, names, gmap, k=20)

    spice = ['"', "\\", "\t", "\x01", "\x1b", "\x7f", "'", "",
             "́", " ", "​", "é", "λ", "...",
             "\\\\", '\\"', "漢"]
    dec = "ACGT"
    fq = tmp_path / "adv.fq"
    n_reads = 300
    with open(fq, "wb") as f:
        for i in range(n_reads):
            rid = f"r{i}"
            for _ in range(int(rng.integers(0, 6))):
                rid += spice[int(rng.integers(0, len(spice)))]
                rid += "ab"[int(rng.integers(0, 2))] * int(rng.integers(0, 3))
            if i % 37 == 0:
                rid = rid + "x" * int(rng.integers(100, 300))  # long id
            s = seqs[int(rng.integers(len(seqs)))]
            st = int(rng.integers(0, max(1, len(s) - 60)))
            w = "".join(dec[b] for b in s[st:st + 60])
            f.write(f"@{rid}\n{w}\n+\n{'I' * len(w)}\n".encode())

    ref = Pseudoaligner(image, AlignerConfig(
        k=20, batch_size=64, max_read_len=64, max_nodes=64,
        distinct_cap=0))
    want = "".join(
        r.format_reference_style() + "\n" for r in ref.map_fastq(str(fq))
    ).encode()

    srv = Pseudoaligner(image, AlignerConfig(
        k=20, batch_size=64, max_read_len=64, max_nodes=7,
        distinct_cap=3, max_walk_iters=3, max_left_iters=2))
    buf = iomod.BytesIO()
    n, _fl = srv.emit_fastq(str(fq), buf)
    assert n == n_reads
    assert buf.getvalue() == want


def _ascii_with_ns(rng, codes, n_frac=0.03, run_p=0.3):
    """Base codes -> ASCII bytes with random N sprinkles and N runs."""
    s = np.frombuffer(b"ACGT", np.uint8)[codes].copy()
    n_mask = rng.random(len(s)) < n_frac
    if rng.random() < run_p and len(s) > 40:
        st = int(rng.integers(0, len(s) - 12))
        n_mask[st : st + int(rng.integers(3, 12))] = True
    s[n_mask] = ord("N")
    return s.tobytes()


def test_fuzz_parity_n_bases(tmp_path):
    """N-containing transcriptome + N-containing reads, end to end.

    The exact `DnaString::from_acgt_bytes_hashn` of the unvendored
    debruijn crate (reference call site src/utils.rs:76) is not
    observable here; `dna.from_acgt_bytes_hashn` is a documented
    stand-in.  This fuzz pins the substitution path as internally
    bit-stable: FASTA load (hashn applied) -> NumPy and C++ builders
    bit-identical; N-containing FASTQ reads (N->A, matching debruijn's
    `base_to_bits` default used by src/pseudoaligner.rs:449-450) map
    bit-exact device vs golden, full-output vs compact serving emit."""
    import io as iomod

    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.io.fasta import read_transcripts
    from pseudoaligner_tpu.models.aligner import Pseudoaligner

    rng = np.random.default_rng(4242)
    raw = [rng.integers(0, 4, int(rng.integers(250, 700))).astype(np.uint8)
           for _ in range(14)]
    fa = tmp_path / "n.fa"
    with open(fa, "wb") as f:
        for i, codes in enumerate(raw):
            f.write(f">TXN{i} gene=G{i % 5}\n".encode())
            f.write(_ascii_with_ns(rng, codes) + b"\n")

    seqs, names, gmap = read_transcripts(str(fa))
    assert any((s != r[: len(s)]).any() for s, r in zip(seqs, raw)), \
        "fixture produced no substituted base"
    image = build_index(seqs, names, gmap, k=20, native="never")
    try:
        img_native = build_index(seqs, names, gmap, k=20, native="require")
    except Exception:
        img_native = None  # native lib unavailable on this host
    if img_native is not None:
        for f in ("node_start", "node_len", "node_exts", "node_ec",
                  "seq_pool", "l_edge", "r_edge", "ec_offsets", "ec_txs",
                  "kmer_node", "kmer_offset", "kmer_keys"):
            assert np.array_equal(getattr(image, f),
                                  getattr(img_native, f)), f

    # N-containing reads: windows of the SUBSTITUTED transcripts with Ns
    # re-sprinkled, so N->A produces mismatches the oracle must agree on.
    reads, k, L = [], 20, 72
    fq = tmp_path / "n.fq"
    with open(fq, "wb") as f:
        for i in range(240):
            s = seqs[int(rng.integers(len(seqs)))]
            st = int(rng.integers(0, max(1, len(s) - L)))
            w = s[st : st + L]
            ascii_read = _ascii_with_ns(rng, w, n_frac=0.05)
            f.write(b"@nr%d\n" % i + ascii_read + b"\n+\n" +
                    b"I" * len(ascii_read) + b"\n")
            codes = np.frombuffer(ascii_read, np.uint8)
            codes = np.where(codes == ord("N"), ord("A"), codes)
            enc = np.zeros(len(codes), np.uint8)
            for v, ch in enumerate(b"ACGT"):
                enc[codes == ch] = v
            reads.append((f"nr{i}", enc))
    n = _check_parity(image, reads, max_read_len=80)
    assert n == len(reads)

    # end-to-end FASTQ (reader does the N->A mapping) vs serving emit
    ref = Pseudoaligner(image, AlignerConfig(
        k=k, batch_size=128, max_read_len=80, max_nodes=64, distinct_cap=0))
    want = "".join(
        r.format_reference_style() + "\n" for r in ref.map_fastq(str(fq))
    ).encode()
    srv = Pseudoaligner(image, AlignerConfig(
        k=k, batch_size=128, max_read_len=80, max_nodes=8,
        distinct_cap=3, max_walk_iters=3, max_left_iters=2))
    buf = iomod.BytesIO()
    nn, _fl = srv.emit_fastq(str(fq), buf)
    assert nn == 240 and buf.getvalue() == want


def test_fuzz_paired_emit_parity(tmp_path):
    """Paired serving emit (compact caps, batched override intersection)
    vs the full-output paired record path on random family-structured
    data: transcripts share long stretches so walks cross EC boundaries
    and rows genuinely overflow distinct_cap/max_nodes (-2/-3 -> host
    remap -> both-mapped override rows through pa_intersect_pairs)."""
    import io as iomod

    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.models.aligner import Pseudoaligner

    rng = np.random.default_rng(9001)
    # isoform families: 6 bases x 4 splice variants -> wide, varied ECs
    seqs, names, gmap = [], [], {}
    for g in range(6):
        base = rng.integers(0, 4, 1200).astype(np.uint8)
        for i in range(4):
            if i == 0:
                s = base
            else:
                a = int(rng.integers(50, 500))
                b = int(rng.integers(a + 60, a + 400))
                s = np.concatenate([base[:a], base[b:]])
            nm = f"fx{g}_{i}"
            seqs.append(s)
            names.append(nm)
            gmap[nm] = f"fg{g}"
    image = build_index(seqs, names, gmap, k=20)

    reads1 = _fuzz_reads(rng, seqs, k=20, n=400, L=72)
    reads2 = _fuzz_reads(rng, seqs, k=20, n=400, L=72)
    # every 5th mate2 is unmappable noise: a flagged mate1 paired with an
    # unmapped mate2 exercises the SINGLE-mate override branch
    reads2 = [
        (rid, rng.integers(0, 4, 72).astype(np.uint8)) if i % 5 == 0
        else (rid, w)
        for i, (rid, w) in enumerate(reads2)
    ]
    dec = "ACGT"
    r1, r2 = tmp_path / "p1.fq", tmp_path / "p2.fq"
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for (rid, wa), (_, wb) in zip(reads1, reads2):
            a = "".join(dec[b] for b in wa)
            b_ = "".join(dec[b] for b in wb)
            f1.write(f"@{rid}\n{a}\n+\n{'I' * len(a)}\n")
            f2.write(f"@{rid}\n{b_}\n+\n{'I' * len(b_)}\n")

    ref = Pseudoaligner(image, AlignerConfig(
        k=20, batch_size=128, max_read_len=80, max_nodes=64,
        distinct_cap=0))
    want = "".join(
        rec.format_reference_style() + "\n"
        for rec in ref.map_fastq_paired(str(r1), str(r2))
    ).encode()

    srv = Pseudoaligner(image, AlignerConfig(
        k=20, batch_size=128, max_read_len=80, max_nodes=8,
        distinct_cap=3, max_walk_iters=3, max_left_iters=2))
    buf = iomod.BytesIO()
    n_out = srv.emit_fastq_paired(str(r1), str(r2), buf)
    assert n_out == len(reads1)
    assert buf.getvalue() == want


@pytest.mark.parametrize("shard_graph", [False, True])
def test_fuzz_kpart_identity(shard_graph):
    """K-mer-partitioned mapping (lookup- and graph-sharded) must be
    bit-identical to the single-device engine on random data too."""
    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.models.aligner import Pseudoaligner
    from pseudoaligner_tpu.parallel.mesh import make_mesh
    from pseudoaligner_tpu.parallel.sharded_index import (
        KmerPartitionedAligner,
    )

    rng = np.random.default_rng(31 + int(shard_graph))
    seqs, names, gmap = _random_transcripts(rng, n=10, lo=150, hi=400)
    image = build_index(seqs, names, gmap, k=20)
    reads = _fuzz_reads(rng, seqs, k=20, n=64, L=64)
    B, L = 64, 72
    codes = np.zeros((B, L), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for j, (_, c) in enumerate(reads[:B]):
        codes[j, : len(c)] = c
        lens[j] = len(c)
    cfg = AlignerConfig(k=20, batch_size=B, max_read_len=L, max_nodes=64,
                        distinct_cap=0)
    base = Pseudoaligner(image, cfg).map_batch_device(codes, lens)
    kp = KmerPartitionedAligner(image, cfg, make_mesh(4),
                                shard_graph=shard_graph)
    res, _ = kp.map_batch(codes, lens)
    for f in ("mapped", "coverage", "mismatches", "nodes", "ec_bits"):
        assert np.array_equal(np.asarray(getattr(base, f)),
                              np.asarray(getattr(res, f))), f


def test_fuzz_kpart_count_parity(tmp_path):
    """Single-cell count through the kpart serving aligner must write
    outputs identical to the replicated engine (kpart+count combo:
    compact serving shape, whitelist-free, directional dedup)."""
    import os

    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.models.aligner import Pseudoaligner
    from pseudoaligner_tpu.parallel.mesh import make_mesh
    from pseudoaligner_tpu.parallel.sharded_index import (
        KmerPartitionedAligner,
    )
    from pseudoaligner_tpu.singlecell import Chemistry, count_single_cell

    rng = np.random.default_rng(77)
    seqs, names, gmap = _random_transcripts(rng, n=10, lo=200, hi=500)
    image = build_index(seqs, names, gmap, k=20)
    dec = "ACGT"
    bcs = ["".join(dec[b] for b in rng.integers(0, 4, 16)) for _ in range(4)]
    umis = ["".join(dec[b] for b in rng.integers(0, 4, 12))
            for _ in range(20)]
    with open(tmp_path / "r1.fq", "w") as f1, \
            open(tmp_path / "r2.fq", "w") as f2:
        for i in range(160):
            bc = bcs[int(rng.integers(0, 4))]
            umi = umis[int(rng.integers(0, 20))]
            s = seqs[int(rng.integers(0, len(seqs)))]
            st = int(rng.integers(0, len(s) - 60))
            cdna = "".join(dec[b] for b in s[st : st + 60])
            f1.write(f"@c{i}\n{bc}{umi}\n+\n{'I' * 28}\n")
            f2.write(f"@c{i}\n{cdna}\n+\n{'I' * 60}\n")

    cfg = AlignerConfig(k=20, batch_size=64, max_read_len=64, max_nodes=9,
                        distinct_cap=3, max_walk_iters=3, max_left_iters=2,
                        lazy_seeds=False, left_compact=0.0)
    base = Pseudoaligner(image, cfg)
    srv = KmerPartitionedAligner(image, cfg, make_mesh(2)).serving_aligner()
    files = {}
    for tag, al in (("base", base), ("kpart", srv)):
        c = count_single_cell(al, str(tmp_path / "r1.fq"),
                              str(tmp_path / "r2.fq"), Chemistry())
        d = str(tmp_path / tag)
        c.write(d, umi_dedup="directional")
        files[tag] = {
            f: open(os.path.join(d, f)).read()
            for f in ("barcodes.tsv", "ec.tsv", "matrix.mtx")
        }
    assert files["base"] == files["kpart"]


def test_fuzz_kpart_paired_parity(tmp_path):
    """Paired serving through the kpart engine (combo axis: combined
    2h-row device batch routed through the sharded lookup, override rows,
    depth-D pipeline) must emit bytes identical to the replicated
    engine on random family-structured paired data."""
    import io as iomod

    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.models.aligner import Pseudoaligner
    from pseudoaligner_tpu.parallel.mesh import make_mesh
    from pseudoaligner_tpu.parallel.sharded_index import (
        KmerPartitionedAligner,
    )

    rng = np.random.default_rng(424242)
    seqs, names, gmap = [], [], {}
    for g in range(5):
        base = rng.integers(0, 4, 1000).astype(np.uint8)
        for i in range(3):
            if i == 0:
                s = base
            else:
                a = int(rng.integers(50, 400))
                b = int(rng.integers(a + 60, a + 350))
                s = np.concatenate([base[:a], base[b:]])
            nm = f"px{g}_{i}"
            seqs.append(s)
            names.append(nm)
            gmap[nm] = f"pg{g}"
    image = build_index(seqs, names, gmap, k=20)

    reads1 = _fuzz_reads(rng, seqs, k=20, n=300, L=64)
    reads2 = _fuzz_reads(rng, seqs, k=20, n=300, L=64)
    dec = "ACGT"
    r1, r2 = tmp_path / "kp1.fq", tmp_path / "kp2.fq"
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for (rid, wa), (_, wb) in zip(reads1, reads2):
            a = "".join(dec[b] for b in wa)
            b_ = "".join(dec[b] for b in wb)
            f1.write(f"@{rid}\n{a}\n+\n{'I' * len(a)}\n")
            f2.write(f"@{rid}\n{b_}\n+\n{'I' * len(b_)}\n")

    cfg = AlignerConfig(k=20, batch_size=128, max_read_len=72, max_nodes=8,
                        distinct_cap=3, max_walk_iters=3, max_left_iters=2)
    base = Pseudoaligner(image, cfg)
    buf_b = iomod.BytesIO()
    n_b = base.emit_fastq_paired(str(r1), str(r2), buf_b)
    srv = KmerPartitionedAligner(image, cfg, make_mesh(4)).serving_aligner()
    buf_k = iomod.BytesIO()
    n_k = srv.emit_fastq_paired(str(r1), str(r2), buf_k)
    assert n_k == n_b == len(reads1)
    assert buf_k.getvalue() == buf_b.getvalue()


def test_fuzz_gz_paired_emit_parity(tmp_path):
    """gz x paired fuzz axis (VERDICT r3 #10): the paired fast path over
    stream-decompressed gz inputs must be byte-identical to the plain
    run — same family-structured overflow-heavy data as the paired fuzz,
    one mate gz and one plain (the asymmetric case), then both gz."""
    import gzip
    import io as iomod

    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.models.aligner import Pseudoaligner

    rng = np.random.default_rng(4242)
    seqs, names, gmap = [], [], {}
    for g in range(4):
        base = rng.integers(0, 4, 1000).astype(np.uint8)
        for i in range(3):
            if i == 0:
                s = base
            else:
                a = int(rng.integers(50, 400))
                b = int(rng.integers(a + 60, a + 350))
                s = np.concatenate([base[:a], base[b:]])
            nm = f"gx{g}_{i}"
            seqs.append(s)
            names.append(nm)
            gmap[nm] = f"gg{g}"
    image = build_index(seqs, names, gmap, k=20)

    reads1 = _fuzz_reads(rng, seqs, k=20, n=300, L=72)
    reads2 = _fuzz_reads(rng, seqs, k=20, n=300, L=72)
    dec = "ACGT"
    r1, r2 = tmp_path / "p1.fq", tmp_path / "p2.fq"
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for (rid, wa), (_, wb) in zip(reads1, reads2):
            f1.write(f"@{rid}\n{''.join(dec[b] for b in wa)}\n+\n{'I' * len(wa)}\n")
            f2.write(f"@{rid}\n{''.join(dec[b] for b in wb)}\n+\n{'I' * len(wb)}\n")
    r1gz, r2gz = tmp_path / "p1.fq.gz", tmp_path / "p2.fq.gz"
    for src, dst in ((r1, r1gz), (r2, r2gz)):
        with open(src, "rb") as f, gzip.open(dst, "wb") as g:
            g.write(f.read())

    srv = Pseudoaligner(image, AlignerConfig(
        k=20, batch_size=128, max_read_len=80, max_nodes=8,
        distinct_cap=3, max_walk_iters=3, max_left_iters=2))
    outs = []
    for a, b in ((r1, r2), (r1gz, r2), (r1gz, r2gz)):
        buf = iomod.BytesIO()
        n = srv.emit_fastq_paired(str(a), str(b), buf)
        assert n == 300
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] == outs[2]


def test_fuzz_count_whitelist_parity(tmp_path):
    """count-with-whitelist fuzz axis (VERDICT r3 #10): counting raw
    error-bearing barcodes THROUGH the whitelist must equal counting
    pre-corrected inputs at face value (reads whose barcode the
    whitelist drops removed from both mates) — matrix, barcodes and
    totals."""
    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.models.aligner import Pseudoaligner
    from pseudoaligner_tpu.singlecell import (Chemistry, Whitelist,
                                              count_single_cell)

    rng = np.random.default_rng(777)
    seqs, names, gmap = _random_transcripts(rng, n=10, lo=300, hi=700)
    image = build_index(seqs, names, gmap, k=20)
    al = Pseudoaligner(image, AlignerConfig(
        k=20, batch_size=64, max_read_len=80, max_nodes=8,
        distinct_cap=3, max_walk_iters=3, max_left_iters=2))

    BC, UMI = 8, 6
    chem = Chemistry(bc_len=BC, umi_len=UMI)
    wl_bcs = sorted({"".join("ACGT"[int(b)] for b in rng.integers(0, 4, BC))
                     for _ in range(24)})
    wl = Whitelist(wl_bcs, BC)
    dec = "ACGT"

    n = 500
    raw_r1 = []
    for i in range(n):
        bc = list(wl_bcs[int(rng.integers(len(wl_bcs)))])
        r = rng.random()
        if r < 0.3:  # 1-Hamming error (may be unique-correctable or not)
            p = int(rng.integers(BC))
            bc[p] = "ACGT"[int(rng.integers(4))]
        elif r < 0.4:  # garbage barcode (likely dropped)
            bc = ["ACGT"[int(b)] for b in rng.integers(0, 4, BC)]
        elif r < 0.45:  # N in barcode
            bc[int(rng.integers(BC))] = "N"
        umi = "".join("ACGT"[int(b)] for b in rng.integers(0, 4, UMI))
        raw_r1.append("".join(bc) + umi)
    r2_reads = _fuzz_reads(rng, seqs, k=20, n=n, L=72)

    def write(r1_path, r2_path, keep, correct):
        with open(r1_path, "w") as f1, open(r2_path, "w") as f2:
            for i in range(n):
                if not keep[i]:
                    continue
                s1 = correct[i] if correct else raw_r1[i]
                w = r2_reads[i][1]
                f1.write(f"@p{i}\n{s1}\n+\n{'I' * len(s1)}\n")
                f2.write(f"@p{i}\n{''.join(dec[b] for b in w)}\n+\n{'I' * len(w)}\n")

    # run 1: raw barcodes through the whitelist
    write(tmp_path / "a1.fq", tmp_path / "a2.fq", [True] * n, None)
    got = count_single_cell(al, str(tmp_path / "a1.fq"),
                            str(tmp_path / "a2.fq"), chem, whitelist=wl)

    # run 2: pre-corrected barcodes at face value (dropped reads removed)
    corrected, keep = [], []
    for s in raw_r1:
        m = wl.match(s[:BC].encode())
        keep.append(m is not None)
        corrected.append((m or "") + s[BC:])
    write(tmp_path / "b1.fq", tmp_path / "b2.fq", keep, corrected)
    want = count_single_cell(al, str(tmp_path / "b1.fq"),
                             str(tmp_path / "b2.fq"), chem,
                             whitelist=None, bc_correct=False)

    assert got.n_bad_barcode == n - sum(keep)
    assert got.cells == want.cells
    assert got.classes == want.classes
    assert got.entry_counts() == want.entry_counts()
    assert got.entry_counts("directional") == want.entry_counts("directional")


def test_fuzz_longread_window_batch_boundary_depth(tmp_path):
    """long-read windows x batch boundary x pipeline_depth fuzz axis
    (VERDICT r3 #10): reads long enough that one read's overlapping
    windows span MULTIPLE small batches, emitted at depth>1 (the
    drain-ordered record fallback inside emit_fastq), vs an unsegmented
    full-length record-path reference."""
    import io as iomod

    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.models.aligner import Pseudoaligner

    rng = np.random.default_rng(1234)
    seqs, names, gmap = _random_transcripts(rng, n=12, lo=600, hi=1200)
    image = build_index(seqs, names, gmap, k=20)
    dec = "ACGT"

    reads = []
    for i in range(60):
        kind = i % 3
        if kind == 0:  # long exact window (windows merge cleanly)
            s = seqs[int(rng.integers(len(seqs)))]
            ln = int(rng.integers(300, 560))
            st = int(rng.integers(0, max(1, len(s) - ln)))
            w = s[st: st + ln].copy()
        elif kind == 1:  # long with SNPs
            s = seqs[int(rng.integers(len(seqs)))]
            ln = int(rng.integers(200, 500))
            st = int(rng.integers(0, max(1, len(s) - ln)))
            w = s[st: st + ln].copy()
            for _ in range(6):
                p = int(rng.integers(0, len(w)))
                w[p] = (w[p] + 1 + rng.integers(0, 3)) % 4
        else:  # short read interleaved between long ones
            w = seqs[int(rng.integers(len(seqs)))][:40].copy()
        reads.append((f"lr{i}", w))
    fq = tmp_path / "long.fq"
    with open(fq, "w") as f:
        for rid, w in reads:
            f.write(f"@{rid}\n{''.join(dec[b] for b in w)}\n+\n{'I' * len(w)}\n")

    # reference: the RECORD path under the same segmentation config
    # (window merging is a documented approximation of whole-read
    # mapping, so the axis under test is the emit pipeline's ordered
    # merge across batch boundaries and depths, not segmentation itself)
    ref = Pseudoaligner(image, AlignerConfig(
        k=20, batch_size=8, max_read_len=96, max_nodes=128,
        distinct_cap=12))
    want = "".join(rec.format_reference_style() + "\n"
                   for rec in ref.map_fastq(str(fq))).encode()

    # serving: tiny batches (one read's windows cross several), depth 4
    for depth in (1, 4):
        srv = Pseudoaligner(image, AlignerConfig(
            k=20, batch_size=8, max_read_len=96, max_nodes=128,
            distinct_cap=12, pipeline_depth=depth))
        buf = iomod.BytesIO()
        n_out, _ = srv.emit_fastq(str(fq), buf)
        assert n_out == len(reads)
        assert buf.getvalue() == want, f"depth={depth}"


@pytest.mark.parametrize("caps", [(1, 1), (2, 1), (2, 2)])
def test_fuzz_serving_cap_sweep_parity(tmp_path, caps):
    """Tight walk/left caps — including the (2,1) bench candidate — must
    stay byte-identical to the full-output record path: lanes the caps
    cut take the exact -3 host remap, so output never depends on the
    cap choice."""
    import io as iomod

    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.models.aligner import Pseudoaligner

    wcap, lcap = caps
    rng = np.random.default_rng(500 + wcap * 10 + lcap)
    seqs, names, gmap = _random_transcripts(rng, n=14, lo=150, hi=700)
    image = build_index(seqs, names, gmap, k=20)
    reads = _fuzz_reads(rng, seqs, k=20, n=400, L=72)
    fq = tmp_path / "cz.fq"
    dec = "ACGT"
    with open(fq, "w") as f:
        for rid, w in reads:
            s = "".join(dec[b] for b in w)
            f.write(f"@{rid}\n{s}\n+\n{'I' * len(s)}\n")

    ref = Pseudoaligner(image, AlignerConfig(
        k=20, batch_size=128, max_read_len=96, max_nodes=64,
        distinct_cap=0))
    want = "".join(
        r.format_reference_style() + "\n" for r in ref.map_fastq(str(fq))
    ).encode()

    srv = Pseudoaligner(image, AlignerConfig(
        k=20, batch_size=128, max_read_len=96,
        max_nodes=wcap + lcap + 2, distinct_cap=3,
        max_walk_iters=wcap, max_left_iters=lcap))
    buf = iomod.BytesIO()
    n, _fl = srv.emit_fastq(str(fq), buf)
    assert n == len(reads)
    assert buf.getvalue() == want


def test_fuzz_parity_packed_upload():
    """The forced packed H2D upload (bit-packed keys/values, de-overlap
    pool, on-device unpack, padded tables) stays golden-parity on random
    graphs — covers node_bits/off_bits edge cases (tiny random node
    counts/offsets) the bundled-index tests can't."""
    import os

    for seed, k, po in ((5150, 20, False), (5151, 20, True), (5152, 64, False)):
        rng = np.random.default_rng(seed)
        seqs, names, gmap = _random_transcripts(rng, n=10, lo=150, hi=500)
        image = build_index(seqs, names, gmap, k=k)
        reads = _fuzz_reads(rng, seqs, k=k, n=160, L=96 if k == 64 else 72)
        os.environ["PA_PACK_UPLOAD"] = "1"
        try:
            # overlap only engages at max_read_len <= 80 (_derived_knobs)
            # — a 96-wide window silently fell back to stride 0, so the
            # po=True arm never hit the pool de-overlap/re-window path
            # (review r5)
            n = _check_parity(image, reads, max_read_len=80 if po else 96,
                              pool_overlap=po)
        finally:
            os.environ.pop("PA_PACK_UPLOAD", None)
        assert n == len(reads)
