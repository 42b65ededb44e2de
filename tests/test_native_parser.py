"""Native FASTQ scanner vs the python reader — identical batches."""

import os

import numpy as np
import pytest

from pseudoaligner_tpu.io.fastq import FastqReader

native = pytest.importorskip("pseudoaligner_tpu.io.native")

from pseudoaligner_tpu.synth import BUNDLED  # noqa: E402


def _collect(reader):
    out = []
    for b in reader:
        for i, rid in enumerate(b.ids):
            g = int(b.group[i]) if b.group is not None else i
            off = int(b.offset[i]) if b.offset is not None else 0
            out.append((rid, b.codes[i, : b.lens[i]].tolist(), g, off))
    return out


def test_native_matches_python_on_bundled_fastq(bundled_files):
    fq = bundled_files[1]
    a = _collect(FastqReader(fq, 257, 64, use_native=False))
    b = _collect(FastqReader(fq, 257, 64, use_native=True))
    assert len(a) == len(b) == BUNDLED["n_reads"]
    assert a == b


def test_native_long_read_segmentation(tmp_path):
    seq = "ACGT" * 60  # 240 bases
    fq = tmp_path / "long.fq"
    fq.write_text(
        f"@long1 extra tokens\n{seq}\n+\n{'I'*240}\n"
        f"@short\nACGTACGTACGTACGTACGTACGT\n+\n{'I'*24}\n"
    )
    a = _collect(FastqReader(str(fq), 8, 64, segment_long=True, use_native=False))
    b = _collect(FastqReader(str(fq), 8, 64, segment_long=True, use_native=True))
    assert a == b
    assert a[0][0] == "long1"  # id is first token only
    groups = {g for _, _, g, _ in a}
    assert len(groups) == 2


def test_native_crlf_and_final_record_no_newline(tmp_path):
    fq = tmp_path / "crlf.fq"
    fq.write_bytes(b"@r1\r\nACGT\r\n+\r\nIIII\r\n@r2\nGGCC\n+\nIIII")
    a = _collect(FastqReader(str(fq), 8, 64, use_native=False))
    b = _collect(FastqReader(str(fq), 8, 64, use_native=True))
    assert a == b
    assert [x[0] for x in a] == ["r1", "r2"]
    assert a[0][1] == [0, 1, 2, 3]


def test_native_multi_cr_parity(tmp_path):
    """Multi-CR line endings (\\r\\r\\n) trim FULLY in the native scanner,
    matching the Python readers' rstrip-all semantics, and a lone '\\r'
    inside a header delimits the id like any other whitespace
    (header[1:].split(None, 1)[0]).  Review r5: the scanner used to trim
    ONE trailing CR, leaving '\\r' inside ids and counting inner CRs as
    sequence bases on \\r\\r\\n files."""
    fq = tmp_path / "crcr.fq"
    fq.write_bytes(
        b"@r1\r\r\nACGT\r\r\n+\r\r\nIIII\r\r\n"
        b"@r2\rx desc\nGGCC\n+\nIIII\n"  # \r as id delimiter
        b"@r3\r\nTTTT\r\n+\r\nIIII\r\r"  # final record: multi-CR qual, no NL
    )
    a = _collect(FastqReader(str(fq), 8, 64, use_native=False))
    b = _collect(FastqReader(str(fq), 8, 64, use_native=True))
    assert a == b
    assert [x[0] for x in a] == ["r1", "r2", "r3"]
    assert a[0][1] == [0, 1, 2, 3]
    # incomplete under trimmed-length coverage: only 3 of 4 quals at EOF
    bad = tmp_path / "crcr_trunc.fq"
    bad.write_bytes(b"@r1\r\r\nACGT\r\r\n+\r\r\nIII\r\r")
    for un in (False, True):
        with pytest.raises(ValueError):
            _collect(FastqReader(str(bad), 8, 64, use_native=un))


def test_native_malformed(tmp_path):
    fq = tmp_path / "bad.fq"
    fq.write_text("@r1\nACGT\nOOPS\nIIII\n")
    with pytest.raises(ValueError):
        _collect(FastqReader(str(fq), 8, 64, use_native=True))
    fq2 = tmp_path / "trunc.fq"
    fq2.write_text("@r1\nACGT\n+\nIIII\n@r2\nACGT\n")
    with pytest.raises(ValueError):
        _collect(FastqReader(str(fq2), 8, 64, use_native=True))


def test_emit_fastq_matches_record_path(small_index, tmp_path, small_reads):
    """Native whole-batch emission == python record path, byte for byte,
    including a segmented long read mid-stream."""
    import io as _io

    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.dna import decode_bases
    from pseudoaligner_tpu.models.aligner import Pseudoaligner

    seqs_src = [decode_bases(c) for _, c in small_reads[:150]]
    long_seq = seqs_src[0] + seqs_src[1] + seqs_src[2]  # 180bp long read
    fq = tmp_path / "mix.fq"
    with open(fq, "w") as f:
        for i, s in enumerate(seqs_src[:70]):
            f.write(f"@r{i}\n{s}\n+\n{'I'*len(s)}\n")
        f.write(f"@long\n{long_seq}\n+\n{'I'*len(long_seq)}\n")
        for i, s in enumerate(seqs_src[70:]):
            f.write(f"@s{i}\n{s}\n+\n{'I'*len(s)}\n")

    cfg = AlignerConfig(k=20, batch_size=32, max_read_len=64, max_nodes=64)
    al = Pseudoaligner(small_index, cfg)

    buf = _io.BytesIO()
    n_reads, n_flagged = al.emit_fastq(str(fq), buf)
    emitted = buf.getvalue().decode().splitlines()

    expected = [r.format_reference_style()
                for r in al.map_fastq(str(fq))]
    assert emitted == expected
    assert n_reads == len(expected) == 151


def test_gzip_record_path_parity(small_index, small_reads, tmp_path):
    """Gzipped FASTQ through the record path (native gz source feeding
    the C scanner) yields identical records to the plain file."""
    import gzip

    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.dna import decode_bases
    from pseudoaligner_tpu.models.aligner import Pseudoaligner

    reads = small_reads[:60]
    plain = tmp_path / "r.fq"
    with open(plain, "w") as f:
        for rid, c in reads:
            s = decode_bases(c)
            f.write(f"@{rid}\n{s}\n+\n{'I' * len(s)}\n")
    gz = tmp_path / "r.fq.gz"
    with gzip.open(gz, "wb") as f:
        f.write(open(plain, "rb").read())

    cfg = AlignerConfig(k=20, batch_size=16, max_read_len=64, max_nodes=64)
    al = Pseudoaligner(small_index, cfg)
    a = [r.format_reference_style() for r in al.map_fastq(str(plain))]
    b = [r.format_reference_style() for r in al.map_fastq(str(gz))]
    assert a == b and len(a) == 60


def test_tab_header_id_parity(small_index, tmp_path):
    """Read ids stop at the first whitespace (space OR tab) in BOTH the
    native scanner and the python/gz reader — same data compressed vs
    plain must emit byte-identical records."""
    import gzip

    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.models.aligner import Pseudoaligner

    recs = b"@r1\tdesc here\nACGTACGTACGTACGTACGTACGTACGT\n+\n" + b"I" * 28 + b"\n" \
        + b"@r2 space desc\nTTTTACGTACGTACGTACGTACGTACGT\n+\n" + b"I" * 28 + b"\n"
    plain = tmp_path / "t.fq"
    plain.write_bytes(recs)
    gz = tmp_path / "t.fq.gz"
    with gzip.open(gz, "wb") as f:
        f.write(recs)
    al = Pseudoaligner(small_index, AlignerConfig(
        k=20, batch_size=16, max_read_len=64))
    a = [r.format_reference_style() for r in al.map_fastq(str(plain))]
    b = [r.format_reference_style() for r in al.map_fastq(str(gz))]
    assert a == b
    assert a[0].split('"')[1] == "r1" and a[1].split('"')[1] == "r2"


def test_segmentation_window_guard(tmp_path):
    """max_len <= window_overlap can never advance a window — must raise
    instead of looping forever."""
    import pytest

    from pseudoaligner_tpu.io.fastq import FastqReader

    fq = tmp_path / "x.fq"
    fq.write_text("@r\n" + "A" * 40 + "\n+\n" + "I" * 40 + "\n")
    with pytest.raises(ValueError, match="window overlap"):
        FastqReader(str(fq), 4, 19, segment_long=True, window_overlap=19)


def test_read_fastq_seqs_bulk_parity(tmp_path):
    """The bulk seq-only reader yields exactly the record reader's seqs,
    across chunk boundaries, CRLF line endings, and gzip."""
    import gzip

    from pseudoaligner_tpu.io.fastq import read_fastq_records, read_fastq_seqs

    import numpy as np
    rng = np.random.default_rng(7)
    recs = []
    for i in range(500):
        seq = "".join("ACGTN"[b] for b in rng.integers(0, 5, int(rng.integers(5, 90))))
        recs.append(f"@r{i} desc\n{seq}\n+\n{'I' * len(seq)}\n")
    plain = tmp_path / "b.fq"
    plain.write_text("".join(recs))
    crlf = tmp_path / "c.fq"
    crlf.write_bytes("".join(recs).replace("\n", "\r\n").encode())
    gz = tmp_path / "b.fq.gz"
    with gzip.open(gz, "wb") as f:
        f.write("".join(recs).encode())

    want = [seq for _, seq in read_fastq_records(str(plain))]
    assert list(read_fastq_seqs(str(plain), chunk_bytes=257)) == want
    assert list(read_fastq_seqs(str(crlf), chunk_bytes=131)) == want
    assert list(read_fastq_seqs(str(gz))) == want


# ---------------------------------------------------------------------------
# gz fast path (VERDICT r3 #4): stream-decompressed chunks fed to the C
# scanner must be byte-identical to the mmap path on every surface
# ---------------------------------------------------------------------------


def _gzip_of(path, out):
    import gzip

    with open(path, "rb") as f, gzip.open(out, "wb") as g:
        g.write(f.read())
    return str(out)


def test_gz_reader_parity(bundled_files, tmp_path):
    from pseudoaligner_tpu.io.fastq import FastqReader

    src = bundled_files[1]
    gz = _gzip_of(src, tmp_path / "r.fq.gz")

    def batches(path, **kw):
        return [(b.codes.copy(), b.lens.copy(), list(b.ids))
                for b in FastqReader(path, batch_size=257, max_len=64, **kw)]

    r = FastqReader(gz, batch_size=64, max_len=64)
    assert r._native is not None and r._gzsrc is not None, \
        "gz must ride the native scanner"
    r.close()
    for kw in ({}, {"skip_reads": 1000}):
        a, b = batches(src, **kw), batches(gz, **kw)
        assert len(a) == len(b)
        for (ca, la, ia), (cb, lb, ib) in zip(a, b):
            assert np.array_equal(ca, cb)
            assert np.array_equal(la, lb)
            assert ia == ib


def test_gz_multimember_and_errors(bundled_files, tmp_path):
    import gzip

    from pseudoaligner_tpu.io.fastq import FastqReader

    data = open(bundled_files[1], "rb").read()
    half = data.find(b"@", len(data) // 2)
    mm = tmp_path / "two.fq.gz"
    mm.write_bytes(gzip.compress(data[:half]) + gzip.compress(data[half:]))
    n = sum(b.n_reads for b in FastqReader(str(mm), 500, 64))
    assert n == BUNDLED["n_reads"]

    # truncated gzip stream -> error, not silent short read
    whole = gzip.compress(data)
    trunc = tmp_path / "trunc.fq.gz"
    trunc.write_bytes(whole[: len(whole) // 2])
    with pytest.raises(ValueError):
        for _ in FastqReader(str(trunc), 500, 64):
            pass

    # complete gzip of a truncated FASTQ -> truncated-record error
    tfq = tmp_path / "tfq.fq.gz"
    tfq.write_bytes(gzip.compress(data[: data.rfind(b"@") + 30]))
    with pytest.raises(ValueError):
        for _ in FastqReader(str(tfq), 500, 64):
            pass


def test_gz_r1_prefix_parity(bundled_files, tmp_path):
    from pseudoaligner_tpu.io.fastq import R1PrefixReader

    src = bundled_files[1]
    gz = _gzip_of(src, tmp_path / "r1.fq.gz")
    pa, pb = R1PrefixReader(src, 28), R1PrefixReader(gz, 28)
    assert pb._gzsrc is not None
    while True:
        x, y = pa.take(100), pb.take(100)
        assert np.array_equal(x, y)
        if len(x) < 100:
            break
    pa.close()
    pb.close()


def test_gz_zero_length_record_chunk_boundary(tmp_path):
    """Review r4 finding: a zero-length-sequence record whose qual line
    lands exactly past a streaming chunk boundary must NOT be accepted
    without its qual line (the final-record-without-newline path is
    gated on final_chunk now).  Direct scan repro + end-to-end gz run."""
    import gzip

    from pseudoaligner_tpu.io import native as N
    from pseudoaligner_tpu.io.fastq import FastqReader

    data = b"@r1\n\n+\n\n@r2\nACGT\n+\nIIII\n"
    # mid-stream window ending right after the '+' line: must leave the
    # whole record for the next fill, not consume it qual-less
    n, _, _, _, _, resume = N.fastq_scan(data, 0, 10, 8, end=7, final=False)
    assert n == 0 and resume == 0
    # at true EOF the old acceptance still applies
    n, _, lens, _, _, _ = N.fastq_scan(data[:7], 0, 10, 8, final=True)
    assert n == 1 and lens[0] == 0

    # end-to-end: gz file with zero-length reads scattered through, tiny
    # decompress chunks so boundaries land everywhere
    recs = []
    for i in range(200):
        seq = b"" if i % 7 == 0 else b"ACGTACGTACGTACGT"[: 4 + i % 12]
        recs.append(b"@z%d\n%s\n+\n%s\n" % (i, seq, b"I" * len(seq)))
    raw = b"".join(recs)
    gz = tmp_path / "z.fq.gz"
    gz.write_bytes(gzip.compress(raw))
    plain = tmp_path / "z.fq"
    plain.write_bytes(raw)

    def run(path, chunk=None):
        r = FastqReader(str(path), batch_size=33, max_len=32)
        if chunk and r._gzsrc is not None:
            r._gzsrc._chunk = chunk
        return [(b.lens.copy().tolist(), list(b.ids)) for b in r]

    a = run(plain)
    for chunk in (7, 64, 1 << 20):
        b = run(gz, chunk)
        assert a == b, f"chunk={chunk}"


def test_gz_scanner_structural_fuzz(tmp_path):
    """Randomized gz-vs-python reader parity over adversarial record
    shapes (zero-length seqs, \\r\\n endings, ids with tabs/spaces, very
    long and k-length seqs, missing trailing newline) x random compressed
    chunk sizes — the decompress-window/scan-resume state machine must
    agree with the plain python reader byte for byte."""
    import gzip

    from pseudoaligner_tpu.io.fastq import FastqReader, read_fastq_records

    rng = np.random.default_rng(31337)
    for trial in range(6):
        recs = []
        n = int(rng.integers(50, 300))
        for i in range(n):
            kind = int(rng.integers(0, 7))
            ln = (0 if kind == 0 else int(rng.integers(1, 200)))
            seq = "".join("ACGTN"[int(b)]
                          for b in rng.integers(0, 5, ln)).encode()
            rid = f"q{trial}_{i}".encode()
            if kind == 1:
                rid += b" extra desc\ttoken"  # id stops at whitespace
            eol = (b"\r\n" if kind == 2
                   else b"\r\r\n" if kind == 6  # multi-CR endings trim
                   else b"\n")                  # fully (review r5)
            recs.append(b"@%s%s%s%s+%s%s%s" % (
                rid, eol, seq, eol, eol, b"I" * ln, eol))
        raw = b"".join(recs)
        if trial % 2:  # final record without trailing newline
            raw = raw[:-1] if raw.endswith(b"\n") else raw
        plain = tmp_path / f"f{trial}.fq"
        plain.write_bytes(raw)
        gz = tmp_path / f"f{trial}.fq.gz"
        gz.write_bytes(gzip.compress(raw))

        want = [(rid, len(s)) for rid, s in read_fastq_records(str(plain))]

        # the compressed-chunk size must be set at CONSTRUCTION — the
        # native producer thread (gzstream.cpp) reads it once at open
        os.environ["PA_GZ_CHUNK"] = str(int(rng.integers(5, 400)))
        try:
            for force_fallback in (False, True):
                if force_fallback:
                    # differential axis: the pure-Python inflate thread
                    # must agree with the native producer byte for byte
                    import pseudoaligner_tpu.io.fastq as fq_mod

                    orig = fq_mod._GzScanBuffer.__init__

                    def no_native(self, path, chunk=1 << 20,
                                  __orig=orig):
                        import unittest.mock as mock

                        with mock.patch(
                            "pseudoaligner_tpu.io.native._load_gz",
                            side_effect=RuntimeError("forced"),
                        ):
                            __orig(self, path, chunk)

                    fq_mod._GzScanBuffer.__init__ = no_native
                try:
                    r = FastqReader(
                        str(gz), batch_size=int(rng.integers(3, 40)),
                        max_len=220)
                    assert r._gzsrc is not None
                    assert (r._gzsrc._gz is None) == force_fallback
                    got = []
                    for b in r:
                        for j, rid in enumerate(b.ids):
                            got.append((rid, int(b.lens[j])))
                    assert got == want, f"trial {trial} fb={force_fallback}"
                finally:
                    if force_fallback:
                        fq_mod._GzScanBuffer.__init__ = orig
        finally:
            os.environ.pop("PA_GZ_CHUNK", None)


def test_final_record_qual_semantics(tmp_path):
    """Final newline-less records: all three readers (python record path,
    bulk seq stream, native scanner via FastqReader) agree with the
    rust-bio rule — the qual is complete iff it covers the sequence, so
    a zero-length-seq record may end at its '+' line (the reference
    reads qual lines until qual.len() >= seq.len())."""
    from pseudoaligner_tpu.io.fastq import read_fastq_seqs

    cases = [
        (b"@a\nACGT\n+\nIIII\n@x\n\n+\n", ["a", "x"], [4, 0]),  # empty-qual eof
        (b"@a\nACGT\n+\nIIII", ["a"], [4]),                     # full qual no NL
        (b"@x\n\n+\n\n", ["x"], [0]),                           # empty + final NL
        (b"@a\nACGT\n+\n", None, None),                         # qual missing
        (b"@a\nACGT\n+\nII", None, None),                       # short qual eof
        (b"@x\n\n+", None, None),               # '+' missing its newline
        (b"@a\r\nACGT\r\n+\r\nIII\r", None, None),  # CRLF qual at EOF:
        # TRIMMED coverage (the '\r' is not qual) -> incomplete, per the
        # rust-bio rule (qual lines read until trim_end len >= seq len)
        (b"@a\r\nACGT\r\n+\r\nIIII\r", ["a"], [4]),  # trimmed qual covers
        (b"@a\nACGT\n+\nIII\r\r", None, None),  # ALL trailing CRs trim
        (b"@a\nACGT\n+\nIIII\r\r", ["a"], [4]),
    ]
    for raw, ids, lens in cases:
        p = tmp_path / "c.fq"
        p.write_bytes(raw)
        for reader in ("records", "seqs", "native"):
            def run():
                if reader == "records":
                    from pseudoaligner_tpu.io.fastq import read_fastq_records

                    return [(r, len(s)) for r, s in
                            read_fastq_records(str(p))]
                if reader == "seqs":
                    return [len(s) for s in read_fastq_seqs(str(p))]
                out = []
                for b in FastqReader(str(p), 8, 64):
                    out += [(r, int(b.lens[j]))
                            for j, r in enumerate(b.ids)]
                return out

            if ids is None:
                with pytest.raises(ValueError):
                    run()
            else:
                got = run()
                if reader == "seqs":
                    assert got == lens, (raw, reader)
                else:
                    assert got == list(zip(ids, lens)), (raw, reader)


def test_gz_truncated_midstream_delivers_prefix(tmp_path):
    """A gz file truncated mid-stream: records inflated before the
    corruption point are delivered (a valid PREFIX of the stream), then
    ValueError — on both the native and the Python-fallback sources."""
    import gzip
    import unittest.mock as mock

    recs = b"".join(b"@r%d\nACGTACGTACGT\n+\nIIIIIIIIIIII\n" % i
                    for i in range(20000))
    comp = gzip.compress(recs)
    gz = tmp_path / "t.fq.gz"
    gz.write_bytes(comp[: int(len(comp) * 0.6)])

    want_ids = [f"r{i}" for i in range(20000)]
    for force_fallback in (False, True):
        ctx = (mock.patch("pseudoaligner_tpu.io.native._load_gz",
                          side_effect=RuntimeError("forced"))
               if force_fallback else mock.patch("os.sep", os.sep))
        with ctx:
            r = FastqReader(str(gz), batch_size=512, max_len=16)
            assert (r._gzsrc._gz is None) == force_fallback
            got = []
            with pytest.raises(ValueError):
                for b in r:
                    got.extend(b.ids)
        assert 0 < len(got) < 20000, force_fallback
        assert got == want_ids[: len(got)], force_fallback


def test_gz_truncation_fuzz(tmp_path):
    """Randomized multi-member gz files truncated at random byte
    offsets, tiny read-ahead: every outcome must be either the full
    record stream (truncation hit only trailing garbage) or a clean
    PREFIX followed by ValueError — never corruption, on both sources."""
    import gzip
    import unittest.mock as mock

    rng = np.random.default_rng(424242)
    for trial in range(5):
        n = int(rng.integers(200, 2000))
        recs = []
        for i in range(n):
            s = b"ACGT" * int(rng.integers(1, 9))
            recs.append(b"@t%d_%d\n%s\n+\n%s\n" % (trial, i, s, b"I" * len(s)))
        raw = b"".join(recs)
        # multi-member: split into 1-6 members at random record offsets
        n_members = int(rng.integers(1, 7))
        cuts = sorted(rng.choice(len(recs), size=n_members - 1,
                                 replace=False)) if n_members > 1 else []
        comp = b""
        prev = 0
        for c in list(cuts) + [len(recs)]:
            comp += gzip.compress(b"".join(recs[prev:int(c)]),
                                  compresslevel=1)
            prev = int(c)
        cut = int(rng.integers(len(comp) // 4, len(comp) + 1))
        gz = tmp_path / f"tr{trial}.fq.gz"
        gz.write_bytes(comp[:cut])
        want = [f"t{trial}_{i}" for i in range(n)]

        os.environ["PA_GZ_CHUNK"] = str(int(rng.integers(64, 4096)))
        os.environ["PA_GZ_AHEAD"] = str(int(rng.integers(1 << 12, 1 << 16)))
        try:
            for force_fallback in (False, True):
                ctx = (mock.patch("pseudoaligner_tpu.io.native._load_gz",
                                  side_effect=RuntimeError("forced"))
                       if force_fallback else mock.patch("os.sep", os.sep))
                got = []
                err = None
                with ctx:
                    try:
                        for b in FastqReader(str(gz), batch_size=64,
                                             max_len=40):
                            got.extend(b.ids)
                    except ValueError as e:
                        err = e
                if cut == len(comp):
                    assert err is None and got == want, (trial,
                                                        force_fallback)
                else:
                    # a cut at an exact member boundary is a VALID
                    # (shorter) multi-member file: no error, clean
                    # record-boundary prefix.  Anywhere else: prefix
                    # then ValueError.  Never corruption.
                    assert got == want[: len(got)], (trial, force_fallback)
                    if err is None:
                        assert len(got) < n and got and \
                            got[-1].startswith(f"t{trial}_"), (
                                trial, force_fallback)
        finally:
            os.environ.pop("PA_GZ_CHUNK", None)
            os.environ.pop("PA_GZ_AHEAD", None)


def test_gz_corruption_error_attribution(small_index, tmp_path):
    """A truncated R1 .gz in the count path must surface the gzip/stream
    error, not a misleading 'R1 has fewer reads than R2'; a truncated
    mate in paired emit must not masquerade as a pairing mismatch."""
    import gzip

    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.dna import decode_bases
    from pseudoaligner_tpu.models.aligner import Pseudoaligner
    from pseudoaligner_tpu.singlecell import count_single_cell

    n = 600
    r2recs = []
    rng = np.random.default_rng(9)
    for i in range(n):
        s = "".join("ACGT"[b] for b in rng.integers(0, 4, 60))
        r2recs.append(f"@p{i}\n{s}\n+\n{'I' * 60}\n")
    r1recs = [f"@p{i}\n{'ACGT' * 7}\n+\n{'I' * 28}\n" for i in range(n)]
    p2 = tmp_path / "r2.fq"
    p2.write_text("".join(r2recs))
    comp = gzip.compress("".join(r1recs).encode(), compresslevel=1)
    p1gz = tmp_path / "r1.fq.gz"
    p1gz.write_bytes(comp[: int(len(comp) * 0.55)])

    al = Pseudoaligner(small_index, AlignerConfig(
        k=20, batch_size=64, max_read_len=64, max_nodes=6,
        distinct_cap=3, max_walk_iters=2, max_left_iters=2))
    with pytest.raises(ValueError, match="gzip|truncated gzip"):
        count_single_cell(al, str(p1gz), str(p2))

    import io as iomod

    with pytest.raises(ValueError, match="gzip|truncated gzip"):
        al.emit_fastq_paired(str(p1gz), str(p2), iomod.BytesIO())


def test_gz_truncated_with_carried_long_read_windows(tmp_path):
    """Carried long-read window rows (self._pending) spilled at a batch
    boundary must still be DELIVERED when the stream turns out corrupt
    right after — the error surfaces on the next pull (review r5: the
    raise used to silently drop the carried, complete records)."""
    import gzip

    # one long read -> many windows at max_len=16 (stride 16-19+... use
    # window_overlap via k? FastqReader default overlap = 19) plus
    # trailing records, then truncation
    long_seq = b"ACGT" * 40  # 160 bases -> multiple 16-wide windows
    recs = b"@long\n" + long_seq + b"\n+\n" + b"I" * 160 + b"\n"
    recs += b"".join(b"@r%d\nACGTACGTACGT\n+\nIIIIIIIIIIII\n" % i
                     for i in range(2000))
    comp = gzip.compress(recs)
    gz = tmp_path / "t.fq.gz"
    gz.write_bytes(comp[: int(len(comp) * 0.5)])

    r = FastqReader(str(gz), batch_size=4, max_len=32,
                    segment_long=True)
    got = []
    with pytest.raises(ValueError):
        for b in r:
            got.extend(b.ids)
    # every window of the long read must have been delivered, in order,
    # before the error (batch_size=4 forces pending spills)
    n_long = sum(1 for i in got if i == "long")
    assert n_long >= 2
    assert got[:n_long] == ["long"] * n_long
    # and some of the short prefix reads followed
    assert any(i.startswith("r") for i in got)


def test_read_fastq_seqs_no_phantom_row_on_truncation(tmp_path):
    """A file cut off right after a seq or plus line must raise WITHOUT
    yielding that record's seq (review r5: the bulk reader released the
    seq at the seq line, before the record validated — a consumer could
    process a phantom row before the error surfaced)."""
    from pseudoaligner_tpu.io.fastq import read_fastq_seqs

    good = b"@r0\nACGT\n+\nIIII\n"
    for tail in (b"@r1\nGGGG\n",        # cut after seq line (with NL)
                 b"@r1\nGGGG",          # cut inside seq line
                 b"@r1\nGGGG\n+\n",     # cut after plus line (with NL)
                 b"@r1\nGGGG\n+"):      # cut inside plus line
        p = tmp_path / "t.fq"
        p.write_bytes(good + tail)
        got = []
        with pytest.raises(ValueError):
            for s in read_fastq_seqs(str(p), chunk_bytes=7):
                got.append(s)
        assert got == [b"ACGT"], tail  # r1's seq never delivered
