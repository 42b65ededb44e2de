"""Command-line interface.

Equivalent of the reference binary (src/bin/pseudoaligner.rs:23-206):
subcommands `index`, `map`, `mappability`, `idxstats` with the same
positional/flag structure.  `inspect` is declared in the reference USAGE
but never implemented there (no `cmd_inspect` branch); here it prints an
index summary.

`map` writes one record per read to stdout in the reference's exact debug
format `(flag, "read_id", [eq, class], coverage)`
(src/pseudoaligner.rs:490) and a progress ticker to stderr every 10^6
reads (src/pseudoaligner.rs:497-504).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np

from . import __version__
from .config import AlignerConfig

log = logging.getLogger("pseudoaligner_tpu")

USAGE_KMER_SUPPORTED = (20, 64)


def _rust_f32_str(v: float) -> str:
    """Rust `{}` Display for f32 (shortest roundtrip, positional)."""
    f = np.float32(v)
    if np.isnan(f):
        return "NaN"
    return np.format_float_positional(f, unique=True, trim="-")


def make_ticker(stream=None, every: int = 1_000_000):
    """Reference-style stderr progress ticker for the fast emit paths
    (src/pseudoaligner.rs:497-504): prints `\\rDone Mapping N reads w/
    Rate: X` at every N = multiple of `every`.  The fast paths advance in
    whole batches, so the printed N is the crossed multiple and the rate
    is computed at the batch boundary (the record path computes it at the
    exact millionth record — same shape, batch-granular rate)."""

    state = [every]

    def tick(n_reads: int, n_mapped: int) -> None:
        s = stream if stream is not None else sys.stderr
        while n_reads >= state[0]:
            frac = (np.float32(n_mapped) * np.float32(100.0)
                    / np.float32(n_reads))
            s.write(
                f"\rDone Mapping {state[0]} reads w/ Rate: {_rust_f32_str(frac)}"
            )
            s.flush()
            state[0] += every

    return tick


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pseudoaligner",
        description="De-bruijn-mapping (JAX, GPU)",
    )
    p.add_argument("-v", "--version", action="version",
                   version=f"pseudoaligner_tpu {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, index=True):
        sp.add_argument("-k", "--kmer-size", type=int, default=20,
                        help="Kmer size to use - only 20 or 64 currently supported"
                             " [default: 20]")
        sp.add_argument("-n", "--num-threads", type=int, default=2,
                        help="Number of worker threads [default: 2]")
        if index:
            sp.add_argument("-i", "--index", required=True, dest="index")

    sp = sub.add_parser("index", help="build index from a transcriptome FASTA")
    common(sp)
    sp.add_argument("ref_fasta")

    sp = sub.add_parser("map", help="map reads from a FASTQ against an index")
    common(sp)
    sp.add_argument("reads_fastq")
    sp.add_argument("reads_fastq2", nargs="?", default=None,
                    help="optional mate FASTQ — paired-end EC intersection")
    sp.add_argument("--batch-size", type=int, default=32768)
    sp.add_argument("--max-read-len", type=int, default=160)
    sp.add_argument("-o", "--outdir", default=None)
    sp.add_argument("--tcc", action="store_true",
                    help="also write kallisto-style output.ec/output.tsv "
                         "TCC files to the output directory")
    sp.add_argument("--seed-index", choices=["cuckoo", "bucket1", "mphf"],
                    default="cuckoo",
                    help="device seed structure: cuckoo (2-gather probe, "
                         "the speed mode), bucket1 (experimental 1-gather "
                         "wide buckets) or mphf (memory-lean BBHash)")
    sp.add_argument("--skip-reads", type=int, default=0,
                    help="resume: skip the first N reads (append records "
                         "for the remainder)")
    sp.add_argument("--progress-file", default=None,
                    help="write the running emitted-read count here after "
                         "every batch (for restartable streaming)")

    sp = sub.add_parser(
        "count",
        help="10x single-cell counting: R1 barcode/UMI + R2 cDNA -> "
             "per-cell TCC matrix (alevin-style)",
    )
    common(sp)
    sp.add_argument("r1_fastq")
    sp.add_argument("r2_fastq")
    sp.add_argument("-o", "--outdir", default=None)
    sp.add_argument("--bc-len", type=int, default=16)
    sp.add_argument("--umi-len", type=int, default=12)
    sp.add_argument("--whitelist", default=None,
                    help="known-barcode list (one per line, .gz ok): exact "
                         "matches accepted, unique 1-Hamming corrections "
                         "applied, others dropped")
    sp.add_argument("--umi-dedup", choices=("exact", "directional"),
                    default="exact",
                    help="molecule counting: exact distinct UMIs, or "
                         "UMI-tools directional clustering")
    sp.add_argument("--no-bc-correct", action="store_true",
                    help="without a whitelist, skip the knee-call + "
                         "1-Hamming barcode folding (take barcodes at "
                         "face value)")
    sp.add_argument("--call-cells", action="store_true",
                    help="knee-point cell calling: also write cells.tsv "
                         "with the called barcodes (rank order)")
    sp.add_argument("--batch-size", type=int, default=32768)
    sp.add_argument("--max-read-len", type=int, default=160)

    sp = sub.add_parser("mappability", help="per-transcript mappability report")
    common(sp)
    sp.add_argument("-o", "--outdir", default=None)

    sp = sub.add_parser("idxstats", help="dump per-node stats")
    common(sp)

    sp = sub.add_parser("inspect", help="print index summary")
    common(sp)
    return p


def _check_k(k: int) -> bool:
    if k not in USAGE_KMER_SUPPORTED:
        # reference prints and exits 0 (src/bin/pseudoaligner.rs:89-95)
        print(f"Kmer size = {k} is not supported. Set kmer size to 20 or 64")
        return False
    return True


def cmd_index(args) -> int:
    from .index.builder import build_index
    from .io.fasta import read_transcripts
    from .serde import save_index

    log.info("Building index from fasta")
    seqs, tx_names, tx_gene_map = read_transcripts(args.ref_fasta)
    index = build_index(seqs, tx_names, tx_gene_map, k=args.kmer_size,
                        n_threads=args.num_threads)
    log.info("Finished building index!")
    log.info("Writing index to disk")
    save_index(index, args.index)
    log.info("Finished writing index!")
    return 0


def _serving_config(k: int, args) -> AlignerConfig:
    """The serving shape: compact EC output at distinct_cap=3 with
    read-length-proportional walk caps and a matching node buffer.
    Lanes the caps cut off take the exact host re-map (-3 channel), so
    per-read output is byte-identical to the uncapped debug shape — the
    caps only move rare work to the overlapped host mapper.  Its speed
    against other shapes is not measured on the H100 (PERF.md)."""
    wcap = max(3, args.max_read_len // 20)
    lcap = 2
    kw = {}
    if hasattr(args, "seed_index"):  # count has no flag: dataclass default
        kw["seed_index"] = args.seed_index
    return AlignerConfig(
        k=k,
        batch_size=args.batch_size,
        max_read_len=args.max_read_len,
        distinct_cap=3,
        max_walk_iters=wcap,
        max_left_iters=lcap,
        max_nodes=wcap + lcap + 2,
        **kw,
    )


def _serve(image, cfg: AlignerConfig):
    """The serving aligner, with its index resident on the device."""
    import jax

    from .models.aligner import Pseudoaligner

    t0 = time.perf_counter()
    aligner = Pseudoaligner(image, cfg)
    jax.block_until_ready(aligner.dev)
    log.info("serve init %.3f s", time.perf_counter() - t0)
    return aligner


def cmd_map(args, outdir: str) -> int:
    from .serde import load_index

    log.info("Reading index from disk")
    image = load_index(args.index)
    if image.k != args.kmer_size:
        print(f"Index was built with k={image.k}, not k={args.kmer_size}")
        return 1
    log.info("Finished reading index!")
    log.info("Mapping reads from fastq")
    log.info("Output directory: %s", outdir)

    aligner = _serve(image, _serving_config(image.k, args))

    tcc = None
    if args.tcc:
        from .tcc import TccCounter

        tcc = TccCounter()

    if args.reads_fastq2:
        if args.skip_reads:
            print("--skip-reads is not supported in paired mode")
            return 1
        try:
            from .io import native  # noqa: F401

            have_native_p = True
        except Exception:
            have_native_p = False
        if (have_native_p and tcc is None
                and aligner.meta.distinct_cap > 0):
            # paired serving fast path: native signature-indirect emitter,
            # fragment ECs intersected per distinct pair group in C++
            def pprog(nn):
                if args.progress_file:
                    sys.stdout.buffer.flush()
                    tmp = args.progress_file + ".tmp"
                    with open(tmp, "w") as pf:
                        pf.write(str(nn))
                    os.replace(tmp, args.progress_file)

            n_reads = aligner.emit_fastq_paired(
                args.reads_fastq, args.reads_fastq2, sys.stdout.buffer,
                progress_cb=pprog if args.progress_file else None,
                ticker=make_ticker(),
            )
            sys.stdout.buffer.flush()
            sys.stderr.write("\n")
            log.info("Done Mapping Reads (%d pairs)", n_reads)
            return 0
        records = aligner.map_fastq_paired(args.reads_fastq, args.reads_fastq2)
    else:
        # single-end fast path: whole-batch native record emission
        try:
            from .io import native  # noqa: F401

            have_native = True
        except Exception:
            have_native = False
        if have_native:
            def progress(n):
                if args.progress_file:
                    # crash-safe resume contract: every record counted by
                    # the progress file is durably flushed BEFORE the
                    # count advances (flush first, then atomic replace —
                    # a SIGKILL can lose the tail but never desync the
                    # progress count from the emitted stream)
                    sys.stdout.buffer.flush()
                    tmp = args.progress_file + ".tmp"
                    with open(tmp, "w") as pf:
                        pf.write(str(args.skip_reads + n))
                    os.replace(tmp, args.progress_file)

            n_reads, n_flagged = aligner.emit_fastq(
                args.reads_fastq, sys.stdout.buffer,
                skip_reads=args.skip_reads, tcc=tcc, progress_cb=progress,
                ticker=make_ticker(),
            )
            sys.stdout.buffer.flush()
            sys.stderr.write("\n")
            if tcc is not None:
                ec_path, tsv_path = tcc.write(outdir)
                log.info("TCC written: %s, %s (%d classes, %d/%d reads mapped)",
                         ec_path, tsv_path, len(tcc.counts), tcc.n_mapped,
                         tcc.n_reads)
            log.info("Done Mapping Reads (%d reads, %d flagged)",
                     n_reads, n_flagged)
            return 0
        records = aligner.map_fastq(args.reads_fastq, skip_reads=args.skip_reads)

    read_counter = 0
    mapped_read_counter = 0
    ticker = make_ticker()
    emitted = args.skip_reads
    progress_every = max(1, args.batch_size)
    out = sys.stdout

    def write_progress():
        # same crash-safe contract as the fast path: flush the records
        # BEFORE the count advances, atomic replace against torn writes
        out.flush()
        tmp = args.progress_file + ".tmp"
        with open(tmp, "w") as pf:
            pf.write(str(emitted))
        os.replace(tmp, args.progress_file)

    for rec in records:
        out.write(rec.format_reference_style() + "\n")
        if tcc is not None:
            tcc.add(rec.eq_class, mapped=rec.coverage > 0)
        emitted += 1
        if args.progress_file and emitted % progress_every == 0:
            write_progress()
        if rec.flag:
            mapped_read_counter += 1
        read_counter += 1
        # shared ticker: the inline f64 divide diverged from the
        # reference's all-f32 arithmetic in the last digit (review r5)
        ticker(read_counter, mapped_read_counter)
    if args.progress_file:
        write_progress()  # final count (the loop writes only on multiples)
    sys.stderr.write("\n")
    if tcc is not None:
        ec_path, tsv_path = tcc.write(outdir)
        log.info("TCC written: %s, %s (%d classes, %d/%d reads mapped)",
                 ec_path, tsv_path, len(tcc.counts), tcc.n_mapped, tcc.n_reads)
    log.info("Done Mapping Reads")
    return 0


def cmd_count(args, outdir: str) -> int:
    from .serde import load_index
    from .singlecell import Chemistry, Whitelist, count_single_cell

    log.info("Reading index from disk")
    image = load_index(args.index)
    if image.k != args.kmer_size:
        # same contract as `map`: a -k that disagrees with the index is a
        # wrong-index mixup, not something to silently ignore
        print(f"Index was built with k={image.k}, not k={args.kmer_size}")
        return 1
    aligner = _serve(image, _serving_config(image.k, args))
    chem = Chemistry(bc_len=args.bc_len, umi_len=args.umi_len)
    wl = Whitelist.load(args.whitelist, args.bc_len) if args.whitelist else None
    counts = count_single_cell(
        aligner, args.r1_fastq, args.r2_fastq, chem, whitelist=wl,
        bc_correct=not args.no_bc_correct, umi_dedup=args.umi_dedup,
    )
    counts.write(outdir, umi_dedup=args.umi_dedup)
    if args.call_cells:
        called = counts.call_cells(args.umi_dedup)
        with open(os.path.join(outdir, "cells.tsv"), "w") as f:
            for bc in called:
                f.write(bc + "\n")
        log.info("cell calling: %d of %d barcodes called", len(called),
                 len(counts.cells))
    log.info(
        "count: %d reads, %d mapped, %d cells, %d classes, %d bad R1, "
        "%d corrected, %d dropped barcodes",
        counts.n_reads, counts.n_mapped, len(counts.cells),
        len(counts.classes), counts.n_bad_r1, counts.n_corrected,
        counts.n_bad_barcode,
    )
    return 0


def cmd_mappability(args, outdir: str) -> int:
    from .mappability import write_mappability_tsv
    from .serde import load_index

    log.info("Reading index from disk")
    image = load_index(args.index)
    if image.k != args.kmer_size:
        # same contract as map/count (review r5: mappability silently
        # produced output on a k mismatch while its siblings exit 1)
        print(f"Index was built with k={image.k}, not k={args.kmer_size}")
        return 1
    log.info("Finished reading index!")
    log.info("Analyzing de Bruijn graph")
    log.info("%d transcripts total", image.n_tx)
    write_mappability_tsv(image, outdir)
    return 0


def cmd_idxstats(args) -> int:
    from .serde import load_index

    image = load_index(args.index)
    lens = np.diff(image.ec_offsets.astype(np.int64))
    out = sys.stdout
    for n in range(image.n_nodes):
        out.write(f"{n}\t{int(image.node_len[n])}\t{int(lens[image.node_ec[n]])}\n")
    return 0


def cmd_inspect(args) -> int:
    from .serde import load_index

    image = load_index(args.index)
    for key, val in image.stats().items():
        print(f"{key}\t{val}")
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    logging.basicConfig(
        level=os.environ.get("PSEUDOALIGNER_LOG", "INFO").upper(),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        stream=sys.stderr,
    )
    log.info("Command line args:\n%r", args)

    outdir = getattr(args, "outdir", None) or os.getcwd()
    os.makedirs(outdir, exist_ok=True)

    if args.cmd in ("map", "count", "mappability"):
        import jax

        from .backend import check_platform, cpu_requested, describe

        try:
            check_platform(jax.default_backend(), cpu_requested())
        except RuntimeError as e:
            sys.stderr.write(f"pseudoaligner: {e}\n")
            return 1
        log.info("devices: %s", describe())
        # device-compiling subcommands: repeat invocations load the
        # kernel executable from the persistent cache instead of
        # recompiling (jaxcache.py; the reference's index/map decoupling
        # applied to the compile artifact)
        from .jaxcache import enable_compilation_cache

        enable_compilation_cache()

    if not _check_k(args.kmer_size):
        return 0
    if args.cmd == "index":
        return cmd_index(args)
    if args.cmd == "map":
        return cmd_map(args, outdir)
    if args.cmd == "count":
        return cmd_count(args, outdir)
    if args.cmd == "mappability":
        return cmd_mappability(args, outdir)
    if args.cmd == "idxstats":
        return cmd_idxstats(args)
    if args.cmd == "inspect":
        return cmd_inspect(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
