#!/usr/bin/env python3
"""Bring-up check: the pseudoaligner's user path on one NVIDIA GPU.

Runs in ONE process (the CLI is called in-process through
`pseudoaligner_tpu.cli.main`; only `nvidia-smi` runs as a child):

  device       platform, device kind and count, JAX version, the card's
               name and power limit, which native host components loaded
  index        seeded GENCODE-format transcriptome (~100 Mb of novel
               sequence, about 100M distinct 20-mers) through `index`
  map          2,000,000 single-end reads, L=100, through `map --tcc`
  paired       500,000 pairs, 2x100, through `map r1 r2`
  count        10x v3 shape (R1 16+12 bp, R2 91 bp), 500,000 pairs over
               2,000 Zipf-sized cells, 100,000-barcode whitelist
  oracle       bit-exact comparison with golden.py: 10,000 reads and
               2,000 pairs of the above, then every read of a
               bundled-size set (1,832 transcripts, 9,309 reads)
  mappability  `mappability` on the bundled-size index

Every phase prints one JSON line naming the card.  The last line is
`{"ok": true, "device": {...}}`; a failed phase, or a JAX with no GPU,
ends the process with a non-zero code before that line is printed.

`--devices 4` runs only the multi-card path instead: one 100 Mb index
mapped on gpu:0 by a single-card aligner, by the replicated
`ShardedAligner` and by the k-mer-partitioned `KmerPartitionedAligner
(shard_graph=True)` over four cards, the latter also with its flagged
reads re-mapped by its own exact pass (as on a host without the native
mapper); per-read records must be identical.

Usage: python chip_smoke.py [--devices 4] [--novel-mb 100] [--seed 0]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

READ_LEN = 100  # every phase's read length (R2 of count: 91)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, default=1, choices=(1, 4))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--novel-mb", type=float, default=100.0)
    p.add_argument("--reads", type=int, default=2_000_000)
    p.add_argument("--pairs", type=int, default=500_000)
    p.add_argument("--count-pairs", type=int, default=500_000)
    p.add_argument("--cells", type=int, default=2_000)
    p.add_argument("--whitelist", type=int, default=100_000)
    p.add_argument("--oracle-reads", type=int, default=10_000)
    p.add_argument("--oracle-pairs", type=int, default=2_000)
    p.add_argument("--bundled-tx", type=int, default=None,
                   help="transcripts of the bundled-size set (default "
                        "1,832)")
    p.add_argument("--bundled-reads", type=int, default=None,
                   help="reads of the bundled-size set (default 9,309)")
    p.add_argument("--batch-size", type=int, default=65536)
    p.add_argument("--workdir", default=os.path.join(HERE, ".smoke_work"))
    return p.parse_args(argv)


def check_device(platform: str) -> None:
    """Raise unless JAX's platform is the GPU."""
    if platform != "gpu":
        raise RuntimeError(
            f"chip_smoke needs a GPU; JAX's platform is {platform!r}")


def result_line(device: dict) -> str:
    """The last line of the output: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}})


def card_info() -> str:
    """`nvidia-smi`'s name and power limit of every card, one per line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def native_components() -> dict:
    """Which C++ host components load on this host (False = the Python
    fallback would serve)."""
    from pseudoaligner_tpu.index import native as nb
    from pseudoaligner_tpu.io import native as nio
    from pseudoaligner_tpu.ops import native as nop

    out = {}
    for name, load in (("builder", nb._load), ("parser", nio._load),
                       ("mapper", nop._load), ("gzstream", nio._load_gz)):
        try:
            load()
            out[name] = True
        except Exception as e:  # reported, and fails the device phase
            out[name] = f"{type(e).__name__}: {e}"
    return out


class _ServeInit(logging.Handler):
    """Collects the CLI's `serve init` log records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.seconds: list[float] = []

    def emit(self, rec):
        if rec.msg.startswith("serve init"):
            self.seconds.append(float(rec.args[0]))


@contextlib.contextmanager
def _stdout_to(path: str):
    with open(path, "wb") as raw:
        out = io.TextIOWrapper(raw, encoding="utf-8", write_through=True)
        old, sys.stdout = sys.stdout, out
        try:
            yield
        finally:
            out.flush()
            sys.stdout = old
            out.detach()


def _peak_bytes() -> list:
    import jax

    return [(d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in jax.local_devices()]


def golden_line(golden, rid: str, read, cfg) -> str:
    """The reference-format record golden.py gives for one read."""
    from pseudoaligner_tpu.models.aligner import ReadRecord

    r = golden.map_read_with_mismatch(read, cfg.allowed_mismatches)
    if r is None:
        return ReadRecord(False, rid, [], 0).format_reference_style()
    eq, cov, _mm = r
    return ReadRecord(cov >= cfg.read_coverage_threshold and not eq, rid,
                      eq, cov).format_reference_style()


def golden_pair_line(golden, rid: str, r1, r2, cfg) -> str:
    """Paired record: mates' classes intersected, coverage summed (the
    semantics of Pseudoaligner.map_fastq_paired)."""
    from pseudoaligner_tpu.golden import intersect
    from pseudoaligner_tpu.models.aligner import ReadRecord

    mates = []
    for read in (r1, r2):
        r = golden.map_read_with_mismatch(read, cfg.allowed_mismatches)
        mates.append(([], 0) if r is None else (r[0], r[1]))
    (ea, ca), (eb, cb) = mates
    if ca and cb:
        eq = intersect(list(ea), eb)
    else:
        eq = ea if ca else eb if cb else []
    cov = ca + cb
    return ReadRecord(cov >= cfg.read_coverage_threshold and not eq, rid,
                      eq, cov).format_reference_style()


class Smoke:
    def __init__(self, opts, card: str):
        self.o = opts
        self.card = card
        self.w = opts.workdir
        self.serve = _ServeInit()
        logging.getLogger("pseudoaligner_tpu").addHandler(self.serve)

    def report(self, phase: str, **numbers) -> None:
        print(json.dumps({"phase": phase, **numbers, "card": self.card}),
              flush=True)

    def path(self, name: str) -> str:
        return os.path.join(self.w, name)

    def cli(self, argv, stdout=None) -> dict:
        """cli.main in-process; returns wall seconds, serve-init seconds
        and the compile events of the call."""
        from pseudoaligner_tpu import cli
        from pseudoaligner_tpu.coldstart import JitEventMonitor

        n_init = len(self.serve.seconds)
        mon = JitEventMonitor().start()
        t0 = time.perf_counter()
        try:
            with (_stdout_to(stdout) if stdout else contextlib.nullcontext()):
                rc = cli.main([str(a) for a in argv])
        finally:
            mon.stop()
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"cli {argv[0]} exited {rc}")
        jit = mon.summary()
        init = self.serve.seconds[n_init:]
        return {"wall_s": wall, "serve_init_s": init[0] if init else None,
                "compile_s": jit["xla_compile_s"],
                "cache_hits": jit["cache_hits"],
                "cache_misses": jit["cache_misses"]}

    def _map_args(self):
        return ["--batch-size", self.o.batch_size,
                "--max-read-len", READ_LEN]

    # -- phases ----------------------------------------------------------

    def index(self):
        from pseudoaligner_tpu import synth
        from pseudoaligner_tpu.serde import load_index

        t0 = time.perf_counter()
        self.seqs, names, gmap = synth.transcriptome(
            novel_bases=int(self.o.novel_mb * 1e6), seed=self.o.seed + 99)
        synth.write_fasta(self.path("tx.fa"), self.seqs, names, gmap)
        gen_s = time.perf_counter() - t0
        self.idx = self.path("tx.idx")
        t = self.cli(["index", "-n", os.cpu_count(), "-i", self.idx,
                      self.path("tx.fa")])
        self.image = load_index(self.idx)
        st = self.image.stats()
        self.report("index", novel_mb=self.o.novel_mb,
                    transcripts=st["n_tx"],
                    bases=int(sum(len(s) for s in self.seqs)),
                    generate_s=gen_s, build_s=t["wall_s"],
                    kmers=st["n_kmers"], nodes=st["n_nodes"],
                    ecs=st["n_eq_classes"])

    def map(self):
        from pseudoaligner_tpu import synth

        self.reads = synth.reads(self.seqs, self.o.reads, READ_LEN,
                                 seed=self.o.seed)
        synth.write_fastq(self.path("r.fq"), self.reads)
        t = self.cli(["map", "-i", self.idx, self.path("r.fq"),
                      *self._map_args(), "--tcc", "-o", self.path("tcc")],
                     stdout=self.path("map.out"))
        n = sum(1 for _ in open(self.path("map.out"), "rb"))
        if n != self.o.reads:
            raise RuntimeError(f"map wrote {n} records for {self.o.reads}")
        self.report("map", reads=n, reads_per_s=n / t["wall_s"], **t,
                    peak_bytes_in_use=_peak_bytes(),
                    step_memory=self.step_memory())

    def step_memory(self) -> dict:
        """compiled.memory_analysis() of the serving map step at the
        CLI's shape."""
        from pseudoaligner_tpu import cli
        from pseudoaligner_tpu.models.aligner import (
            _MAP_STEP_JIT, Pseudoaligner)
        from pseudoaligner_tpu.ops.map_kernel import (
            lens_link_dtype, pack_reads_host)

        args = argparse.Namespace(batch_size=self.o.batch_size,
                                  max_read_len=READ_LEN)
        al = Pseudoaligner(self.image, cli._serving_config(self.image.k,
                                                           args))
        B, L = self.o.batch_size, READ_LEN
        packed = pack_reads_host(np.zeros((B, L), np.uint8))
        lens = np.full(B, L, lens_link_dtype(L))
        ma = _MAP_STEP_JIT.lower(al.meta, al.dev, packed,
                                 lens).compile().memory_analysis()
        al.close()
        return {k: int(getattr(ma, k)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(ma, k)}

    def paired(self):
        from pseudoaligner_tpu import synth

        self.r1, self.r2 = synth.pairs(self.seqs, self.o.pairs,
                                       READ_LEN, seed=self.o.seed + 1)
        synth.write_fastq(self.path("p1.fq"), self.r1, "p")
        synth.write_fastq(self.path("p2.fq"), self.r2, "p")
        t = self.cli(["map", "-i", self.idx, self.path("p1.fq"),
                      self.path("p2.fq"), *self._map_args()],
                     stdout=self.path("paired.out"))
        n = sum(1 for _ in open(self.path("paired.out"), "rb"))
        if n != self.o.pairs:
            raise RuntimeError(f"paired wrote {n} records for "
                               f"{self.o.pairs}")
        self.report("paired", pairs=n, pairs_per_s=n / t["wall_s"], **t,
                    peak_bytes_in_use=_peak_bytes())

    def count(self):
        from pseudoaligner_tpu import synth

        r1, r2, cells = synth.count_inputs(
            self.seqs, self.o.count_pairs, self.o.cells, r2_len=91,
            seed=self.o.seed + 2)
        synth.write_fastq(self.path("c1.fq"), r1, "c")
        synth.write_fastq(self.path("c2.fq"), r2, "c")
        wl = synth.whitelist(cells, self.o.whitelist, seed=self.o.seed + 3)
        with open(self.path("wl.txt"), "w") as f:
            f.write("\n".join(wl) + "\n")
        out = self.path("count")
        t = self.cli(["count", "-i", self.idx, self.path("c1.fq"),
                      self.path("c2.fq"), "-o", out, "--whitelist",
                      self.path("wl.txt"), "--umi-dedup", "directional",
                      *self._map_args()])
        called = set(open(os.path.join(out, "barcodes.tsv")).read().split())
        true = {synth.ACGT[c].tobytes().decode() for c in cells}
        # a read error can turn a cell's barcode into another whitelist
        # entry only when the two differ by one base: rare, not never
        if not called <= set(wl) or len(called & true) < 0.99 * len(true):
            raise RuntimeError("count did not recover the cells")
        with open(os.path.join(out, "matrix.mtx")) as f:
            f.readline(), f.readline()
            n_cells, n_classes, nnz = map(int, f.readline().split())
            molecules = sum(int(line.split()[2]) for line in f)
        if n_cells != len(called) or molecules <= 0:
            raise RuntimeError("count matrix does not match its barcodes")
        self.report("count", pairs=self.o.count_pairs,
                    pairs_per_s=self.o.count_pairs / t["wall_s"], **t,
                    cells=n_cells, classes=n_classes, nonzero=nnz,
                    molecules=molecules, peak_bytes_in_use=_peak_bytes())

    def oracle(self):
        from pseudoaligner_tpu import cli, synth
        from pseudoaligner_tpu.dna import encode_bases
        from pseudoaligner_tpu.golden import GoldenAligner
        from pseudoaligner_tpu.io.fasta import read_transcripts
        from pseudoaligner_tpu.io.fastq import read_fastq_records
        from pseudoaligner_tpu.serde import load_index

        args = argparse.Namespace(batch_size=self.o.batch_size,
                                  max_read_len=READ_LEN)
        cfg = cli._serving_config(self.image.k, args)
        rng = np.random.default_rng(self.o.seed + 4)
        t0 = time.perf_counter()
        golden = GoldenAligner(self.image, lazy=True)
        bad = 0
        lines = open(self.path("map.out")).read().splitlines()
        for i in np.sort(rng.choice(self.o.reads, self.o.oracle_reads,
                                    replace=False)):
            bad += golden_line(golden, f"r{i}", self.reads[i],
                               cfg) != lines[i]
        lines = open(self.path("paired.out")).read().splitlines()
        for i in np.sort(rng.choice(self.o.pairs, self.o.oracle_pairs,
                                    replace=False)):
            bad += golden_pair_line(golden, f"p{i}", self.r1[i], self.r2[i],
                                    cfg) != lines[i]
        sample_s = time.perf_counter() - t0

        # the bundled-size set, every read
        fa, fq = synth.write_bundled(self.path("bundled"), self.o.seed,
                                     n_tx=self.o.bundled_tx,
                                     n_reads=self.o.bundled_reads)
        self.bundled_tx = len(read_transcripts(fa)[0])
        self.bidx = self.path("bundled.idx")
        self.cli(["index", "-i", self.bidx, fa])
        self.cli(["map", "-i", self.bidx, fq, *self._map_args()],
                 stdout=self.path("bundled.out"))
        image = load_index(self.bidx)
        golden = GoldenAligner(image)
        lines = open(self.path("bundled.out")).read().splitlines()
        recs = list(read_fastq_records(fq))
        if len(lines) != len(recs):
            raise RuntimeError("bundled map lost records")
        bad_b = sum(golden_line(golden, rid, encode_bases(seq), cfg) != ln
                    for (rid, seq), ln in zip(recs, lines))
        self.report("oracle", sample_reads=self.o.oracle_reads,
                    sample_pairs=self.o.oracle_pairs, sample_mismatches=bad,
                    sample_golden_s=sample_s, bundled_reads=len(recs),
                    bundled_transcripts=self.bundled_tx,
                    bundled_mismatches=bad_b)
        if bad or bad_b:
            raise RuntimeError(f"{bad + bad_b} records differ from golden")

    def mappability(self):
        out = self.path("mappability")
        t = self.cli(["mappability", "-i", self.bidx, "-o", out])
        rows = open(os.path.join(out, "tx_mappability.tsv")).read()
        n = len(rows.splitlines()) - 1
        if n != self.bundled_tx:
            raise RuntimeError(f"mappability wrote {n} transcript rows")
        self.report("mappability", transcripts=n, wall_s=t["wall_s"])

    def single(self):
        for phase in (self.index, self.map, self.paired, self.count,
                      self.oracle, self.mappability):
            phase()

    # -- four cards --------------------------------------------------------

    def multi(self, n_dev: int):
        """Single card vs replicated vs k-mer-partitioned over n_dev
        cards: per-read records must be identical."""
        import jax

        from pseudoaligner_tpu import cli, synth
        from pseudoaligner_tpu.io.fastq import ReadBatch
        from pseudoaligner_tpu.models.aligner import (
            _MAP_STEP_JIT, Pseudoaligner)
        from pseudoaligner_tpu.ops.map_kernel import (
            exact_meta, pack_reads_host)
        from pseudoaligner_tpu.parallel.mesh import ShardedAligner, make_mesh
        from pseudoaligner_tpu.parallel.sharded_index import (
            KmerPartitionedAligner)

        self.index()
        B, L = self.o.batch_size, READ_LEN
        n = 4 * B
        reads = synth.reads(self.seqs, n, L, seed=self.o.seed)
        synth.write_fastq(self.path("r.fq"), reads)
        args = argparse.Namespace(batch_size=B, max_read_len=L)
        cfg = cli._serving_config(self.image.k, args)
        mesh = make_mesh(n_dev)

        def emit(al):
            buf = io.BytesIO()
            t0 = time.perf_counter()
            flagged = al.emit_fastq(self.path("r.fq"), buf)[1]
            return buf.getvalue(), time.perf_counter() - t0, flagged

        t0 = time.perf_counter()
        kp = KmerPartitionedAligner(self.image, cfg, mesh, shard_graph=True)
        kp_init = time.perf_counter() - t0
        kp_out, kp_s, _ = emit(kp.serving_aligner())
        kp_peak = _peak_bytes()
        # as on a host without the native mapper: the flagged reads are
        # re-mapped exactly by the sharded engine's own pass
        srv = kp.serving_aligner()
        srv._host_mapper_inst = None
        kp_dev_out, kp_dev_s, flagged = emit(srv)
        m = min(n, B)
        lens = np.full(m, L, np.int32)
        exact = jax.device_get(kp.map_exact(reads[:m], lens))

        single = Pseudoaligner(self.image, cfg, device=jax.devices()[0])
        ref, single_s, _ = emit(single)
        want = jax.device_get(_MAP_STEP_JIT(
            exact_meta(single.meta), single.dev,
            pack_reads_host(reads[:m]), lens))
        exact_same = all(np.array_equal(getattr(exact, f), getattr(want, f))
                         for f in ("mapped", "coverage", "mismatches",
                                   "nodes", "n_nodes"))
        single.close()
        del single, kp, srv

        # replicated engine: full-output shape with device EC bitsets
        # (its psum count path); records through a single-card aligner
        # of the same shape
        import dataclasses

        full = dataclasses.replace(cfg, bitset_tx_threshold=1 << 30)
        sa = ShardedAligner(self.image, full, mesh)
        dec = Pseudoaligner(self.image, dataclasses.replace(
            full, distinct_cap=0, max_walk_iters=0, max_left_iters=0,
            max_nodes=sa.meta.max_nodes), device=jax.devices()[0])
        lines = []
        sb = min(8192, n)
        t0 = time.perf_counter()
        for c0 in range(0, n, sb):
            codes = reads[c0:c0 + sb]
            lens = np.full(len(codes), L, np.int32)
            res, _counts = sa.map_batch(codes, lens)
            batch = ReadBatch(codes=codes, lens=lens,
                              ids=[f"r{i}" for i in range(c0, c0 + len(codes))])
            lines += [r.format_reference_style()
                      for r in dec.records_from_result(res, batch)]
        sa_s = time.perf_counter() - t0
        sa_out = ("\n".join(lines) + "\n").encode()
        self.report("multi", devices=n_dev, reads=n,
                    kpart_identical=kp_out == ref,
                    kpart_device_remap_identical=kp_dev_out == ref,
                    kpart_device_remap_flagged=flagged,
                    kpart_exact_reads=m, kpart_exact_identical=exact_same,
                    replicated_identical=sa_out == ref,
                    kpart_init_s=kp_init, kpart_map_s=kp_s,
                    kpart_device_remap_map_s=kp_dev_s,
                    single_map_s=single_s, replicated_map_s=sa_s,
                    kpart_peak_bytes_in_use=kp_peak,
                    peak_bytes_in_use=_peak_bytes())
        if (kp_out != ref or kp_dev_out != ref or not exact_same
                or sa_out != ref):
            raise RuntimeError("multi-card records differ from one card")


def main(argv=None) -> int:
    opts = parse_args(argv)
    import jax

    from pseudoaligner_tpu.backend import describe

    device = describe()
    check_device(device["platform"])
    if device["count"] < opts.devices:
        raise RuntimeError(f"need {opts.devices} devices, JAX has "
                           f"{device['count']}")
    card = card_info()
    print(card)
    card = card.splitlines()[0]
    from pseudoaligner_tpu.jaxcache import enable_compilation_cache

    smoke = Smoke(opts, card)
    native = native_components()
    smoke.report("device", **device, jax=jax.__version__,
                 compilation_cache=enable_compilation_cache(),
                 native=native)
    if not all(v is True for v in native.values()):
        raise RuntimeError("a native host component failed to load")
    shutil.rmtree(opts.workdir, ignore_errors=True)
    os.makedirs(opts.workdir)
    if opts.devices > 1:
        smoke.multi(opts.devices)
    else:
        smoke.single()
    shutil.rmtree(opts.workdir)  # kept on failure, for inspection
    print(result_line(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
