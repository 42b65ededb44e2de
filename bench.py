"""Benchmark: read-mapping throughput (reads/sec) on an NVIDIA GPU.

Workload: a seeded transcriptome of the reference's bundled smoke shape
(pseudoaligner_tpu/synth.py: 1,832 GENCODE-format transcripts, k=20)
with a large deterministic read set (exact 60-mers + 1-SNP variants +
reversed negatives, the small.fq recipe) so the card reaches steady
state.

The reference publishes no benchmark numbers (BASELINE.md).  For
`vs_baseline` we use a fixed nominal 100,000 reads/s — a generous estimate
of the multithreaded reference on a server CPU (kallisto-class throughput,
README.md:3 aspiration) — so the ratio is comparable across rounds.

Prints one JSON line per measured workload — paired_throughput (pairs/s,
emit_fastq_paired end to end), gz_map_throughput, count_throughput
(pairs/s, 10x counting incl. knee call + directional dedup),
scale_throughput (reads/s on a ~27M-kmer synthetic transcriptome, with
serve-init seconds), index_build_s — and LAST the parsed headline:
{"metric": "map_throughput", "value", "unit", "vs_baseline"}.  Secondary
rows degrade to an error row on failure without sinking the headline.
BENCH_PAIRED/BENCH_GZ/BENCH_COUNT/BENCH_SCALE/BENCH_BUILD=0 skip rows.
A run on any backend but the GPU fails instead of measuring the CPU.

Passes: the map headline is adaptive best-of-N (max BENCH_PASSES_MAX,
plus late passes after the rows); workload rows are prepared first, then
scored round-robin over BENCH_ROW_ROUNDS interleaved rounds; all per-pass
values are emitted in the JSON ("passes"/"passes_s").

Self-tune results (walk/left caps, pool_overlap, pipeline depth) persist
in .bench_tune.json keyed by (index digest, shape, candidate set, jaxlib,
device); `--retune` or BENCH_RETUNE=1 forces a re-sweep.  Compiled
executables persist via the XLA compilation cache (jaxcache.py).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from pseudoaligner_tpu import synth

BASELINE_READS_PER_SEC = 100_000.0
_HERE = os.path.dirname(os.path.abspath(__file__))
INDEX_CACHE = os.path.join(_HERE, ".bench_index_k20.bin")
TUNE_CACHE = os.path.join(_HERE, ".bench_tune.json")


def _index_digest(path: str) -> str:
    """Cheap stable identity for an index file: sha256 of the first 1MB
    + the size (the header carries the build's content hashes)."""
    import hashlib

    h = hashlib.sha256()
    try:
        with open(path, "rb") as f:
            h.update(f.read(1 << 20))
        h.update(str(os.path.getsize(path)).encode())
    except OSError:
        return "none"
    return h.hexdigest()[:16]


def _tune_key(B, L, caps, d_cands) -> str:
    """Self-tune results are valid for (index, shape, candidate set,
    jaxlib, device) — any of those changing forces a re-tune."""
    import jax

    dev = jax.devices()[0]
    return json.dumps(
        {
            "index": _index_digest(INDEX_CACHE),
            "B": B,
            "L": L,
            "caps": [list(c) for c in caps],
            "depths": list(d_cands),
            "jax": jax.__version__,
            "device": getattr(dev, "device_kind", str(dev)),
        },
        sort_keys=True,
    )


def _tune_load(key: str):
    try:
        with open(TUNE_CACHE) as f:
            return json.load(f).get(key)
    except Exception:
        return None


def _tune_save(key: str, value: dict) -> None:
    data = {}
    try:
        with open(TUNE_CACHE) as f:
            data = json.load(f)
    except Exception:
        pass
    data[key] = value
    tmp = TUNE_CACHE + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1)
    os.replace(tmp, TUNE_CACHE)


def build_or_load_index():
    from pseudoaligner_tpu.serde import load_index, save_index

    if os.path.exists(INDEX_CACHE):
        try:
            return load_index(INDEX_CACHE)
        except Exception:
            pass
    from pseudoaligner_tpu.index.builder import build_index

    image = build_index(*_bundled_transcripts(), k=20)
    save_index(image, INDEX_CACHE)
    return image


_TX = []


def _bundled_transcripts():
    """The seeded bundled-shape transcriptome (seqs, names, gene map)."""
    if not _TX:
        _TX.append(synth.transcriptome(n_tx=synth.BUNDLED["n_tx"], seed=99))
    return _TX[0]


def synth_reads(image, n_reads, read_len=60, seed=0):
    """Deterministic reads over the bundled-shape transcriptome
    (`synth.reads`).  The default-seed set is disk-cached per shape."""
    cache = os.path.join(_HERE, f".bench_reads_k20_{n_reads}x{read_len}.npy")
    if seed == 0:
        try:
            reads = np.load(cache)
            if reads.shape == (n_reads, read_len):
                return (reads.astype(np.int32),
                        np.full(n_reads, read_len, dtype=np.int32))
        except Exception:
            pass
    reads = synth.reads(_bundled_transcripts()[0], n_reads, read_len,
                        seed=seed).astype(np.int32)
    lens = np.full(n_reads, read_len, dtype=np.int32)
    if seed == 0:
        try:
            np.save(cache, reads.astype(np.uint8))
        except Exception:
            pass
    return reads, lens


def _prep_paired(aligner, n_pairs, workdir):
    """emit_fastq_paired end to end (FASTQ parse -> device map, one
    combined batch per pair -> C++ paired intersection/emit).  Prepares
    inputs + warms, returns a one-timed-pass closure -> pairs/s."""
    r1, r2 = synth.pairs(_bundled_transcripts()[0], n_pairs, 60, seed=1)
    p1 = os.path.join(workdir, "bench_r1.fq")
    p2 = os.path.join(workdir, "bench_r2.fq")
    synth.write_fastq(p1, r1)
    synth.write_fastq(p2, r2)
    devnull = _devnull()
    aligner.emit_fastq_paired(p1, p2, devnull)  # warm/compile

    def one_pass():
        t0 = time.time()
        n = aligner.emit_fastq_paired(p1, p2, devnull)  # returns PAIRS
        return n / (time.time() - t0)

    return one_pass


def _prep_gz(aligner, n_reads, workdir):
    """gz serving row (VERDICT r3 #4): emit_fastq over a gzipped FASTQ
    (stream-decompress -> native scanner) vs the same plain file.
    The file is BGZF (member-per-64KB with the 'BC' size subfield) —
    the common container for real sequencing data (htslib bgzip), and
    what the native source inflates in parallel (VERDICT r4 #5; a
    single-member gz is inherently serial: 170 vs ~950 MB/s reader-only
    on this host).  Returns a closure -> (gz_rps, plain_rps) per pass."""
    from pseudoaligner_tpu.io.fastq import write_bgzf

    codes, _lens = synth_reads(aligner.image, n_reads)
    p = os.path.join(workdir, "bench_gz.fq")
    pgz = p + ".gz"
    synth.write_fastq(p, codes)
    with open(p, "rb") as f:
        write_bgzf(pgz, f.read())
    devnull = _devnull()
    aligner.emit_fastq(p, devnull)  # warm/compile
    aligner.emit_fastq(pgz, devnull)  # warm the gz reader path

    def one_pass():
        t0 = time.time()
        n, _ = aligner.emit_fastq(p, devnull)
        plain = n / (time.time() - t0)
        t0 = time.time()
        n, _ = aligner.emit_fastq(pgz, devnull)
        return n / (time.time() - t0), plain

    return one_pass


def _prep_count(aligner, n_pairs, workdir):
    """count_single_cell end to end (R1 parse + barcode/UMI accounting,
    R2 device map, knee call + 1-Hamming fold, directional molecule
    counts) — the realistic all-in figure.  Closure -> pairs/s."""
    from pseudoaligner_tpu.singlecell import count_single_cell

    r1, r2, _cells = synth.count_inputs(_bundled_transcripts()[0], n_pairs,
                                        400, r2_len=60, seed=2)
    p1 = os.path.join(workdir, "bench_cr1.fq")
    p2 = os.path.join(workdir, "bench_cr2.fq")
    synth.write_fastq(p1, r1)
    synth.write_fastq(p2, r2)
    # small warm run for the count-meta compile (persistent-cached later)
    w = max(1024, aligner.config.batch_size)
    pw1 = os.path.join(workdir, "bench_cw1.fq")
    pw2 = os.path.join(workdir, "bench_cw2.fq")
    synth.write_fastq(pw1, r1[:w])
    synth.write_fastq(pw2, r2[:w])
    count_single_cell(aligner, pw1, pw2, umi_dedup="directional")

    def one_pass():
        t0 = time.time()
        counts = count_single_cell(aligner, p1, p2, umi_dedup="directional")
        counts.cell_totals("directional")
        return n_pairs / (time.time() - t0)

    return one_pass


def _make_rb(codes, ls):
    """Raw-bytes id form (empty ids): the serving fast path the
    FastqReader produces — emit consumes the concat directly."""
    from pseudoaligner_tpu.io.fastq import ReadBatch

    return ReadBatch(codes=codes, lens=ls, ids_concat=b"",
                     id_offs=np.zeros(codes.shape[0] + 1, np.int64))


def _native_available() -> bool:
    try:
        from pseudoaligner_tpu.io import native  # noqa: F401

        return True
    except Exception:
        return False


_DEVNULL = None


def _devnull():
    """One process-wide null sink (each open() leaked an fd per serving
    pass/prep before — review r5)."""
    global _DEVNULL
    if _DEVNULL is None:
        _DEVNULL = open(os.devnull, "wb")
    return _DEVNULL


def serve_pass(aligner, batches, depth=None, devnull=None, has_native=None):
    """One pipelined end-to-end pass (the emit_fastq serving pattern):
    dispatch batch k+1, emit batch k's records natively while the device
    works.  Depth-D deferral on both waits (pipeline.py) keeps the device
    queue full.  Returns (n_done, n_unmapped, seconds)."""
    import jax

    from pseudoaligner_tpu.pipeline import DepthPipeline

    if devnull is None:
        devnull = _devnull()
    if has_native is None:
        has_native = _native_available()
    t0 = time.time()
    n_done = 0
    n_unmapped = 0
    if depth is None:
        depth = getattr(aligner.config, "pipeline_depth", 1)

    def render(st_n):  # ordered single-worker pool (pipeline.py)
        st, n = st_n
        return aligner.emit_finish(aligner.emit_prepare_group(st)), n

    def finish(data_n):
        nonlocal n_done, n_unmapped
        data, n = data_n
        devnull.write(data)
        n_done += n
        n_unmapped += data.count(b", [], ")

    def prepare(item, _nxt):
        res, rb = item
        if has_native:
            return (aligner.emit_prepare(res, rb, defer_group=True),
                    rb.n_reads)
        pipe.drain_prepared()
        recs = aligner.records_from_result(jax.device_get(res), rb)
        nonlocal n_done, n_unmapped
        n_done += len(recs)
        n_unmapped += sum(1 for r in recs if not r.eq_class)
        return None

    pipe = DepthPipeline(depth, prepare, finish, render=render)
    for codes, ls in batches:
        fut = aligner.map_batch_device(codes, ls)
        pipe.push((fut, _make_rb(codes, ls)))
    pipe.close()
    return n_done, n_unmapped, time.time() - t0


# --- GENCODE-order scale row (synthetic ~27M distinct k-mers) ---
#
# BENCH_SCALE_MODE selects the scale workload:
#   default — ~27M-kmer k=20 transcriptome, L=60 reads
#   k64     — k=64 index (4-word kmers), L=96 reads
#   csr200k — 200,000 short transcripts (> bitset_tx_threshold, so the
#             CSR-merge EC path serves), k=20, L=60

SCALE_MODE = os.environ.get("BENCH_SCALE_MODE", "default")
_SCALE_SUFFIX = "" if SCALE_MODE == "default" else f"_{SCALE_MODE}"
SCALE_INDEX_CACHE = os.path.join(_HERE, f".bench_scale_index{_SCALE_SUFFIX}.bin")
SCALE_READS_CACHE = os.path.join(_HERE, f".bench_scale_reads{_SCALE_SUFFIX}.npy")
SCALE_K = 64 if SCALE_MODE == "k64" else 20
SCALE_L = 96 if SCALE_MODE == "k64" else 60


def build_or_load_scale(n_reads, read_len=60):
    """Scale index + read set, built once and cached on disk (the index
    file is the checkpointed artifact, as for the bundled index).  The
    sidecar meta file keys the cache on (mode, MB) so changing
    BENCH_SCALE_MB/BENCH_SCALE_MODE rebuilds instead of silently serving
    the old workload."""
    from pseudoaligner_tpu.serde import load_index, save_index

    scale_mb = os.environ.get("BENCH_SCALE_MB", "27")
    meta_path = SCALE_INDEX_CACHE + ".meta.json"
    # index validity (mode/MB meta) is decoupled from the read-set shape:
    # a different n_reads/read_len (BENCH_SCALE_BATCHES, BENCH_BATCH) used
    # to trigger a full ~60-90s index rebuild when only the cheap seeded
    # read recipe needed regenerating (review r5)
    index_ok = False
    if os.path.exists(SCALE_INDEX_CACHE):
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            index_ok = (meta.get("mode") == SCALE_MODE
                        and meta.get("mb") == scale_mb
                        and "build_s" in meta)  # pre-r5 caches lack the
            # build time the index_build_s row reports: rebuild once
        except Exception:
            index_ok = False
    if index_ok and os.path.exists(SCALE_READS_CACHE):
        try:
            reads = np.load(SCALE_READS_CACHE)
            if (reads.shape[0] == n_reads  # exact: recipe mix is
                    and reads.shape[1] == read_len):  # positioned by n
                return load_index(SCALE_INDEX_CACHE), reads
        except Exception:
            pass

    if SCALE_MODE == "csr200k":
        rng = np.random.default_rng(17)
        seqs = [rng.integers(0, 4, int(rng.integers(120, 400))).astype(np.uint8)
                for _ in range(200_000)]
        names = [f"t{i}" for i in range(len(seqs))]
        gene_map = {n_: f"g{i % 9973}" for i, n_ in enumerate(names)}
    else:
        total = int(float(os.environ.get("BENCH_SCALE_MB", 27)) * 1e6)
        seqs, names, gene_map = synth.transcriptome(novel_bases=total)
    if not index_ok:
        from pseudoaligner_tpu.index.builder import build_index

        t_build = time.time()
        image = build_index(seqs, names, gene_map, k=SCALE_K)
        build_s = time.time() - t_build
        save_index(image, SCALE_INDEX_CACHE)
        with open(meta_path, "w") as f:
            json.dump({"mode": SCALE_MODE, "mb": scale_mb,
                       "build_s": round(build_s, 1),
                       "n_kmers": int(image.mphf.n_keys)}, f)
    reads = synth.reads(seqs, n_reads, read_len, seed=3)
    np.save(SCALE_READS_CACHE, reads.astype(np.uint8))
    # return the RELOADED image, not the in-memory build: source_ident
    # (set by load_index) keys the devcache + packed sidecar, so the
    # fresh-build run also populates the serve-init caches instead of
    # leaving them for the next run to build at full cost
    return load_index(SCALE_INDEX_CACHE), np.load(SCALE_READS_CACHE)


def _prep_scale(B, cap, depth, n_batches):
    """Serve the scale index: returns (one_pass closure -> reads/s,
    serve_init_s, n_kmers).  serve_init covers aligner construction (C++
    cuckoo build), the HBM table upload and the first (compile) batch.
    Reads are SCALE_L wide (k64 mode needs reads longer than k) — the
    headline L does not apply here (review r5: a dead L parameter
    suggested otherwise)."""
    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.models.aligner import Pseudoaligner

    L = SCALE_L
    image, reads = build_or_load_scale(B * (n_batches + 1), read_len=L)
    wcap, lcap, po = cap
    t0 = time.time()
    al = Pseudoaligner(image, AlignerConfig(
        k=SCALE_K, batch_size=B, max_read_len=L,
        max_nodes=wcap + lcap + 2, distinct_cap=3,
        max_walk_iters=wcap, max_left_iters=lcap, pool_overlap=po,
    ))
    lens = np.full(B, L, dtype=np.int32)
    batches = [
        (reads[i * B:(i + 1) * B].astype(np.int32), lens)
        for i in range(n_batches + 1)
    ]
    serve_pass(al, batches[:1], depth=1)  # cuckoo + upload + compile
    init_s = time.time() - t0
    serve_pass(al, batches[1:], depth=depth)  # warm (signature caches)

    def one_pass():
        n, _, dt = serve_pass(al, batches[1:], depth=depth)
        return n / dt

    return one_pass, init_s, int(image.mphf.n_keys)


def _fail(msg: str) -> int:
    """One machine-readable line + rc=1 — never a traceback wall."""
    print(json.dumps({
        "metric": "map_throughput", "value": 0, "unit": "reads/s",
        "vs_baseline": 0.0, "error": msg,
    }))
    return 1


def main():
    t_setup = time.time()
    import jax

    from pseudoaligner_tpu.backend import describe
    from pseudoaligner_tpu.coldstart import JitEventMonitor
    from pseudoaligner_tpu.config import AlignerConfig
    from pseudoaligner_tpu.jaxcache import enable_compilation_cache
    from pseudoaligner_tpu.models.aligner import Pseudoaligner

    device = describe()
    if device["platform"] != "gpu":
        return _fail(f"bench.py measures the GPU; JAX's platform is "
                     f"{device['platform']!r}")
    enable_compilation_cache()
    init_s = time.time() - t_setup
    jitmon = JitEventMonitor().start()

    _marks = [("init", time.time())]

    def _mark(name):
        _marks.append((name, time.time()))

    image = build_or_load_index()
    _mark("index")

    B = int(os.environ.get("BENCH_BATCH", 65536))
    L = 60
    n_batches = int(os.environ.get("BENCH_BATCHES", 16))
    if "BENCH_WALK_CAP" in os.environ:
        caps = [(int(os.environ["BENCH_WALK_CAP"]),
                 int(os.environ.get("BENCH_LEFT_CAP", 2)), False)]
    else:
        # self-tune (walk cap, left cap, pool_overlap): the host-remap
        # overlap shifts the cap optimum; a candidate that fails to
        # compile/run is skipped below.  Lanes a cap cuts take the exact
        # -3 host remap, so every candidate's output is identical.
        caps = [(2, 2, False), (3, 2, False), (2, 2, True), (2, 1, False)]
    # serving shape: compact EC output at distinct_cap=3 (>3-class reads
    # take the overlapped host remap), node buffer sized to the push bound
    # wcap + lcap (one push per capped iteration) plus 2 slack — lanes
    # that outgrow it are -3-flagged exactly (kernel guard)
    def _mk_aligner(wcap, lcap, po):
        return Pseudoaligner(image, AlignerConfig(
            k=20, batch_size=B, max_read_len=L,
            max_nodes=wcap + lcap + 2, distinct_cap=3,
            max_walk_iters=wcap, max_left_iters=lcap, pool_overlap=po,
        ))

    # tune-cache lookup FIRST: a hit builds (and uploads) only the one
    # winning candidate instead of all of them.  Depth candidates reach 8:
    # deeper in-flight queues measured a consistent paired win (604->639k,
    # round 3) and the sweep is host-side (no recompile, ~1s/candidate)
    d_cands = (2, 3, 4, 6, 8)
    tune_key = _tune_key(B, L, caps, d_cands)
    retune = "--retune" in sys.argv[1:] or os.environ.get("BENCH_RETUNE") == "1"
    tuned = None if retune else _tune_load(tune_key)
    if tuned is not None and tuple(tuned["cap"]) not in [tuple(c) for c in caps]:
        tuned = None
    if tuned is not None:
        best_cap = tuple(tuned["cap"])
        aligners = [_mk_aligner(*best_cap)]
    else:
        aligners = [_mk_aligner(*c) for c in caps]
        best_cap = tuple(caps[0])
    aligner = aligners[0]
    _mark("aligners(table build+upload)")

    # read synthesis overlaps the first (compile/backend-load-bound)
    # batch on a background thread — the device_get wait releases the
    # GIL, so the minutes-long cold path absorbs the reads cost for free
    import threading

    _reads_box = {}

    def _synth():
        try:
            _reads_box["rl"] = synth_reads(image, B * (n_batches + 1))
        except BaseException as e:  # re-raised on the main thread below
            _reads_box["err"] = e

    _synth_th = threading.Thread(target=_synth, daemon=True)
    _synth_th.start()

    # warmup / compile on an all-zeros batch (shape-identical, so the
    # compiled executable is the serving one); dispatch vs fetch timed
    # separately: the first dispatch contains trace+lower+compile/
    # cache-load, the fetch is execute+transfer
    z_codes = np.zeros((B, L), np.uint8)
    z_lens = np.full(B, L, np.int32)
    _t0 = time.time()
    _res0 = aligner.map_batch_device(z_codes, z_lens)
    first_dispatch_s = time.time() - _t0
    _t0 = time.time()
    r0 = jax.device_get(_res0)
    first_fetch_s = time.time() - _t0
    aligner.records_from_result(r0, _make_rb(z_codes, z_lens))
    _mark("first batch (compile/cache-load)")
    jit_first = jitmon.summary()  # events up to here = the first batch's

    _synth_th.join()
    if "err" in _reads_box:
        raise _reads_box["err"]
    reads, lens = _reads_box["rl"]
    batches = [
        (reads[i * B : (i + 1) * B], lens[i * B : (i + 1) * B])
        for i in range(n_batches + 1)
    ]
    _mark("reads (overlapped)")

    # pipelined end-to-end: dispatch batch k+1, then emit batch k's records
    # natively while the device works (the emit_fastq serving pattern)
    devnull = open(os.devnull, "wb")
    has_native = _native_available()

    def timed_pass(depth=None):
        return serve_pass(aligner, batches[1:], depth, devnull, has_native)

    # one untimed warm pass per candidate config (compiles the programs and
    # fills the signature caches), then one scored pass each to pick the
    # walk cap, then best-of-N timed passes with the winner.
    # Tune results persist in .bench_tune.json keyed by (index digest,
    # shape, candidate set, jaxlib, device) — a later run with the same key
    # skips the sweeps entirely (`--retune` / BENCH_RETUNE=1 to force).
    if tuned is not None:
        best_depth = int(tuned["depth"])
        sys.stderr.write(
            f"bench: tune cache hit -> cap {best_cap} depth "
            f"{best_depth} (--retune to re-sweep)\n"
        )
        timed_pass()  # warm/compile (persistent-cache load or compile)
    else:
        if len(aligners) > 1:
            scores = []
            for al in aligners:
                aligner = al
                try:
                    timed_pass()  # warm/compile
                    # min-of-2 scored passes
                    dt_i = min(timed_pass()[2], timed_pass()[2])
                except Exception as e:  # candidate failed (e.g. a backend
                    # compile issue for an experimental layout): skip it
                    sys.stderr.write(f"bench: candidate failed, skipping: {e}\n")
                    dt_i = float("inf")
                scores.append(dt_i)
            best_i = scores.index(min(scores))
            aligner = aligners[best_i]
            sys.stderr.write(
                f"bench: walk-cap self-tune {list(zip(caps, [f'{s:.2f}s' for s in scores]))}"
                f" -> cap {caps[best_i]}\n"
            )
            # release the losers' worker pools AND their device tables
            # (the scale phase uploads a second set to the same card);
            # None keeps list positions for the best_cap index lookup
            for i in range(len(aligners)):
                if i != best_i:
                    aligners[i].close()
                    aligners[i] = None
        else:
            timed_pass()
        best_cap = tuple(caps[aligners.index(aligner)])
        # depth self-tune: in-flight depth is host-side (no recompile)
        d_scores = [timed_pass(depth=d)[2] for d in d_cands]
        best_depth = d_cands[d_scores.index(min(d_scores))]
        sys.stderr.write(
            f"bench: depth self-tune {list(zip(d_cands, [f'{s:.2f}s' for s in d_scores]))}"
            f" -> depth {best_depth}\n"
        )
        _tune_save(tune_key, {"cap": list(best_cap), "depth": best_depth})
    _mark("tune/warm")
    sys.stderr.write("bench: setup phases " + ", ".join(
        f"{name} {_marks[i + 1][1] - _marks[i][1]:.1f}s"
        for i, (name, _) in enumerate(_marks[1:])
    ) + "\n")
    jitmon.stop()
    jit_summary = jitmon.summary()
    setup_breakdown = {
        name: round(_marks[i + 1][1] - _marks[i][1], 1)
        for i, (name, _) in enumerate(_marks[1:])
    }
    setup_breakdown.update({
        "first_dispatch_s": round(first_dispatch_s, 1),
        "first_fetch_s": round(first_fetch_s, 1),
        "jit_first_batch": jit_first,
        "jit_setup_total": jit_summary,
    })
    sys.stderr.write(
        f"bench: first batch split: dispatch {first_dispatch_s:.1f}s "
        f"(trace {jit_first['trace_s']}s + lower {jit_first['lower_s']}s"
        f" + xla-compile {jit_first['xla_compile_s']}s, persistent cache "
        f"{jit_first['cache_hits']} hits/{jit_first['cache_misses']} "
        f"misses; the unexplained dispatch remainder is the backend's "
        f"server-side program load), fetch {first_fetch_s:.1f}s\n"
    )
    setup_s = time.time() - t_setup

    # --- map headline: adaptive best-of-N: keep sampling until the best
    # pass has gone `stall` consecutive passes without improving (min
    # BENCH_PASSES, max BENCH_PASSES_MAX).  Three more passes run AFTER
    # the workload rows and merge into the same best. ---
    n_min = max(2, int(os.environ.get("BENCH_PASSES", 3)))
    n_max = max(n_min, int(os.environ.get("BENCH_PASSES_MAX", 10)))
    stall = 2
    dts = []
    n_done = n_unmapped = 0
    while len(dts) < n_max:
        try:
            n_done, n_unmapped, dt_i = timed_pass(depth=best_depth)
        except Exception as e:
            # same guarded contract as the late passes below: once ONE
            # pass is in, a transient failure must not discard it
            if not dts:
                raise
            sys.stderr.write(f"bench: headline pass failed, keeping "
                             f"{len(dts)} earlier passes: "
                             f"{type(e).__name__}: {e}\n")
            break
        dts.append(dt_i)
        if len(dts) >= n_min and len(dts) - 1 - dts.index(min(dts)) >= stall:
            break
    n_mapped = n_done - n_unmapped

    # --- secondary workload rows (paired / gz / count / scale):
    # prepare every row first (inputs + warm), then score them
    # round-robin.  Row value = best of BENCH_ROW_ROUNDS interleaved
    # passes; the per-pass values go into the JSON.  A failure degrades
    # to an error row without sinking the run.  map_throughput prints LAST (the parsed headline).
    rows = []
    # emit loops read pipeline_depth off the config; apply today's tuned
    # depth (host-side only — no recompile, see config.pipeline_depth)
    object.__setattr__(aligner.config, "pipeline_depth", best_depth)
    workdir = os.environ.get("BENCH_WORKDIR", "/tmp")

    row_extra: dict = {}
    specs = []
    if os.environ.get("BENCH_PAIRED", "1") == "1":
        specs.append(("paired_throughput", "pairs/s", lambda: _prep_paired(
            aligner, int(os.environ.get("BENCH_PAIRS", (B // 2) * 8)),
            workdir)))
    if os.environ.get("BENCH_GZ", "1") == "1":
        specs.append(("gz_map_throughput", "reads/s", lambda: _prep_gz(
            aligner, int(os.environ.get("BENCH_GZ_READS", B * 8)), workdir)))
    if os.environ.get("BENCH_COUNT", "1") == "1":
        specs.append(("count_throughput", "pairs/s", lambda: _prep_count(
            aligner, int(os.environ.get("BENCH_COUNT_PAIRS", B * 8)),
            workdir)))
    if os.environ.get("BENCH_SCALE", "1") == "1":
        def _scale_prep():
            fn, sinit_s, n_kmers = _prep_scale(
                B, best_cap, best_depth,
                int(os.environ.get("BENCH_SCALE_BATCHES", 8)))
            row_extra["scale_throughput"] = {
                "n_kmers": n_kmers, "serve_init_s": round(sinit_s, 1),
                "mode": SCALE_MODE}
            return fn
        specs.append(("scale_throughput", "reads/s", _scale_prep))

    pass_fns: dict = {}
    errors: dict = {}
    for name, _unit, prep in specs:
        try:
            pass_fns[name] = prep()
        except Exception as e:
            errors[name] = e
    rounds = int(os.environ.get("BENCH_ROW_ROUNDS", 4))
    vals: dict = {name: [] for name in pass_fns}
    for _r in range(rounds):
        for name in list(pass_fns):
            try:
                vals[name].append(pass_fns[name]())
            except Exception as e:
                errors[name] = e
                del pass_fns[name]

    # late map passes: same engine, later in the run.  Guarded: the early
    # passes already carry the measurement, so a failure HERE must not
    # sink the headline (the rows degrade to error rows —
    # the headline keeps the same contract).
    for _ in range(3):
        try:
            _nd, _nu, dt_i = timed_pass(depth=best_depth)
        except Exception as e:
            sys.stderr.write(f"bench: late pass failed, keeping early "
                             f"passes: {type(e).__name__}: {e}\n")
            break
        dts.append(dt_i)
    dt = min(dts)
    rps = n_done / dt
    sys.stderr.write(
        f"bench: {n_done} reads end-to-end in {dt:.3f}s (passes "
        f"{'/'.join(f'{x:.2f}' for x in dts)}) on {jax.devices()[0]} "
        f"({n_mapped / n_done:.1%} mapped, setup "
        f"{setup_s - init_s:.1f}s + backend "
        f"{init_s:.1f}s)\n"
    )

    for name, unit, _prep in specs:
        vlist = vals.get(name) or []
        if not vlist:
            # no recorded error + no passes (e.g. BENCH_ROW_ROUNDS=0)
            # must still degrade to an error row, not a KeyError
            e = errors.get(name)
            msg = (f"{type(e).__name__}: {e}" if e is not None
                   else "no passes ran")
            rows.append({"metric": name, "value": 0, "unit": unit,
                         "vs_baseline": 0.0, "error": msg})
            continue
        if name == "gz_map_throughput":
            gz_list = [v[0] for v in vlist]
            plain_list = [v[1] for v in vlist]
            v = max(gz_list)
            row = {"metric": name, "value": round(v, 1), "unit": unit,
                   "vs_baseline": round(v / BASELINE_READS_PER_SEC, 3),
                   "plain_ratio": round(v / max(plain_list), 3),
                   "passes": [round(x, 1) for x in gz_list],
                   "plain_passes": [round(x, 1) for x in plain_list]}
        else:
            v = max(vlist)
            row = {"metric": name, "value": round(v, 1), "unit": unit,
                   "vs_baseline": round(v / BASELINE_READS_PER_SEC, 3),
                   "passes": [round(x, 1) for x in vlist]}
        row.update(row_extra.get(name, {}))
        if name in errors:
            e = errors[name]
            row["note"] = f"a later pass failed: {type(e).__name__}: {e}"
        rows.append(row)

    # index-build row (VERDICT r4 #7): build time is a first-class
    # reference command (src/bin/pseudoaligner.rs:98-130 `index`) — a
    # fresh bundled build every run, plus the scale index's build time
    # recorded by build_or_load_scale at its actual build.
    if os.environ.get("BENCH_BUILD", "1") == "1":
        try:
            from pseudoaligner_tpu.index.builder import build_index

            t0 = time.time()
            img_b = build_index(*_bundled_transcripts(), k=20)
            bundled_s = time.time() - t0
            scale_meta = {}
            try:
                with open(SCALE_INDEX_CACHE + ".meta.json") as f:
                    scale_meta = json.load(f)
            except Exception:
                pass
            rows.append({
                "metric": "index_build_s", "value": round(bundled_s, 2),
                "unit": "s", "n_kmers": int(img_b.mphf.n_keys),
                "scale_build_s": scale_meta.get("build_s"),
                "scale_n_kmers": scale_meta.get("n_kmers"),
                "scale_mode": scale_meta.get("mode")})
        except Exception as e:
            rows.append({"metric": "index_build_s", "value": 0, "unit": "s",
                         "error": f"{type(e).__name__}: {e}"})

    rows.append({
        "metric": "map_throughput",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / BASELINE_READS_PER_SEC, 3),
        "setup_s": round(setup_s - init_s, 1),
        "backend_init_s": round(init_s, 1),
        "device": device,
        "passes_s": [round(x, 3) for x in dts],
        "setup_breakdown": setup_breakdown,
        "tuned": {"cap": list(best_cap), "depth": best_depth,
                  "cached": tuned is not None},
    })
    for row in rows:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as e:  # any setup/runtime failure -> one JSON line
        rc = _fail(f"{type(e).__name__}: {e}")
    sys.exit(rc)
