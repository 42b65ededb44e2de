"""Compile-time-style configuration constants.

Re-design of the reference configuration module
(reference: src/config.rs:1-23).  The reference bakes these in as Rust
consts; here they are a frozen dataclass so alternative configurations can
be constructed for tests, while the module-level constants mirror the
reference defaults exactly.
"""

from __future__ import annotations

import dataclasses
import enum

# reference: src/config.rs:12-18
MEM_SIZE = 1
MIN_KMERS = 1
STRANDED = True
REPORT_ALL_KMER = False
READ_COVERAGE_THRESHOLD = 32
LEFT_EXTEND_FRACTION = 0.2
DEFAULT_ALLOWED_MISMATCHES = 2

# reference: src/config.rs:20
U32_MAX = 0xFFFFFFFF

# reference: src/config.rs:23
MAPPABILITY_COUNTS_LEN = 11

# Supported k sizes (reference: src/bin/pseudoaligner.rs:86-96 supports 20/64
# via monomorphized Kmer20/Kmer64).  Here k is a runtime parameter; 20 and 64
# are the validated configurations.
SUPPORTED_K = (20, 64)

# MSP p-mer length (reference: src/build_index.rs:93 `PmerType = Kmer6`).
PMER_K = 6

# Minimum number of super-kmer runs per build shard
# (reference: src/build_index.rs:25 MIN_SHARD_SEQUENCES).
MIN_SHARD_SEQUENCES = 2000


class FastaFormat(enum.Enum):
    """Transcriptome FASTA header formats (reference: src/config.rs:4-9)."""

    UNKNOWN = "unknown"
    GENCODE = "gencode"
    ENSEMBL = "ensembl"
    GFFREAD = "gffread"


@dataclasses.dataclass(frozen=True)
class AlignerConfig:
    """Runtime configuration for the mapping engine.

    Defaults reproduce the reference behavior bit-for-bit.  The extra
    fields configure the device execution shape (batch size, padding)
    which has no observable effect on per-read results.
    """

    k: int = 20
    allowed_mismatches: int = DEFAULT_ALLOWED_MISMATCHES
    left_extend_fraction: float = LEFT_EXTEND_FRACTION
    read_coverage_threshold: int = READ_COVERAGE_THRESHOLD

    # --- device execution shape (no semantic effect) ---
    batch_size: int = 8192
    # Maximum read length the compiled kernel supports; longer reads are
    # handled by the long-read segmentation path (SURVEY.md section 5.7).
    max_read_len: int = 160
    # Per-read bound on the node-visit buffer.  A read of length L visits at
    # most L nodes forward plus L nodes during left extension; 2*max_read_len
    # is a hard upper bound.
    max_nodes: int = 64
    # Use the on-device EC-bitset intersection when the transcriptome has at
    # most this many transcripts; otherwise fall back to host CSR merge.
    bitset_tx_threshold: int = 16384
    # Seed k-mer index structure: "cuckoo" (4-slot bucketized two-choice
    # table; a probe is 2 row gathers — the speed mode), "bucket1"
    # (single-hash 16-slot buckets, ONE row gather per probe but all 64
    # row words read; experimental) or "mphf" (BBHash bitvectors; ~8x
    # more gathers per probe but ~2x less probe memory, the reference's
    # NoKeyBoomHashMap tradeoff).  Not compared on the H100 yet.
    seed_index: str = "cuckoo"
    # Lazy stride-3 seeding: eager probes only at residue-0 positions
    # (3x fewer seed gathers); re-seeds at other residues probe inside
    # the walk loop (cuckoo mode only; ignored for mphf).
    lazy_seeds: bool = True
    # Compact device outputs for serving: per-read run-compacted EC id
    # lists (host CSR materialization) instead of node buffers + EC
    # bitsets.  Cuts result transfer ~6x; 0 = full debug outputs.  Reads
    # with more class runs than the cap are re-mapped exactly on the
    # overflow path.
    distinct_cap: int = 12
    # Forward-walk iteration cap for the serving kernel; lanes cut off are
    # re-run exactly through the uncapped fallback pass (rare).  Requires
    # compact outputs (ignored when distinct_cap == 0).  0 = unbounded.
    max_walk_iters: int = 6
    # Left-extension iteration cap, same contract as max_walk_iters (lanes
    # cut off re-run exactly on the fallback path).  The deepest lane
    # otherwise sets the whole batch's trip count, while typical lanes
    # need 0-1.
    max_left_iters: int = 2
    # Walk-loop body unroll: steps executed per while_loop iteration (the
    # fixed per-iteration cost amortizes across the group; lanes done
    # mid-group are masked).
    walk_unroll: int = 1
    # Straight-line capped walk loops (no lax.while_loop).  Masked
    # semantics identical; off by default, not measured on the H100.
    walk_straightline: bool = False
    # Two-tier lane compaction: run the left-extension loop on a
    # compacted buffer of ceil(left_compact * B) lanes (only the late-hit
    # minority enters it), and the forward-walk tail beyond walk_split
    # iterations on ceil(walk_compact * B) lanes.  Loop shapes are
    # static, so full-B loops pay for every lane even after it finishes.
    # Lanes beyond capacity take the -3 exact fallback (deterministic).
    # 0 disables; requires compact outputs.  The walk-tail tier adds
    # inter-loop state gathers/scatters and a second loop body, so
    # walk_split stays 0 by default; neither tier is measured on the H100.
    left_compact: float = 0.125
    walk_split: int = 0
    walk_compact: float = 0.25
    # Two-tier seed probing: grid position 0 probes every lane; the later
    # grid positions probe only a compacted buffer of ceil(seed_compact *
    # B) miss-at-0 lanes (most reads hit at position 0).  Hit-at-0 lanes
    # re-seed through the in-loop seek probe (their next-hit rows are not
    # built); over-capacity miss lanes take the -3 exact fallback.
    # Requires lazy_seeds + compact outputs.  0 disables (the default:
    # seek re-seeds raise the -3 flagged volume on error-bearing reads).
    seed_compact: float = 0.0
    # Overlapping pool rows (rows start every 128 - 16*(cmp_words+1)
    # bases): every compare window fits ONE row, halving the window
    # gather elements per walk iteration.  Only possible for
    # max_read_len <= 80 (wider windows span a row regardless).
    # None = auto: engage exactly when possible (the default).  An
    # explicit True at a wider max_read_len logs a warning and falls
    # back.  Outputs are bit-identical to the non-overlapping layout.
    pool_overlap: bool | None = None
    # Serving pipeline depth: device map batches kept in flight in
    # emit_fastq (and the bench loop) before the oldest is consumed.
    # ANY device_get waits for everything queued before it, so both the
    # compact-output fetch and the overflow re-map wait are deferred by
    # this many batches to keep the device queue ~depth deep across the
    # waits.  Costs depth packed input + compact output buffers on
    # device (~3MB each at B=65k).  Not tuned on the H100.
    pipeline_depth: int = 3

    def __post_init__(self):
        if self.k < 4 or self.k > 64:
            raise ValueError(f"k={self.k} out of supported range [4, 64]")


DEFAULT_CONFIG = AlignerConfig()
