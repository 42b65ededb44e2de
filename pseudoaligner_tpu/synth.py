"""Seeded synthetic inputs: transcriptomes, reads, read pairs, 10x runs.

Everything here is drawn from a `numpy` seed, so a run on any machine
regenerates the same bytes.  The transcriptome is made of gene families
whose isoforms share long stretches (so equivalence classes are not
trivial) and is written as FASTA with GENCODE's nine `|`-separated
header fields, so `io.fasta.read_transcripts` takes the GENCODE branch
and parses the gene map.  Reads follow the recipe of the reference's
bundled smoke set (test/README there): exact transcript windows, windows
with one substitution, and reversed (not complemented) windows as
negative controls, interleaved so that every prefix of the file holds
all three kinds.

`BUNDLED` reproduces the shape of the reference's smoke data (1,832
GENCODE transcripts, ~2.84 Mb; 9,309 reads of 60 bp).
"""

from __future__ import annotations

import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)

BUNDLED = {"n_tx": 1832, "n_reads": 9309, "read_len": 60}


def transcriptome(n_tx: int | None = None, novel_bases: int | None = None,
                  seed: int = 99, gene_len=(300, 3000)):
    """Gene families until `n_tx` transcripts or `novel_bases` bases of
    novel sequence (about that many distinct k-mers) are reached.

    Each gene draws a random base sequence; its first isoform is the
    whole gene and up to two more skip one 50-500 bp stretch.  Returns
    (seqs as uint8 code arrays, transcript ids, {tx id: gene id})."""
    if (n_tx is None) == (novel_bases is None):
        raise ValueError("give exactly one of n_tx and novel_bases")
    rng = np.random.default_rng(seed)
    seqs, names, gene_map = [], [], {}
    novel = 0
    g = 0
    while (len(seqs) < n_tx) if n_tx is not None else (novel < novel_bases):
        base = rng.integers(0, 4, size=int(rng.integers(*gene_len)),
                            dtype=np.uint8)
        novel += len(base)
        for i in range(int(rng.integers(1, 4))):
            if i == 0:
                s = base
            else:
                a = int(rng.integers(0, len(base) // 2))
                b = int(rng.integers(a + 50, min(len(base), a + 500) + 1))
                s = np.concatenate([base[:a], base[b:]])
            if len(s) < 100 or (n_tx is not None and len(seqs) == n_tx):
                continue
            name = f"SYNT{len(seqs):09d}.1"
            seqs.append(s)
            names.append(name)
            gene_map[name] = f"SYNG{g:09d}.1"
        g += 1
    return seqs, names, gene_map


def gencode_header(tx: str, gene: str, length: int) -> str:
    """GENCODE transcript FASTA header (nine `|` fields, the last empty)."""
    sym = gene.split(".")[0]
    return (f"{tx}|{gene}|OTTHUMG{sym[4:]}|OTTHUMT{tx[4:13]}|"
            f"{sym}-201|{sym}|{length}|protein_coding|")


def write_fasta(path: str, seqs, names, gene_map, width: int = 60) -> None:
    with open(path, "wb") as f:
        for s, n in zip(seqs, names):
            f.write(b">" + gencode_header(n, gene_map[n], len(s)).encode()
                    + b"\n")
            txt = ACGT[s].tobytes()
            f.write(b"\n".join(txt[i:i + width]
                               for i in range(0, len(txt), width)) + b"\n")


def write_fastq(path: str, codes: np.ndarray, prefix: str = "r") -> None:
    """Codes [n, L] (0..3) -> FASTQ with ids `<prefix><i>`, quality 'I'."""
    n, L = codes.shape
    seq = ACGT[codes].tobytes()
    qual = b"I" * L
    pre = prefix.encode()
    with open(path, "wb") as f:
        for c0 in range(0, n, 65536):
            f.write(b"".join(
                b"@%s%d\n%s\n+\n%s\n" % (pre, i, seq[i * L:(i + 1) * L], qual)
                for i in range(c0, min(n, c0 + 65536))))


def _windows(seqs, read_len):
    """(flat pool, window start bases, window counts) over transcripts
    long enough for one `read_len` window."""
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    ok = lens >= read_len
    return np.concatenate(seqs), starts[ok], lens[ok] - read_len + 1


def _snp(rng, rows: np.ndarray, reads: np.ndarray) -> None:
    pos = rng.integers(0, reads.shape[1], size=len(rows))
    reads[rows, pos] = (reads[rows, pos] + rng.integers(1, 4, len(rows))) % 4


def reads(seqs, n: int, read_len: int, seed: int = 0) -> np.ndarray:
    """[n, read_len] uint8 codes: read i is an exact window (i % 3 == 0),
    a window with one substitution (1) or a reversed window (2); windows
    are uniform over all positions of all transcripts."""
    rng = np.random.default_rng(seed)
    flat, base, count = _windows(seqs, read_len)
    cum = np.cumsum(count)
    pick = rng.integers(0, cum[-1], size=n)
    tx = np.searchsorted(cum, pick, side="right")
    start = base[tx] + pick - (cum[tx] - count[tx])
    out = flat[start[:, None] + np.arange(read_len)[None, :]]
    kind = np.arange(n) % 3
    _snp(rng, np.nonzero(kind == 1)[0], out)
    rev = kind == 2
    out[rev] = out[rev, ::-1]
    return out


def pairs(seqs, n: int, read_len: int, seed: int = 1):
    """(r1, r2) [n, read_len] codes: both mates are windows of the same
    transcript; every third pair carries one substitution per mate, and
    in every third pair mate 2 is reversed (a mate that maps on its own
    only, which drives the single-mate branch of the intersection)."""
    rng = np.random.default_rng(seed)
    flat, base, count = _windows(seqs, read_len)
    tx = rng.integers(0, len(base), size=n)
    win = np.arange(read_len)[None, :]
    r1 = flat[(base[tx] + rng.integers(0, count[tx]))[:, None] + win]
    r2 = flat[(base[tx] + rng.integers(0, count[tx]))[:, None] + win]
    kind = np.arange(n) % 3
    for r in (r1, r2):
        _snp(rng, np.nonzero(kind == 1)[0], r)
    rev = kind == 2
    r2[rev] = r2[rev, ::-1]
    return r1, r2


def count_inputs(seqs, n_pairs: int, n_cells: int, r2_len: int,
                 bc_len: int = 16, umi_len: int = 12, seed: int = 2,
                 bc_error_rate: float = 0.02):
    """10x-style (r1, r2, cell barcodes): R1 is a barcode from an
    `n_cells` pool with Zipf cell sizes plus a random UMI; `bc_error_rate`
    of barcodes carry one substitution; R2 is cDNA from `reads`.
    Returns codes [n, bc_len + umi_len], [n, r2_len] and the cell
    barcodes as [n_cells, bc_len] codes."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 4, size=(n_cells, bc_len), dtype=np.uint8)
    w = 1.0 / np.arange(1, n_cells + 1)
    bcs = cells[rng.choice(n_cells, size=n_pairs, p=w / w.sum())]
    err = rng.choice(n_pairs, size=int(n_pairs * bc_error_rate),
                     replace=False)
    _snp(rng, err, bcs)
    umis = rng.integers(0, 4, size=(n_pairs, umi_len), dtype=np.uint8)
    r2 = reads(seqs, n_pairs, r2_len, seed=seed + 1)
    return np.concatenate([bcs, umis], axis=1), r2, cells


def whitelist(cells: np.ndarray, size: int, seed: int = 3) -> list[str]:
    """`size` distinct barcodes holding every row of `cells`, the rest
    random, in shuffled order (the shape of 10x's published lists)."""
    rng = np.random.default_rng(seed)
    bc_len = cells.shape[1]
    out = {ACGT[c].tobytes().decode() for c in cells}
    while len(out) < size:
        extra = rng.integers(0, 4, size=(size - len(out), bc_len),
                             dtype=np.uint8)
        out.update(ACGT[c].tobytes().decode() for c in extra)
    bcs = sorted(out)
    rng.shuffle(bcs)
    return bcs


def write_bundled(outdir: str, seed: int = 0, n_tx: int | None = None,
                  n_reads: int | None = None) -> tuple[str, str]:
    """The bundled-shape pair of files in `outdir`: `transcripts.fa`
    (1,832 GENCODE-format transcripts unless `n_tx`) and `reads.fq`
    (9,309 reads of 60 bp unless `n_reads`).  Returns their paths."""
    os.makedirs(outdir, exist_ok=True)
    seqs, names, gene_map = transcriptome(n_tx=n_tx or BUNDLED["n_tx"],
                                          seed=seed + 99)
    fa = os.path.join(outdir, "transcripts.fa")
    fq = os.path.join(outdir, "reads.fq")
    write_fasta(fa, seqs, names, gene_map)
    write_fastq(fq, reads(seqs, n_reads or BUNDLED["n_reads"],
                          BUNDLED["read_len"], seed=seed), prefix="read")
    return fa, fq
