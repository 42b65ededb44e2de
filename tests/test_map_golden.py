"""Golden-mapper behavior tests, including the reference's documented
alignment expectation (src/build_index.rs:424-451: a read and its 1-SNP
variant map to the same equivalence class with full coverage)."""

import numpy as np
import pytest

from pseudoaligner_tpu.dna import encode_bases
from pseudoaligner_tpu.golden import GoldenAligner


@pytest.fixture(scope="module")
def aligner(full_index):
    return GoldenAligner(full_index)


def _shared_window(transcripts, L=60):
    """A window of the first isoform pair that shares its first L bases,
    and the transcripts that hold it (the expected equivalence class)."""
    seqs, names, gene_map = transcripts
    txt = [s.tobytes() for s in seqs]
    for i in range(len(seqs) - 1):
        if (gene_map[names[i]] == gene_map[names[i + 1]]
                and txt[i][:L] == txt[i + 1][:L]):
            w = txt[i][:L]
            return (np.frombuffer(w, np.uint8).copy(),
                    [j for j, t in enumerate(txt) if w in t])
    raise AssertionError("no isoform pair shares a prefix")


@pytest.mark.full
def test_alignment_exact(aligner, transcripts):
    read, want = _shared_window(transcripts)
    assert len(want) >= 2
    eq_class, nbases = aligner.map_read(read)
    assert eq_class == want
    assert nbases == len(read)


@pytest.mark.full
def test_alignment_single_snp(aligner, transcripts):
    """The reference's documented case (src/build_index.rs:424-451): a
    read and its one-substitution variant map to the same class with
    full coverage."""
    read, want = _shared_window(transcripts)
    read[22] = (read[22] + 1) % 4
    eq_class, nbases = aligner.map_read(read)
    assert eq_class == want
    assert nbases == len(read)


def test_short_read_unmapped(small_index):
    al = GoldenAligner(small_index)
    read = encode_bases("ACGTACGTACGT")  # shorter than k=20
    assert al.map_read(read) is None


def test_random_read_unmapped(small_index):
    al = GoldenAligner(small_index)
    rng = np.random.default_rng(7)
    read = rng.integers(0, 4, size=60).astype(np.uint8)
    r = al.map_read(read)
    # random 60-mer almost surely finds no 20-mer seed
    assert r is None or r[1] < 60


def test_lazy_golden_matches_eager(small_index, small_reads):
    eager = GoldenAligner(small_index)
    lazy = GoldenAligner(small_index, lazy=True)
    for rid, read in small_reads[:20]:
        assert eager.map_read(read) == lazy.map_read(read), rid
