import os
import sys

# Tests run on a virtual 8-device CPU mesh: multi-device shardings are
# validated without a card.  An explicit JAX_PLATFORMS=cuda runs them on
# a card instead (that is how the `gpu`-marked tests run).
if os.environ.get("JAX_PLATFORMS") not in ("cuda", "gpu"):
    os.environ["JAX_PLATFORMS"] = "cpu"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def bundled_files(tmp_path_factory):
    """(FASTA, FASTQ) of the reference's smoke shape, generated from a
    seed: 1,832 GENCODE-format transcripts and 9,309 reads of 60 bp."""
    from pseudoaligner_tpu.synth import write_bundled

    return write_bundled(str(tmp_path_factory.mktemp("bundled")))


@pytest.fixture(scope="session")
def transcripts(bundled_files):
    from pseudoaligner_tpu.io.fasta import read_transcripts

    return read_transcripts(bundled_files[0])


@pytest.fixture(scope="session")
def small_transcripts(transcripts):
    """First 100 transcripts — fast-build subset for unit-level checks."""
    seqs, names, gene_map = transcripts
    names = names[:100]
    return seqs[:100], names, {n: gene_map[n] for n in names}


@pytest.fixture(scope="session")
def small_index(small_transcripts):
    from pseudoaligner_tpu.index.builder import build_index

    seqs, names, gene_map = small_transcripts
    return build_index(seqs, names, gene_map, k=20)


@pytest.fixture(scope="session")
def full_index(transcripts):
    from pseudoaligner_tpu.index.builder import build_index

    seqs, names, gene_map = transcripts
    return build_index(seqs, names, gene_map, k=20)


@pytest.fixture(scope="session")
def small_reads(bundled_files):
    from pseudoaligner_tpu.io.fastq import read_fastq_records
    from pseudoaligner_tpu.dna import encode_bases

    out = []
    for rid, seq in read_fastq_records(bundled_files[1]):
        codes = encode_bases(seq)
        out.append((rid, np.where(codes == 255, 0, codes)))
    return out
