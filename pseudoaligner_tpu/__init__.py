"""pseudoaligner_tpu — a JAX pseudoalignment framework for accelerators.

A from-scratch re-design of 10XGenomics/rust-pseudoaligner (kallisto/RapMap
style transcript-compatibility mapping) for an accelerator (an NVIDIA GPU):
the index is a set of flat device-resident arrays, the read-mapping inner loop is a vectorized
JAX/XLA (and Pallas) program over fixed-shape read batches, and scale-out is
data-parallel sharding over a `jax.sharding.Mesh` with XLA collectives.

Subpackages:
    io        — FASTA/FASTQ host input pipeline
    index     — index construction (k-mer census, EC interning, unitig
                compression, MPHF) and the flat IndexImage contract
    ops       — device kernels (k-mer extraction, MPHF probe, mapping walk)
    models    — the Pseudoaligner model: index + batched mapping engine
    parallel  — mesh/sharding layer, distributed mapping + TCC counts
    golden    — scalar oracle mirroring the reference semantics (tests)
"""

__version__ = "0.1.0"

from .config import AlignerConfig, DEFAULT_CONFIG  # noqa: F401
