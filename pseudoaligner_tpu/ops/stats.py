"""Mapping-engine observability: per-batch counters + profiler hooks.

The reference has no tracing/profiling (SURVEY.md section 5.1 — only a
disabled per-read `kmer_lookups` counter, src/pseudoaligner.rs:87,95).
Here per-batch aggregate counters are computed on device (one reduction
each) and a `trace` context manager wraps the JAX profiler for device
traces.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .kmers import all_kmers
from .map_kernel import DeviceIndex, MapMeta, unpack_reads  # noqa: F401
from .mphf_lookup import mphf_probe


@dataclass
class BatchStats:
    """Aggregate seed/probe statistics for one batch."""

    n_reads: int
    n_positions: int  # valid k-mer positions probed
    n_seed_hits: int  # verified index hits
    n_probe_false_positives: int  # MPHF slot returned but key mismatch
    seed_hit_rate: float
    fp_rate: float

    def as_dict(self):
        return self.__dict__.copy()


def _stats_impl(meta: MapMeta, idx: DeviceIndex, packed, lens):
    reads = unpack_reads(packed, meta.read_len)
    kmers = all_kmers(reads, meta.k)
    P = meta.n_positions
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    valid = pos <= (lens[:, None] - meta.k)

    slot = mphf_probe(kmers, idx.mphf_bits, idx.mphf_ranks, meta.mphf)
    safe = jnp.maximum(slot, 0)
    stored = jnp.take(idx.kmer_keys, safe, axis=0)
    verified = (slot >= 0) & jnp.all(stored == kmers, axis=-1)

    n_positions = jnp.sum(valid.astype(jnp.int32))
    n_hits = jnp.sum((verified & valid).astype(jnp.int32))
    n_fp = jnp.sum(((slot >= 0) & ~verified & valid).astype(jnp.int32))
    return n_positions, n_hits, n_fp


_jitted_stats: dict = {}


def batch_stats(meta: MapMeta, idx: DeviceIndex, packed, lens) -> BatchStats:
    if idx.kmer_keys.shape[0] == 0 or idx.mphf_bits.shape[0] == 0:
        raise ValueError(
            "batch_stats needs the mphf/key arrays: pass a full "
            "DeviceIndex from device_index_from_image — a cuckoo-mode "
            "serving upload (Pseudoaligner.dev) carries them as dummies "
            "(upload_device_index strips ~432MB of dead upload)"
        )
    # jit once per meta: a fresh jax.jit wrapper per call would re-trace
    # and recompile the kernel on every batch
    fn = _jitted_stats.get(meta)
    if fn is None:
        fn = _jitted_stats[meta] = jax.jit(partial(_stats_impl, meta))
    # ONE batched transfer instead of a device round trip per scalar
    n_positions, n_hits, n_fp = (
        int(x) for x in jax.device_get(fn(idx, packed, lens)))
    n_reads = int((np.asarray(lens) > 0).sum())
    return BatchStats(
        n_reads=n_reads,
        n_positions=n_positions,
        n_seed_hits=n_hits,
        n_probe_false_positives=n_fp,
        seed_hit_rate=n_hits / n_positions if n_positions else 0.0,
        fp_rate=n_fp / n_positions if n_positions else 0.0,
    )


@contextlib.contextmanager
def trace(logdir: str):
    """JAX profiler trace context (view in TensorBoard/XProf)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
