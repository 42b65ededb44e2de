"""Single-probe bucket seed table (seed_index="bucket1").

One row gather answers a probe (vs the cuckoo's two); an experimental
seed mode, not measured on the H100.  Build is
NumPy-vectorized with deterministic re-salting on bucket overflow."""

import numpy as np

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.golden import GoldenAligner
from pseudoaligner_tpu.index.cuckoo import (
    B1_SLOTS,
    build_bucket1,
    bucket1_lookup_np,
)
from pseudoaligner_tpu.models.aligner import Pseudoaligner

from .test_map_device import _check_parity, _make_batches


def _rand_keys(n, W, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, size=(n, W), dtype=np.uint32)
    keys = np.unique(keys, axis=0)
    return keys


def test_build_and_lookup_roundtrip():
    keys = _rand_keys(50_000, 2)
    n = len(keys)
    nodes = np.arange(n, dtype=np.uint32)
    offs = (np.arange(n, dtype=np.uint32) * 7) % 251
    rows, mask, seed = build_bucket1(keys, nodes, offs)
    # every key found with its exact payload
    node, off = bucket1_lookup_np(rows, mask, seed, keys)
    assert np.array_equal(node, nodes)
    assert np.array_equal(off, offs)
    # absent keys miss
    probe = _rand_keys(10_000, 2, seed=99)
    view = {tuple(k) for k in keys.tolist()}
    absent = np.array(
        [k for k in probe.tolist() if tuple(k) not in view], dtype=np.uint32
    )
    node, off = bucket1_lookup_np(rows, mask, seed, absent)
    assert np.all(node == -1) and np.all(off == -1)


def test_overflow_resalting_is_deterministic():
    # tiny table forces bucket overflows -> re-salt then grow; build must
    # stay deterministic and complete
    keys = _rand_keys(4_000, 2, seed=3)
    n = len(keys)
    nodes = np.arange(n, dtype=np.uint32)
    offs = np.zeros(n, dtype=np.uint32)
    r1 = build_bucket1(keys, nodes, offs, mean_load=14.0)
    r2 = build_bucket1(keys, nodes, offs, mean_load=14.0)
    assert r1[1] == r2[1] and r1[2] == r2[2]
    assert np.array_equal(r1[0], r2[0])
    # occupancy invariant: no bucket exceeds B1_SLOTS (by construction of
    # the row array shape, plus every key is findable)
    node, _ = bucket1_lookup_np(*r1, keys)
    assert np.array_equal(node, nodes)


def test_device_parity_bucket1(small_index, small_reads):
    """Full-engine parity vs the golden oracle through bucket1 seeds."""
    cfg = AlignerConfig(
        k=20, batch_size=256, max_read_len=64, max_nodes=64,
        seed_index="bucket1",
        bitset_tx_threshold=1 << 20, distinct_cap=0,
    )
    al = Pseudoaligner(small_index, cfg)
    golden = GoldenAligner(small_index)
    n = 0
    for batch in _make_batches(small_reads[:512], 256, 64):
        res = al.map_batch_device(batch.codes, batch.lens)
        recs = al.records_from_result(res, batch)
        for i, rid in enumerate(batch.ids):
            read = batch.codes[i, : batch.lens[i]]
            g = golden.map_read(read)
            rec = recs[i]
            if g is None:
                assert rec.coverage == 0 and rec.eq_class == []
            else:
                assert rec.eq_class == g[0] and rec.coverage == g[1], rid
            n += 1
    assert n == 512


def test_device_parity_bucket1_compact(small_index, small_reads):
    """bucket1 through the compact serving path (lazy seeds + caps) must
    match the cuckoo serving engine record for record."""
    mk = dict(k=20, batch_size=256, max_read_len=64, max_nodes=9,
              distinct_cap=3, max_walk_iters=4, max_left_iters=2)
    a1 = Pseudoaligner(small_index, AlignerConfig(seed_index="cuckoo", **mk))
    a2 = Pseudoaligner(small_index, AlignerConfig(seed_index="bucket1", **mk))
    n = 0
    for batch in _make_batches(small_reads[:512], 256, 64):
        r1 = a1.records_from_result(
            a1.map_batch_device(batch.codes, batch.lens), batch)
        r2 = a2.records_from_result(
            a2.map_batch_device(batch.codes, batch.lens), batch)
        for x, y in zip(r1, r2):
            assert x == y, (x, y)
            n += 1
    assert n == 512
