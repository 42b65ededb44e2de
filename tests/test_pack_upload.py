"""upload_device_index (packed H2D transfer — VERDICT r4 #2).

The serving upload bit-packs the cuckoo keys (2k of 32W bits), the
(node, offset) values (<= 46 bits), and de-overlaps the pool rows, then
unpacks ON DEVICE.  These tests force the packing on (PA_PACK_UPLOAD=1,
any table size) and assert the unpacked device arrays are byte-identical
to a plain jax.device_put, plus end-to-end map parity through the
aligner.  Reference analog: the lean NoKeyBoomHashMap
(/root/reference/src/build_index.rs:220) — fewer bytes moved, same
lookup semantics.
"""

import os

import jax
import numpy as np
import pytest

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.index.builder import build_index
from pseudoaligner_tpu.models.aligner import Pseudoaligner
from pseudoaligner_tpu.ops.map_kernel import (
    device_index_from_image,
    upload_device_index,
)


def _assert_pack_matches_plain(dev, meta):
    plain = jax.device_put(dev)
    os.environ["PA_PACK_UPLOAD"] = "1"
    try:
        packed = upload_device_index(dev, meta)
    finally:
        os.environ.pop("PA_PACK_UPLOAD", None)
    for f in ("cuckoo", "cuckoo_vals", "pool_rows", "node_row", "ec_bits"):
        a = np.asarray(getattr(packed, f))
        b = np.asarray(getattr(plain, f))
        # the packed path pads slots/rows up to its wide unpack
        # tile (padded rows are unreachable: bucket mask / slot id /
        # pool offset all bound the gathers) — compare the real prefix
        assert a.dtype == b.dtype and a.shape[1:] == b.shape[1:], f
        assert a.shape[0] >= b.shape[0], f
        assert np.array_equal(a[: b.shape[0]], b), f
        if f == "cuckoo_vals" and a.shape[0] > b.shape[0]:
            # padded value pairs (flat layout) must read as EMPTY slots
            assert (a[b.shape[0]:: 2] == 0xFFFFFFFF).all()
        if f == "cuckoo" and a.shape[0] > b.shape[0]:
            assert (a[b.shape[0]:] == 0xFFFFFFFF).all()
    # the mphf/key arrays ride as ZERO-SIZE dummies in cuckoo mode (a
    # 1-row sentinel would be indistinguishable from a real single-kmer
    # index in ops/stats.py's guard)
    assert packed.kmer_keys.shape[0] == 0
    assert packed.mphf_bits.shape[0] == 0


@pytest.mark.parametrize("pool_overlap", [False, True])
def test_pack_upload_bit_identical(small_index, pool_overlap):
    cfg = AlignerConfig(
        k=20, batch_size=64, max_read_len=60, max_nodes=8, distinct_cap=3,
        max_walk_iters=2, max_left_iters=2, pool_overlap=pool_overlap,
    )
    dev, meta = device_index_from_image(small_index, cfg)
    if pool_overlap:
        assert meta.pool_stride > 0
    _assert_pack_matches_plain(dev, meta)


def test_pack_upload_k64(small_transcripts):
    """k=64: 128-bit keys fill all 4 words (no key packing) but values
    and pool still pack; the function must mix packed/unpacked parts."""
    seqs, names, gene_map = small_transcripts
    image = build_index(seqs, names, gene_map, k=64)
    cfg = AlignerConfig(
        k=64, batch_size=32, max_read_len=96, max_nodes=8, distinct_cap=3,
        max_walk_iters=2, max_left_iters=2,
    )
    dev, meta = device_index_from_image(image, cfg)
    _assert_pack_matches_plain(dev, meta)


def test_serving_sidecar_cache(small_index, tmp_path):
    """serving_device_index: miss -> writes the packed sidecar; hit ->
    loads it, with dev arrays AND meta identical to the uncached path."""
    from pseudoaligner_tpu.ops.map_kernel import (
        _packcache_path,
        serving_device_index,
    )
    from pseudoaligner_tpu.serde import load_index, save_index

    idx_path = str(tmp_path / "s.bin")
    save_index(small_index, idx_path)
    image = load_index(idx_path)  # sets source_ident -> sidecar engages
    cfg = AlignerConfig(
        k=20, batch_size=64, max_read_len=60, max_nodes=8, distinct_cap=3,
        max_walk_iters=2, max_left_iters=2,
    )
    os.environ["PA_PACK_UPLOAD"] = "1"
    try:
        path = _packcache_path(image, cfg)
        assert path is not None and not os.path.exists(path)
        dev_miss, meta_miss = serving_device_index(image, cfg)
        assert os.path.exists(path), "sidecar not written on miss"
        dev_hit, meta_hit = serving_device_index(image, cfg)
    finally:
        os.environ.pop("PA_PACK_UPLOAD", None)
    assert meta_hit == meta_miss
    for f in dev_miss._fields:
        a, b = np.asarray(getattr(dev_miss, f)), np.asarray(
            getattr(dev_hit, f))
        assert a.shape == b.shape and np.array_equal(a, b), f


def test_pack_upload_end_to_end(small_index, small_reads):
    """Forced-packed aligner produces the same MapResult as unpacked."""
    cfg = AlignerConfig(
        k=20, batch_size=32, max_read_len=64, max_nodes=8, distinct_cap=3,
        max_walk_iters=2, max_left_iters=2,
    )
    B, L = 32, 64
    codes = np.zeros((B, L), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for j, (_, c) in enumerate(small_reads[:B]):
        codes[j, : min(len(c), L)] = c[:L]
        lens[j] = min(len(c), L)

    results = {}
    for mode in ("0", "1"):
        os.environ["PA_PACK_UPLOAD"] = mode
        try:
            al = Pseudoaligner(small_index, cfg)
        finally:
            os.environ.pop("PA_PACK_UPLOAD", None)
        results[mode] = jax.device_get(al.map_batch_device(codes, lens))
    for a, b in zip(results["0"], results["1"]):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_upload_ab_tool(tmp_path, monkeypatch, capsys):
    """tools/upload_ab.py at a tiny size (packing forced on): two first
    serves from no cache, four warm ones, every device image equal to
    the first, and each arm writes only its own caches."""
    import importlib.util
    import json

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "upload_ab.py")
    spec = importlib.util.spec_from_file_location("upload_ab", path)
    upload_ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(upload_ab)
    monkeypatch.setenv("PA_PACK_UPLOAD", "1")
    opts = upload_ab.parse_args(["--novel-mb", "0.05", "--workdir",
                                 str(tmp_path)])
    assert upload_ab.run(opts, "cpu")
    serves = [json.loads(line) for line in capsys.readouterr().out
              .splitlines() if line.startswith('{"serve"')]
    assert [(s["serve"], s["arm"]) for s in serves] == [
        ("first", "plain"), ("first", "packed"), ("warm", "plain"),
        ("warm", "packed"), ("warm", "packed"), ("warm", "plain")]
    assert all(s["same_as_first"] for s in serves)
    kinds = [sorted(name.split(".")[2][:4] for name in s["disk_caches"])
             for s in serves]
    assert kinds[0] == ["dev-"] and kinds[1] == ["dev-", "pack"]
