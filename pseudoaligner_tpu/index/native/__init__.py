"""ctypes bridge to the native C++ census builder (see builder.cpp).

The library is compiled on first use for this host (_nativebuild.py);
`census_native` raises if no toolchain is available, and build_index falls
back to the NumPy path.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "builder.cpp")
_lock = threading.Lock()
_lib = None


class _PaCensus(ctypes.Structure):
    _fields_ = [
        ("nk", ctypes.c_int64),
        ("n_ecs", ctypes.c_int64),
        ("ec_total", ctypes.c_int64),
        ("words_per_kmer", ctypes.c_int32),
        ("kmer_words", ctypes.POINTER(ctypes.c_uint32)),
        ("exts", ctypes.POINTER(ctypes.c_uint8)),
        ("ec_of_kmer", ctypes.POINTER(ctypes.c_uint32)),
        ("ec_offsets", ctypes.POINTER(ctypes.c_uint32)),
        ("ec_txs", ctypes.POINTER(ctypes.c_uint32)),
        ("nxt", ctypes.POINTER(ctypes.c_int64)),
    ]


def _ensure_built() -> str:
    from ..._nativebuild import ensure_built

    return ensure_built(_SRC, "libpabuilder.so")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_ensure_built())
            lib.pa_census.restype = ctypes.c_int
            lib.pa_census.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.POINTER(_PaCensus),
            ]
            lib.pa_census_free.restype = None
            lib.pa_census_free.argtypes = [ctypes.POINTER(_PaCensus)]
            _lib = lib
    return _lib


def lookup_native(sorted_keys: np.ndarray, queries: np.ndarray,
                  n_threads: int | None = None) -> np.ndarray:
    """Parallel binary-search lookup in sorted unique keys -> idx or -1."""
    lib = _load()
    if not hasattr(lib, "_lookup_ready"):
        lib.pa_lookup.restype = None
        lib.pa_lookup.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib._lookup_ready = True
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 2)
    sorted_keys = np.ascontiguousarray(sorted_keys, dtype=np.uint32)
    queries = np.ascontiguousarray(queries, dtype=np.uint32)
    out = np.empty(len(queries), dtype=np.int64)
    lib.pa_lookup(
        sorted_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(sorted_keys), sorted_keys.shape[1],
        queries.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(queries), n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out


def census_native(seqs: list[np.ndarray], k: int, n_threads: int | None = None):
    """Run the C++ census; returns a builder.CensusProduct."""
    from ..builder import CensusProduct

    lib = _load()
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 2)

    codes = np.ascontiguousarray(
        np.concatenate([np.asarray(s, dtype=np.uint8) for s in seqs])
        if seqs
        else np.zeros(0, np.uint8)
    )
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])

    out = _PaCensus()
    rc = lib.pa_census(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(seqs),
        k,
        n_threads,
        ctypes.byref(out),
    )
    if rc != 0:
        raise RuntimeError(f"pa_census failed with code {rc}")
    try:
        nk, W = out.nk, out.words_per_kmer
        kmer_words = np.ctypeslib.as_array(out.kmer_words, (nk, W)).copy()
        exts = np.ctypeslib.as_array(out.exts, (nk,)).copy()
        ec_of_kmer = np.ctypeslib.as_array(out.ec_of_kmer, (nk,)).copy()
        ec_offsets = np.ctypeslib.as_array(out.ec_offsets, (out.n_ecs + 1,)).copy()
        ec_txs = np.ctypeslib.as_array(out.ec_txs, (max(1, out.ec_total),))[
            : out.ec_total
        ].copy()
        nxt = np.ctypeslib.as_array(out.nxt, (nk,)).copy()
    finally:
        lib.pa_census_free(ctypes.byref(out))

    return CensusProduct(
        kmer_words=kmer_words,
        kmer_exts=exts,
        ec_of_kmer=ec_of_kmer,
        ec_offsets=ec_offsets,
        ec_txs=ec_txs,
        nxt=nxt,
    )


class _PaMphf(ctypes.Structure):
    _fields_ = [
        ("n_keys", ctypes.c_int64),
        ("n_levels", ctypes.c_int32),
        ("total_words", ctypes.c_int64),
        ("seeds", ctypes.POINTER(ctypes.c_uint32)),
        ("masks", ctypes.POINTER(ctypes.c_uint32)),
        ("word_offsets", ctypes.POINTER(ctypes.c_uint32)),
        ("key_offsets", ctypes.POINTER(ctypes.c_uint32)),
        ("bits", ctypes.POINTER(ctypes.c_uint32)),
        ("ranks", ctypes.POINTER(ctypes.c_uint32)),
        ("slot_of_key", ctypes.POINTER(ctypes.c_int64)),
    ]


def mphf_native(keys: np.ndarray, gamma: float = 1.7,
                n_threads: int | None = None):
    """Native MPHF build; returns the same dict of arrays the NumPy build
    assembles (bit-identical level structure by construction)."""
    lib = _load()
    if not hasattr(lib, "_mphf_ready"):
        lib.pa_mphf.restype = ctypes.c_int
        lib.pa_mphf.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_double, ctypes.c_int32, ctypes.POINTER(_PaMphf),
        ]
        lib.pa_mphf_free.restype = None
        lib.pa_mphf_free.argtypes = [ctypes.POINTER(_PaMphf)]
        lib._mphf_ready = True
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 2)
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    n, W = keys.shape
    out = _PaMphf()
    rc = lib.pa_mphf(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        n, W, gamma, n_threads, ctypes.byref(out),
    )
    if rc != 0:
        raise RuntimeError(f"pa_mphf failed with code {rc}")
    try:
        nl, tw = out.n_levels, out.total_words
        res = {
            "n_keys": n,
            "seeds": np.ctypeslib.as_array(out.seeds, (nl,)).copy(),
            "masks": np.ctypeslib.as_array(out.masks, (nl,)).copy(),
            "word_offsets": np.ctypeslib.as_array(out.word_offsets, (nl,)).copy(),
            "key_offsets": np.ctypeslib.as_array(out.key_offsets, (nl,)).copy(),
            "bits": np.ctypeslib.as_array(out.bits, (max(1, tw),))[:tw].copy(),
            "ranks": np.ctypeslib.as_array(out.ranks, (max(1, tw),))[:tw].copy(),
            "slot_of_key": np.ctypeslib.as_array(out.slot_of_key, (n,)).copy(),
        }
    finally:
        lib.pa_mphf_free(ctypes.byref(out))
    return res


def cuckoo_native(keys: np.ndarray, nodes: np.ndarray, offsets: np.ndarray,
                  n_buckets: int, n_threads: int | None = None) -> np.ndarray:
    """Native cuckoo-table build -> rows [n_buckets, SLOTS*(W+2)] uint32.

    Raises RuntimeError if placement fails (caller grows n_buckets).
    """
    lib = _load()
    if not hasattr(lib, "_cuckoo_ready"):
        lib.pa_cuckoo.restype = ctypes.c_int
        lib.pa_cuckoo.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint32),
        ]
        lib._cuckoo_ready = True
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 2)
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    nodes = np.ascontiguousarray(nodes, dtype=np.uint32)
    offsets = np.ascontiguousarray(offsets, dtype=np.uint32)
    n, W = keys.shape
    rows = np.empty((n_buckets, 4 * (W + 2)), dtype=np.uint32)
    rc = lib.pa_cuckoo(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        n, W, n_buckets, n_threads,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    if rc == 1:
        raise RuntimeError("cuckoo placement failed; grow the table")
    if rc != 0:
        raise ValueError(f"pa_cuckoo failed with code {rc}")
    return rows


class _PaGraph(ctypes.Structure):
    _fields_ = [
        ("n_nodes", ctypes.c_int64),
        ("total_bases", ctypes.c_int64),
        ("node_start", ctypes.POINTER(ctypes.c_uint32)),
        ("node_len", ctypes.POINTER(ctypes.c_uint32)),
        ("node_exts", ctypes.POINTER(ctypes.c_uint8)),
        ("node_ec", ctypes.POINTER(ctypes.c_uint32)),
        ("l_edge", ctypes.POINTER(ctypes.c_int32)),
        ("r_edge", ctypes.POINTER(ctypes.c_int32)),
        ("seq_pool", ctypes.POINTER(ctypes.c_uint8)),
        ("kmer_node", ctypes.POINTER(ctypes.c_uint32)),
        ("kmer_offset", ctypes.POINTER(ctypes.c_uint32)),
    ]


def graph_native_k(census, k: int):
    """Native stage-B graph assembly (see graph_native)."""
    lib = _load()
    if not hasattr(lib, "_graph_ready"):
        lib.pa_graph.restype = ctypes.c_int
        lib.pa_graph.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(_PaGraph),
        ]
        lib.pa_graph_free.restype = None
        lib.pa_graph_free.argtypes = [ctypes.POINTER(_PaGraph)]
        lib._graph_ready = True

    kw = np.ascontiguousarray(census.kmer_words, dtype=np.uint32)
    ex = np.ascontiguousarray(census.kmer_exts, dtype=np.uint8)
    ec = np.ascontiguousarray(census.ec_of_kmer, dtype=np.uint32)
    nx = np.ascontiguousarray(census.nxt, dtype=np.int64)
    nk = len(ex)
    g = _PaGraph()
    rc = lib.pa_graph(
        kw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ex.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ec.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        nx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        nk, k, ctypes.byref(g),
    )
    if rc != 0:
        raise RuntimeError(f"pa_graph failed with code {rc}")
    try:
        N = g.n_nodes
        out = {
            "node_start": np.ctypeslib.as_array(g.node_start, (N,)).copy(),
            "node_len": np.ctypeslib.as_array(g.node_len, (N,)).copy(),
            "node_exts": np.ctypeslib.as_array(g.node_exts, (N,)).copy(),
            "node_ec": np.ctypeslib.as_array(g.node_ec, (N,)).copy(),
            "l_edge": np.ctypeslib.as_array(g.l_edge, (N, 4)).copy(),
            "r_edge": np.ctypeslib.as_array(g.r_edge, (N, 4)).copy(),
            "seq_pool": np.ctypeslib.as_array(
                g.seq_pool, (max(1, g.total_bases),)
            )[: g.total_bases].copy(),
            "kmer_node": np.ctypeslib.as_array(g.kmer_node, (nk,)).copy(),
            "kmer_offset": np.ctypeslib.as_array(g.kmer_offset, (nk,)).copy(),
        }
    finally:
        lib.pa_graph_free(ctypes.byref(g))
    return out
