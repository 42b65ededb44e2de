"""2-bit DNA primitives (host side, NumPy).

Vectorized equivalent of the `debruijn` crate's `DnaString` / `Kmer` types
(reference call sites: src/utils.rs:76, src/pseudoaligner.rs:93,156,241,450,
src/build_index.rs:143 — the crate itself is a [dep], see SURVEY.md section
2.2).  Encoding: A=0, C=1, G=2, T=3, matching the crate's 2-bit packing.

Host representation: sequences are plain ``uint8`` code arrays (one base per
byte) — the pack/unpack helpers convert to/from the 2-bit packed ``uint32``
word form used for k-mers and for the serialized index image.

K-mer representation: a k-mer is the integer ``sum(code[i] << 2*(k-1-i))``
(leftmost base most significant, as in `debruijn`).  So that device code
works in 32-bit integers only, k-mers are stored as ``W = ceil(2k/32)`` uint32 words
in **little-endian word order**: ``words[..., 0]`` holds bits 0..31 (the
rightmost 16 bases), ``words[..., 1]`` bits 32..63, and so on.  k=20 -> W=2,
k=64 -> W=4.
"""

from __future__ import annotations

import numpy as np

BASE_A, BASE_C, BASE_G, BASE_T = 0, 1, 2, 3

_ENCODE_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _ENCODE_LUT[_b] = _i
    _ENCODE_LUT[ord(chr(_b).lower())] = _i

_DECODE_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def kmer_words(k: int) -> int:
    """Number of uint32 words needed to hold a 2k-bit k-mer."""
    return (2 * k + 31) // 32


def encode_bases(seq: bytes | str) -> np.ndarray:
    """ASCII ACGT (case-insensitive) -> uint8 codes.  Non-ACGT maps to 255.

    Equivalent of `DnaString::from_dna_string` for clean input
    (reference call site: src/pseudoaligner.rs:450).
    """
    if isinstance(seq, str):
        seq = seq.encode()
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _ENCODE_LUT[raw]


def decode_bases(codes: np.ndarray) -> str:
    """uint8 codes -> ACGT string."""
    return _DECODE_LUT[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def _mix32(h: np.ndarray | int) -> np.ndarray | int:
    """murmur3 fmix32 — the shared 32-bit avalanche mixer.

    Used for deterministic N-substitution here and (with per-level seeds)
    by the MPHF.  Must stay bit-identical between this NumPy form and the
    jnp form in ops/hashing.py.
    """
    h = np.uint32(h) if np.isscalar(h) else h.astype(np.uint32)
    with np.errstate(over="ignore"):
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


def from_acgt_bytes_hashn(seq: bytes, id_bytes: bytes) -> np.ndarray:
    """ASCII -> codes with non-ACGT bases replaced deterministically.

    Equivalent of `DnaString::from_acgt_bytes_hashn` (reference call site:
    src/utils.rs:76 [dep]): each non-ACGT base is replaced by a base chosen
    by hashing the record id and the base position, so N runs map
    reproducibly.  The exact replacement hash of the unvendored `debruijn`
    crate is not observable from the reference; this implementation uses a
    documented FNV-1a(id) + position -> fmix32 scheme.  The bundled test
    transcriptome contains no non-ACGT bases, so parity on the reference
    fixtures is unaffected.
    """
    codes = encode_bases(seq)
    bad = codes == 255
    if bad.any():
        id_hash = np.uint32(2166136261)
        with np.errstate(over="ignore"):
            for b in id_bytes:
                id_hash = np.uint32((int(id_hash) ^ b) * 16777619 & 0xFFFFFFFF)
            pos = np.nonzero(bad)[0].astype(np.uint32)
            repl = _mix32(pos * np.uint32(0x9E3779B9) + id_hash) & np.uint32(3)
        codes = codes.copy()
        codes[bad] = repl.astype(np.uint8)
    return codes


def pack_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """All overlapping k-mers of a code sequence -> [n-k+1, W] uint32 words.

    Little-endian word order (see module docstring).  Equivalent of
    `DnaString::iter_kmers` / `get_kmer` (reference call sites:
    src/pseudoaligner.rs:93,103, src/build_index.rs:212 [dep]).
    """
    codes = np.asarray(codes, dtype=np.uint32)
    n = codes.shape[0]
    w = kmer_words(k)
    if n < k:
        return np.zeros((0, w), dtype=np.uint32)
    num = n - k + 1
    out = np.zeros((num, w), dtype=np.uint32)
    for i in range(k):
        bitpos = 2 * (k - 1 - i)
        word, shift = bitpos // 32, bitpos % 32
        out[:, word] |= codes[i : i + num] << np.uint32(shift)
    return out


def kmer_to_pyint(words: np.ndarray) -> int:
    """[W] uint32 words -> arbitrary-precision python int (for dict keys)."""
    v = 0
    for j in range(words.shape[0] - 1, -1, -1):
        v = (v << 32) | int(words[j])
    return v


def pyint_to_kmer(v: int, k: int) -> np.ndarray:
    w = kmer_words(k)
    out = np.zeros(w, dtype=np.uint32)
    for j in range(w):
        out[j] = v & 0xFFFFFFFF
        v >>= 32
    return out


def kmer_to_codes(words: np.ndarray, k: int) -> np.ndarray:
    """[W] uint32 words -> [k] uint8 base codes."""
    out = np.zeros(k, dtype=np.uint8)
    for i in range(k):
        bitpos = 2 * (k - 1 - i)
        word, shift = bitpos // 32, bitpos % 32
        out[i] = (int(words[word]) >> shift) & 3
    return out


def kmer_str(words: np.ndarray, k: int) -> str:
    return decode_bases(kmer_to_codes(words, k))


def pack_codes_2bit(codes: np.ndarray) -> np.ndarray:
    """uint8 codes -> 2-bit packed uint32 words (16 bases/word, base i at
    bits [2*(i%16), 2*(i%16)+1] of word i//16).  Used by the serialized
    index image; the device pool keeps one-byte codes for gather speed."""
    codes = np.asarray(codes, dtype=np.uint32)
    n = codes.shape[0]
    nw = (n + 15) // 16
    padded = np.zeros(nw * 16, dtype=np.uint32)
    padded[:n] = codes
    padded = padded.reshape(nw, 16)
    shifts = (np.arange(16, dtype=np.uint32) * 2).astype(np.uint32)
    return np.bitwise_or.reduce(padded << shifts, axis=1).astype(np.uint32)


def unpack_codes_2bit(words: np.ndarray, n: int) -> np.ndarray:
    words = np.asarray(words, dtype=np.uint32)
    shifts = (np.arange(16, dtype=np.uint32) * 2).astype(np.uint32)
    codes = ((words[:, None] >> shifts) & np.uint32(3)).reshape(-1)
    return codes[:n].astype(np.uint8)
