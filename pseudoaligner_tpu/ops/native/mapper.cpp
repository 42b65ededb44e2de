// Native scalar read mapper — the host fallback path.
//
// Bit-exact C++ mirror of golden.py's map_read_to_nodes_with_mismatch
// (itself a line-by-line mirror of the reference's inner loop,
// src/pseudoaligner.rs:64-319): stride-3 seed scan with MPHF probe +
// stored-key verification, the 0.2*L left-extension gate with its
// offset-0 comparison frame, per-segment SNP budgets with global mismatch
// accumulation, +k / -(k-1) coverage arithmetic, and stride-3 re-seeding.
//
// Serving role: the ~1-2% of reads flagged by the device's compact output
// (distinct-class overflow / walk-iteration cap) re-map HERE, on host
// threads fully overlapped with the device — replacing a second device
// dispatch whose queue position serialized against the next batch's map
// step.  Also usable as a standalone CPU mapper.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// murmur3 fmix32 — MUST stay bit-identical to ops/hashing.py::mix32_np
// and index/native/builder.cpp::mix32.  Deliberately duplicated rather
// than a shared header: _nativebuild.py keys rebuilds on the .cpp mtime
// only, so a header edit would silently serve stale binaries.  Drift is
// test-pinned instead (test_mphf_native bit-identity, test_host_mapper
// probe parity).
inline uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

inline uint32_t hash_words(const uint32_t* w, int W, uint32_t seed) {
  uint32_t h = seed;
  for (int j = 0; j < W; j++) h = mix32(h ^ w[j]);
  return h;
}

struct Index {
  const uint8_t* seq_pool;
  const uint32_t* node_start;
  const uint32_t* node_len;
  const uint8_t* node_exts;
  const int32_t* l_edge;  // [N,4]
  const int32_t* r_edge;  // [N,4]
  // MPHF (pow2 levels; see index/mphf.py)
  int32_t n_levels;
  const uint32_t* seeds;
  const uint32_t* masks;
  const uint32_t* word_offsets;
  const uint32_t* key_offsets;
  const uint32_t* bits;
  const uint32_t* ranks;
  // slot-ordered keys/values
  const uint32_t* kmer_keys;  // [n_keys, W]
  const uint32_t* kmer_node;
  const uint32_t* kmer_offset;
  int64_t n_keys;
  int32_t k, W;
};

// probe + stored-key verification (golden.py _MphfBackedMap.get)
inline bool kmer_lookup(const Index& ix, const uint32_t* words, int32_t* node,
                        int32_t* off) {
  int64_t slot = -1;
  for (int lv = 0; lv < ix.n_levels; lv++) {
    uint32_t h = hash_words(words, ix.W, ix.seeds[lv]) & ix.masks[lv];
    uint32_t w = ix.word_offsets[lv] + (h >> 5);
    if ((ix.bits[w] >> (h & 31)) & 1u) {
      uint32_t below = ix.bits[w] & ((1u << (h & 31)) - 1u);
      slot = (int64_t)ix.key_offsets[lv] + ix.ranks[w] +
             __builtin_popcount(below);
      break;
    }
  }
  if (slot < 0 || slot >= ix.n_keys) return false;
  const uint32_t* stored = ix.kmer_keys + slot * ix.W;
  for (int j = 0; j < ix.W; j++)
    if (stored[j] != words[j]) return false;
  *node = (int32_t)ix.kmer_node[slot];
  *off = (int32_t)ix.kmer_offset[slot];
  return true;
}

// k-mer words of read window at pos (dna.pack_kmers layout: base j of the
// window at bit 2*(k-1-j), little-endian words)
inline void window_words(const uint8_t* read, int pos, int k, uint32_t* out,
                         int W) {
  for (int j = 0; j < W; j++) out[j] = 0;
  for (int j = 0; j < k; j++) {
    int bitpos = 2 * (k - 1 - j);
    out[bitpos >> 5] |= (uint32_t)(read[pos + j] & 3) << (bitpos & 31);
  }
}

inline int ref_base(const Index& ix, int node, int pos) {
  return ix.seq_pool[ix.node_start[node] + pos];
}

// golden.py map_read_to_nodes_with_mismatch; returns n_nodes (0 = unmapped)
int map_one(const Index& ix, const uint8_t* read, int L, int allowed,
            double left_frac, int32_t* out_nodes, int cap, int32_t* out_cov,
            int32_t* out_mm) {
  int k = ix.k;
  *out_cov = 0;
  *out_mm = 0;
  if (L < k) return 0;
  int cov = 0, mm = 0, nn = 0;
  // double, matching python's int(LEFT_EXTEND_FRACTION * L) exactly
  int left_thresh = (int)(left_frac * (double)L);
  int last_kmer_pos = L - k;
  uint32_t words[4];

  auto push = [&](int node) {
    if (nn < cap) out_nodes[nn] = node;
    nn++;
  };

  // stride-3 scan (src/pseudoaligner.rs:91-114)
  auto find_kmer_match = [&](int pos, int32_t* node, int32_t* off) {
    while (pos <= last_kmer_pos) {
      window_words(read, pos, k, words, ix.W);
      if (kmer_lookup(ix, words, node, off)) return pos;
      pos += 3;
    }
    return pos;
  };

  int32_t node_id = -1, kmer_offset = -1;
  int kmer_pos = find_kmer_match(0, &node_id, &kmer_offset);
  bool have = kmer_pos <= last_kmer_pos && node_id >= 0;

  // left extension (src/pseudoaligner.rs:124-205)
  if (have && kmer_pos >= left_thresh) {
    int last_pos = kmer_pos - 1;
    int prev_node_id = node_id;
    int prev_kmer_offset = kmer_offset > 0 ? kmer_offset - 1 : 0;
    for (;;) {
      int node = prev_node_id;
      int skipped_read = last_pos + 1;
      int skipped_ref = prev_kmer_offset + 1;
      int max_matchable = std::min(skipped_read, skipped_ref);

      bool premature = false;
      int matched = 0, seen_snp = 0;
      for (int idx = 0; idx < max_matchable; idx++) {
        int rp = prev_kmer_offset - idx;
        int ro = last_pos - idx;
        if (ref_base(ix, node, rp) != (read[ro] & 3)) {
          mm++;
          seen_snp++;
          if (seen_snp > allowed) {
            premature = true;
            break;
          }
        }
        matched++;
        cov++;
      }
      if (last_pos + 1 - matched == 0 || premature) break;
      last_pos -= matched;

      int nb = read[last_pos] & 3;
      if ((ix.node_exts[node] >> (4 + nb)) & 1) {
        prev_node_id = ix.l_edge[node * 4 + nb];
        prev_kmer_offset = (int)ix.node_len[prev_node_id] - k;
        push(prev_node_id);
      } else {
        break;
      }
    }
  }

  // forward search (src/pseudoaligner.rs:208-302)
  if (have) {
    for (;;) {
      int node = node_id;
      kmer_pos += k;
      cov += k;
      push(node);

      int remaining = L - kmer_pos;
      int informative = (int)ix.node_len[node] - (kmer_offset + k);
      int ref_offset = kmer_offset + k;
      int max_matchable = std::min(remaining, informative);

      bool premature = false;
      int matched = 0, seen_snp = 0;
      for (int idx = 0; idx < max_matchable; idx++) {
        if (ref_base(ix, node, ref_offset + idx) !=
            (read[kmer_pos + idx] & 3)) {
          mm++;
          seen_snp++;
          if (seen_snp > allowed) {
            premature = true;
            break;
          }
        }
        matched++;
        cov++;
      }

      kmer_pos += matched;
      if (kmer_pos >= L) break;

      int nb = read[kmer_pos] & 3;
      if (!premature && ((ix.node_exts[node] >> nb) & 1)) {
        node_id = ix.r_edge[node * 4 + nb];
        kmer_offset = 0;
        kmer_pos -= k - 1;
        cov -= k - 1;
      } else {
        if (kmer_pos > last_kmer_pos) break;
        kmer_pos = find_kmer_match(kmer_pos, &node_id, &kmer_offset);
        if (kmer_pos > last_kmer_pos) break;
      }
    }
  }

  if (nn == 0) return 0;
  *out_cov = cov;
  *out_mm = mm;
  return nn < cap ? nn : cap;
}

}  // namespace

extern "C" {

// Map n_reads reads; outputs per read: coverage, mismatches, node list
// (nodes[i*cap .. ], -1 padded) and count.  Unmapped reads get cov=mm=0,
// n_nodes=0 (mirrors golden.py returning None).
void pa_map_reads(
    const uint8_t* seq_pool, const uint32_t* node_start,
    const uint32_t* node_len, const uint8_t* node_exts, const int32_t* l_edge,
    const int32_t* r_edge, int32_t n_levels, const uint32_t* seeds,
    const uint32_t* masks, const uint32_t* word_offsets,
    const uint32_t* key_offsets, const uint32_t* bits, const uint32_t* ranks,
    const uint32_t* kmer_keys, const uint32_t* kmer_node,
    const uint32_t* kmer_offset, int64_t n_keys, int32_t k,
    const uint8_t* codes, const int32_t* lens, int64_t n_reads, int32_t L,
    int32_t allowed_mm, double left_frac, int32_t cap, int32_t n_threads,
    int32_t* out_cov, int32_t* out_mm, int32_t* out_nodes,
    int32_t* out_n_nodes) {
  Index ix{seq_pool, node_start, node_len, node_exts, l_edge, r_edge,
           n_levels, seeds, masks, word_offsets, key_offsets, bits, ranks,
           kmer_keys, kmer_node, kmer_offset, n_keys, k, (2 * k + 31) / 32};
  if (n_threads < 1) n_threads = 1;
  auto work = [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; i++) {
      for (int j = 0; j < cap; j++) out_nodes[i * cap + j] = -1;
      out_n_nodes[i] = map_one(ix, codes + i * L, lens[i], allowed_mm,
                               left_frac, out_nodes + i * cap, cap,
                               out_cov + i, out_mm + i);
    }
  };
  std::vector<std::thread> ths;
  int64_t chunk = (n_reads + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    int64_t b = t * chunk, e = std::min(n_reads, b + chunk);
    if (b < e) ths.emplace_back(work, b, e);
  }
  for (auto& th : ths) th.join();
}

// Batch EC-list intersection (the host materialization of re-mapped
// reads' transcript sets — src/pseudoaligner.rs:323-356 semantics).
// rows: m x width int64 distinct EC ids, ascending, >= sent padded.
// ec_offsets/ec_txs: the index's EC CSR (per-class lists sorted).
// out_flat must have room for sum over rows of the SHORTEST member
// list (the caller sizes it; intersections only shrink).
void pa_intersect_ecs(
    const int64_t* rows, int64_t m, int32_t width,
    const int64_t* ec_offsets, const uint32_t* ec_txs, int64_t sent,
    uint32_t* out_flat, int64_t* out_offsets) {
  int64_t pos = 0;
  out_offsets[0] = 0;
  std::vector<uint32_t> cur, nxt;
  for (int64_t i = 0; i < m; i++) {
    const int64_t* r = rows + i * width;
    int nids = 0;
    // ids must be in [0, sent): a negative marker (e.g. the -3
    // overflow channel) would index ec_offsets out of bounds; the
    // Python wrapper's capacity math already clips negatives, so the
    // scan must stop on them too (review r5)
    while (nids < width && r[nids] >= 0 && r[nids] < sent) nids++;
    if (nids == 0) {
      out_offsets[i + 1] = pos;
      continue;
    }
    int best = 0;
    int64_t bl = INT64_MAX;
    for (int j = 0; j < nids; j++) {
      int64_t l = ec_offsets[r[j] + 1] - ec_offsets[r[j]];
      if (l < bl) { bl = l; best = j; }
    }
    cur.assign(ec_txs + ec_offsets[r[best]],
               ec_txs + ec_offsets[r[best] + 1]);
    for (int j = 0; j < nids && !cur.empty(); j++) {
      if (j == best) continue;
      const uint32_t* p = ec_txs + ec_offsets[r[j]];
      const uint32_t* pe = ec_txs + ec_offsets[r[j] + 1];
      nxt.clear();
      size_t x = 0;
      while (x < cur.size() && p < pe) {
        if (cur[x] < *p) x++;
        else if (*p < cur[x]) p++;
        else { nxt.push_back(cur[x]); x++; p++; }
      }
      cur.swap(nxt);
    }
    for (uint32_t v : cur) out_flat[pos++] = v;
    out_offsets[i + 1] = pos;
  }
}

// Batch intersection of sorted uint32 list PAIRS (the paired-end
// fragment-compatibility sets: row i = intersect(A[i], B[i])).
// out must have room for sum_i min(|A_i|, |B_i|).
void pa_intersect_pairs(const uint32_t* fa, const int64_t* oa,
                        const uint32_t* fb, const int64_t* ob, int64_t m,
                        uint32_t* out, int64_t* oo) {
  int64_t pos = 0;
  oo[0] = 0;
  for (int64_t i = 0; i < m; i++) {
    const uint32_t* a = fa + oa[i];
    const uint32_t* ae = fa + oa[i + 1];
    const uint32_t* b = fb + ob[i];
    const uint32_t* be = fb + ob[i + 1];
    while (a < ae && b < be) {
      if (*a < *b) a++;
      else if (*b < *a) b++;
      else { out[pos++] = *a; a++; b++; }
    }
    oo[i + 1] = pos;
  }
}

}  // extern "C"
