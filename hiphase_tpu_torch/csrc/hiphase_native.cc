// hiphase_tpu native host library.
//
// The reference's only native dependency is htslib (C) — BGZF codec with a
// thread pool plus record I/O (SURVEY.md §2 L0/§2.11). This library provides
// the TPU build's equivalents:
//   * multithreaded BGZF block compression / decompression (the analog of
//     htslib's bgzf + tpool, used by the BAM/VCF writers and readers)
//   * batched Levenshtein edit distance (hot loop #3, the local-realignment
//     inexact matcher, ref: src/sequence_alignment.rs)
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).
//
// Build: make -C native   (produces libhiphase_native.so)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <thread>
#include <string>
#include <unordered_map>
#include <queue>
#include <utility>
#include <vector>

// ---- BGZF codec (hiphase_tpu_torch): begin ----
// The codec is chosen when the library is built: HN_CODEC names it
// (2 = libdeflate, 1 = zlib, 0 = none), else the first whose header the
// compiler finds. Without a codec the two BGZF functions return -1 and
// their callers use Python's zlib.
#ifndef HN_CODEC
#if __has_include(<libdeflate.h>)
#define HN_CODEC 2
#elif __has_include(<zlib.h>)
#define HN_CODEC 1
#else
#define HN_CODEC 0
#endif
#endif
#if HN_CODEC == 2
#include <libdeflate.h>
#elif HN_CODEC == 1
#include <zlib.h>
#elif HN_CODEC != 0
#error "HN_CODEC must be 0 (none), 1 (zlib) or 2 (libdeflate)"
#endif
// ---- BGZF codec (hiphase_tpu_torch): end ----

namespace {

constexpr int kBgzfHeaderLen = 18;   // gzip header + BC extra subfield
constexpr int kBgzfFooterLen = 8;    // CRC32 + ISIZE

// Writes the 18-byte BGZF member header with total block size `bsize`.
void write_bgzf_header(uint8_t* dst, uint32_t bsize) {
  static const uint8_t kFixed[16] = {
      0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00,
      0x00, 0xff, 0x06, 0x00, 0x42, 0x43, 0x02, 0x00};
  std::memcpy(dst, kFixed, sizeof(kFixed));
  uint16_t bs = static_cast<uint16_t>(bsize - 1);
  dst[16] = bs & 0xff;
  dst[17] = (bs >> 8) & 0xff;
}

// Parallel-for over [0, n) with at most `threads` workers.
template <typename F>
void parallel_for(int64_t n, int threads, F&& fn) {
  if (threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      fn(i);
    }
  };
  int n_workers = static_cast<int>(std::min<int64_t>(threads, n));
  std::vector<std::thread> pool;
  pool.reserve(n_workers);
  for (int t = 0; t < n_workers; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Compress `n_blocks` independent payloads into BGZF blocks.
//   in:          concatenated payload bytes
//   in_offsets:  n_blocks+1 offsets into `in` (block i = [off[i], off[i+1]))
//   out:         output buffer of capacity `out_capacity`
//   out_offsets: n_blocks+1, filled with offsets of the emitted blocks
// Returns total bytes written, or -1 on error.
// ---- BGZF codec (hiphase_tpu_torch): begin ----
// Which codec this library was built with: 2 = libdeflate, 1 = zlib,
// 0 = none.
int32_t hn_codec() { return HN_CODEC; }

// Raw deflate of one payload into `dst` (capacity `cap`); the compressed
// length, or 0 on failure.
static size_t hn_deflate_raw(int level, const uint8_t* src, size_t len,
                             uint8_t* dst, size_t cap) {
#if HN_CODEC == 2
  // libdeflate's compressor + crc32 are ~2x zlib's at the same level
  thread_local libdeflate_compressor* comp_cache = nullptr;
  thread_local int comp_level = -1;
  if (comp_cache == nullptr || comp_level != level) {
    if (comp_cache != nullptr) libdeflate_free_compressor(comp_cache);
    comp_cache = libdeflate_alloc_compressor(level);
    comp_level = level;
  }
  if (comp_cache == nullptr) return 0;
  return libdeflate_deflate_compress(comp_cache, src, len, dst, cap);
#elif HN_CODEC == 1
  z_stream zs{};
  if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) !=
      Z_OK) {
    return 0;
  }
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(len);
  zs.next_out = dst;
  zs.avail_out = static_cast<uInt>(cap);
  int rc = deflate(&zs, Z_FINISH);
  size_t out_len = cap - zs.avail_out;
  deflateEnd(&zs);
  return rc == Z_STREAM_END ? out_len : 0;
#else
  (void)level, (void)src, (void)len, (void)dst, (void)cap;
  return 0;
#endif
}

static uint32_t hn_crc32(const uint8_t* src, size_t len) {
#if HN_CODEC == 2
  return static_cast<uint32_t>(libdeflate_crc32(0, src, len));
#elif HN_CODEC == 1
  return static_cast<uint32_t>(
      crc32(crc32(0L, Z_NULL, 0), src, static_cast<uInt>(len)));
#else
  (void)src, (void)len;
  return 0;
#endif
}

// Raw inflate of `src` into exactly `expected` bytes at `dst`.
static bool hn_inflate_raw(const uint8_t* src, size_t len, uint8_t* dst,
                           size_t expected) {
#if HN_CODEC == 2
  // libdeflate's whole-buffer decompressor is ~2-3x faster than zlib's
  // streaming inflate for BGZF-sized blocks (the pipeline's dominant
  // byte-volume operation: every read's bases+quals pass through here)
  size_t actual = 0;
  thread_local libdeflate_decompressor* dec = libdeflate_alloc_decompressor();
  return dec != nullptr &&
         libdeflate_deflate_decompress(dec, src, len, dst, expected,
                                       &actual) == LIBDEFLATE_SUCCESS &&
         actual == expected;
#elif HN_CODEC == 1
  z_stream zs{};
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(len);
  zs.next_out = dst;
  zs.avail_out = static_cast<uInt>(expected);
  int rc = inflate(&zs, Z_FINISH);
  size_t actual = expected - zs.avail_out;
  inflateEnd(&zs);
  return rc == Z_STREAM_END && actual == expected;
#else
  (void)src, (void)len, (void)dst, (void)expected;
  return false;
#endif
}

int64_t hn_bgzf_compress_many(const uint8_t* in, const int64_t* in_offsets,
                              int n_blocks, int level, uint8_t* out,
                              int64_t out_capacity, int64_t* out_offsets,
                              int n_threads) {
  if (HN_CODEC == 0) return -1;
  // worst-case deflate expansion per 64KiB block is well under this bound
  const int64_t max_block = 65536 + 1024 + kBgzfHeaderLen + kBgzfFooterLen;
  std::vector<std::vector<uint8_t>> results(n_blocks);
  std::atomic<bool> failed(false);

  parallel_for(n_blocks, n_threads, [&](int64_t i) {
    if (failed.load(std::memory_order_relaxed)) return;
    const uint8_t* src = in + in_offsets[i];
    int64_t src_len = in_offsets[i + 1] - in_offsets[i];
    if (src_len > 65536) {
      failed.store(true);
      return;
    }
    std::vector<uint8_t>& dst = results[i];
    dst.resize(max_block);
    size_t cdata_len = hn_deflate_raw(
        level, src, static_cast<size_t>(src_len),
        dst.data() + kBgzfHeaderLen,
        static_cast<size_t>(max_block - kBgzfHeaderLen - kBgzfFooterLen));
    if (cdata_len == 0) {
      failed.store(true);
      return;
    }
    uint32_t bsize =
        static_cast<uint32_t>(kBgzfHeaderLen + cdata_len + kBgzfFooterLen);
    write_bgzf_header(dst.data(), bsize);
    uint32_t crc = hn_crc32(src, static_cast<size_t>(src_len));
    uint8_t* tail = dst.data() + kBgzfHeaderLen + cdata_len;
    uint32_t isize = static_cast<uint32_t>(src_len);
    std::memcpy(tail, &crc, 4);
    std::memcpy(tail + 4, &isize, 4);
    dst.resize(bsize);
  });
  if (failed.load()) return -1;

  int64_t total = 0;
  out_offsets[0] = 0;
  for (int i = 0; i < n_blocks; ++i) {
    total += static_cast<int64_t>(results[i].size());
    out_offsets[i + 1] = total;
  }
  if (total > out_capacity) return -1;
  parallel_for(n_blocks, n_threads, [&](int64_t i) {
    std::memcpy(out + out_offsets[i], results[i].data(), results[i].size());
  });
  return total;
}

// Decompress `n_blocks` BGZF blocks.
//   in:            concatenated raw BGZF blocks
//   block_offsets: n_blocks+1 offsets of each block in `in`
//   out:           output buffer
//   out_offsets:   n_blocks+1 offsets; caller fills via hn_bgzf_scan first
// Returns 0 on success, -1 on error.
int32_t hn_bgzf_decompress_many(const uint8_t* in, const int64_t* block_offsets,
                                int n_blocks, uint8_t* out,
                                const int64_t* out_offsets, int n_threads) {
  if (HN_CODEC == 0) return -1;
  std::atomic<bool> failed(false);
  parallel_for(n_blocks, n_threads, [&](int64_t i) {
    if (failed.load(std::memory_order_relaxed)) return;
    const uint8_t* block = in + block_offsets[i];
    int64_t block_len = block_offsets[i + 1] - block_offsets[i];
    if (block_len < kBgzfHeaderLen + kBgzfFooterLen) {
      failed.store(true);
      return;
    }
    // extra-field length lives at offset 10; the BC subfield may not be
    // first in pathological writers, but both our writer and htslib put it
    // first; fall back to failure otherwise.
    uint16_t xlen = static_cast<uint16_t>(block[10] | (block[11] << 8));
    int64_t cdata_off = 12 + xlen;
    int64_t cdata_len = block_len - cdata_off - kBgzfFooterLen;
    uint32_t isize;
    std::memcpy(&isize, block + block_len - 4, 4);
    int64_t expected = out_offsets[i + 1] - out_offsets[i];
    if (static_cast<int64_t>(isize) != expected || cdata_len < 0) {
      failed.store(true);
      return;
    }
    if (!hn_inflate_raw(block + cdata_off, static_cast<size_t>(cdata_len),
                        out + out_offsets[i],
                        static_cast<size_t>(expected))) {
      failed.store(true);
    }
  });
  return failed.load() ? -1 : 0;
}
// ---- BGZF codec (hiphase_tpu_torch): end ----

// Scan a BGZF byte stream, emitting (block offset, uncompressed size) pairs.
// Returns the number of blocks found, or -1 on malformed input.
//   offsets:  capacity `max_blocks + 1`; filled with block start offsets,
//             plus the end offset at [n]
//   isizes:   capacity `max_blocks`; uncompressed sizes
int64_t hn_bgzf_scan(const uint8_t* in, int64_t len, int64_t* offsets,
                     int64_t* isizes, int64_t max_blocks) {
  int64_t pos = 0;
  int64_t n = 0;
  while (pos < len) {
    if (n >= max_blocks) return -1;
    if (pos + kBgzfHeaderLen > len) return -1;
    if (in[pos] != 0x1f || in[pos + 1] != 0x8b) return -1;
    uint16_t xlen =
        static_cast<uint16_t>(in[pos + 10] | (in[pos + 11] << 8));
    // find the BC subfield for BSIZE
    int64_t ext = pos + 12;
    int64_t ext_end = ext + xlen;
    if (ext_end > len) return -1;
    int64_t bsize = -1;
    while (ext + 4 <= ext_end) {
      uint8_t si1 = in[ext], si2 = in[ext + 1];
      uint16_t slen = static_cast<uint16_t>(in[ext + 2] | (in[ext + 3] << 8));
      if (si1 == 'B' && si2 == 'C' && slen == 2) {
        bsize = (in[ext + 4] | (in[ext + 5] << 8)) + 1;
        break;
      }
      ext += 4 + slen;
    }
    if (bsize < 0 || pos + bsize > len) return -1;
    offsets[n] = pos;
    uint32_t isize;
    std::memcpy(&isize, in + pos + bsize - 4, 4);
    isizes[n] = isize;
    ++n;
    pos += bsize;
  }
  offsets[n] = pos;
  return n;
}

// Batched Levenshtein edit distance over padded byte matrices.
//   a: [n, a_stride], b: [n, b_stride]; lens give true lengths per row.
// Writes n int32 distances to `out`.
void hn_edit_distance_batch(const uint8_t* a, const int32_t* a_lens,
                            int32_t a_stride, const uint8_t* b,
                            const int32_t* b_lens, int32_t b_stride,
                            int32_t n, int32_t* out, int n_threads) {
  parallel_for(n, n_threads, [&](int64_t i) {
    const uint8_t* va = a + i * a_stride;
    const uint8_t* vb = b + i * b_stride;
    int32_t la = a_lens[i];
    int32_t lb = b_lens[i];
    if (la == 0 || lb == 0) {
      out[i] = la + lb;
      return;
    }
    std::vector<int32_t> row(lb + 1);
    for (int32_t j = 0; j <= lb; ++j) row[j] = j;
    for (int32_t x = 1; x <= la; ++x) {
      int32_t diag = row[0];
      row[0] = x;
      for (int32_t y = 1; y <= lb; ++y) {
        int32_t sub = diag + (va[x - 1] != vb[y - 1]);
        diag = row[y];
        row[y] = std::min({sub, diag + 1, row[y - 1] + 1});
      }
    }
    out[i] = row[lb];
  });
}

int32_t hn_version() { return 1; }

}  // extern "C"

namespace {

int32_t levenshtein(const uint8_t* a, int64_t la, const uint8_t* b,
                    int64_t lb) {
  if (la == 0 || lb == 0) return static_cast<int32_t>(la + lb);
  std::vector<int32_t> row(lb + 1);
  for (int64_t j = 0; j <= lb; ++j) row[j] = static_cast<int32_t>(j);
  for (int64_t x = 1; x <= la; ++x) {
    int32_t diag = row[0];
    row[0] = static_cast<int32_t>(x);
    for (int64_t y = 1; y <= lb; ++y) {
      int32_t sub = diag + (a[x - 1] != b[y - 1]);
      diag = row[y];
      row[y] = std::min({sub, diag + 1, row[y - 1] + 1});
    }
  }
  return row[lb];
}

}  // namespace

extern "C" {

// Anchor-window allele matching for one read across many variants — the
// native form of the local-realignment inner loop
// (ref: src/read_parsing.rs:196-353). Variants flagged `skip` (ignored,
// SV-deletion handled by the caller, or suppressed) are left untouched.
//
//   r2q:       [ref_span] read position for each reference coordinate in
//              [ref_base, ref_base + ref_span), or -1 where unaligned
//   windows:   per variant: pos, ref_len, prefix_len, postfix_len
//   allele blobs: concatenated allele bytes with offset/length arrays
//   out codes: allele (0/1/2/3), qual, exact flag, overlap flag
void hn_window_alleles(
    const int64_t* r2q, int64_t ref_base, int64_t ref_span,
    const uint8_t* read_seq, const uint8_t* read_quals, int64_t read_len,
    int64_t aligned_start, int64_t aligned_end,
    int32_t n_variants,
    const int64_t* var_pos, const int64_t* var_ref_len,
    const int64_t* var_prefix, const int64_t* var_postfix,
    const uint8_t* skip_flags,
    const uint8_t* allele_blob,
    const int64_t* a0_off, const int64_t* a0_len,
    const int64_t* a1_off, const int64_t* a1_len,
    const int32_t* baseline_qual,
    uint8_t* out_allele, uint8_t* out_qual, uint8_t* out_exact,
    uint8_t* out_overlap) {
  auto lookup = [&](int64_t rc) -> int64_t {
    if (rc < ref_base || rc >= ref_base + ref_span) return -1;
    return r2q[rc - ref_base];
  };
  (void)read_len;
  for (int32_t vi = 0; vi < n_variants; ++vi) {
    if (skip_flags[vi]) continue;
    int64_t pos = var_pos[vi];
    int64_t ref_len = var_ref_len[vi];
    int64_t prefix_len = var_prefix[vi];
    int64_t postfix_len = var_postfix[vi];
    int64_t first_start = pos - prefix_len;
    int64_t last_start = pos + 1;
    int64_t first_end = pos + ref_len;
    int64_t last_end = first_end + postfix_len + 1;

    int64_t closest_start = -1, closest_end = -1;
    for (int64_t sc = last_start - 1; sc >= first_start; --sc) {
      int64_t si = lookup(sc);
      if (si >= 0) { closest_start = si; break; }
    }
    for (int64_t ec = first_end; ec < last_end; ++ec) {
      int64_t ei = lookup(ec);
      if (ei >= 0) { closest_end = ei; break; }
    }

    int64_t start_coordinate = -1, end_coordinate = -1;
    int64_t start_clip = 0, end_clip = 0;
    if (closest_start >= 0 && closest_end >= 0) {
      for (int64_t sc = first_start; sc < last_start; ++sc) {
        ++start_clip;
        int64_t si = lookup(sc);
        if (si < 0) continue;
        if (closest_start - si > 2 * prefix_len) continue;
        start_coordinate = si;
        for (int64_t ec = last_end - 1; ec >= first_end; --ec) {
          ++end_clip;
          int64_t ei = lookup(ec);
          if (ei < 0) continue;
          if (ei - closest_end > 2 * postfix_len) continue;
          end_coordinate = ei;
          break;
        }
        break;
      }
    }

    if (start_coordinate >= 0 && end_coordinate >= 0) {
      int64_t ss = start_coordinate, se = end_coordinate;
      const uint8_t* obs = read_seq + ss;
      int64_t obs_len = se - ss;
      const uint8_t* a0 = allele_blob + a0_off[vi];
      const uint8_t* a1 = allele_blob + a1_off[vi];
      int64_t l0 = a0_len[vi], l1 = a1_len[vi];
      uint8_t allele;
      uint8_t exact = 0;
      if (obs_len == l0 && std::memcmp(obs, a0, l0) == 0) {
        allele = 0;
        exact = 1;
      } else if (obs_len == l1 && std::memcmp(obs, a1, l1) == 0) {
        allele = 1;
        exact = 1;
      } else {
        int64_t hc = start_clip - 1, tc = end_clip - 1;
        int32_t d0 = levenshtein(obs, obs_len, a0 + hc, l0 - hc - tc);
        int32_t d1 = levenshtein(obs, obs_len, a1 + hc, l1 - hc - tc);
        allele = d0 < d1 ? 0 : (d1 < d0 ? 1 : 2);
      }
      // harmonic-mean base-quality scaling capped at 40
      double qual_factor = 1.0;
      if (obs_len > 0) {
        double denom = 0.0;
        bool zero_q = false;
        for (int64_t k = 0; k < obs_len; ++k) {
          uint8_t q = read_quals[ss + k];
          if (q == 0) { zero_q = true; break; }
          denom += 1.0 / q;
        }
        double harmonic = zero_q ? 0.0 : obs_len / denom;
        qual_factor = std::min(harmonic / 40.0, 1.0);
      }
      double q = baseline_qual[vi] * qual_factor;
      out_qual[vi] = static_cast<uint8_t>(q < 1.0 ? 1.0 : q);
      out_allele[vi] = allele;
      out_exact[vi] = exact;
      out_overlap[vi] = 1;
    } else if (aligned_start <= pos && pos < aligned_end) {
      out_allele[vi] = 2;
      out_qual[vi] = 0;
      out_exact[vi] = 0;
      out_overlap[vi] = 1;
    } else {
      out_allele[vi] = 3;
      out_qual[vi] = 0;
      out_exact[vi] = 0;
      out_overlap[vi] = 0;
    }
  }
}

}  // extern "C"

namespace {

// Traversal-set interning for the graph WFA: sets are dynamic bitsets over
// graph nodes, stored as word vectors and deduplicated by content.
// Interns fixed-width bitsets in one arena with an open-addressing table:
// zero allocations per intern in steady state (the per-transition
// vector<uint64_t> churn of the previous map-of-vectors design was a
// measurable share of align time).
struct SetPool {
  size_t words;
  std::vector<uint64_t> arena;  // id * words
  std::vector<int> table;       // open addressing, -1 = empty
  size_t mask;
  int n = 0;

  explicit SetPool(size_t w) : words(w), table(1024, -1), mask(1023) {}

  const uint64_t* get(int id) const {
    return arena.data() + static_cast<size_t>(id) * words;
  }

  size_t hash_span(const uint64_t* v) const {
    size_t h = words;
    for (size_t i = 0; i < words; ++i)
      h ^= v[i] + 0x9e3779b97f4a7c15ULL + (h << 6) + (h >> 2);
    return h;
  }

  void rehash() {
    std::vector<int> old;
    old.swap(table);
    table.assign((mask + 1) * 2, -1);
    mask = table.size() - 1;
    for (int id_ : old) {
      if (id_ < 0) continue;
      size_t h = hash_span(get(id_)) & mask;
      while (table[h] != -1) h = (h + 1) & mask;
      table[h] = id_;
    }
  }

  int intern(const uint64_t* v) {
    size_t h = hash_span(v) & mask;
    while (table[h] != -1) {
      int id_ = table[h];
      if (std::memcmp(get(id_), v, words * 8) == 0) return id_;
      h = (h + 1) & mask;
    }
    int id_ = n++;
    arena.insert(arena.end(), v, v + words);
    table[h] = id_;
    if (static_cast<size_t>(n) * 2 > mask) rehash();
    return id_;
  }
};

}  // namespace

extern "C" {

// Graph-WFA edit distance with pruning (the native form of
// align/wfa_graph.py::edit_distance_with_pruning; ref: wfa_graph.rs:350-650).
//
//   node_off:  [n_nodes+1] offsets into node_blob (node sequences)
//   edge_off:  [n_nodes+1] offsets into edge_dst (successor lists)
//   read:      the aligned read subsequence
//   traversed: [n_nodes] out — 1 where the best paths traverse the node
// Returns the edit distance, or -1 when max_edit_distance is exceeded.
int64_t hn_wfa_align(const uint8_t* node_blob, const int64_t* node_off,
                     int32_t n_nodes, const int32_t* edge_dst,
                     const int64_t* edge_off, const uint8_t* read,
                     int64_t read_len, int64_t prune_distance,
                     int64_t max_edit_distance, uint8_t* traversed) {
  using Wave = std::pair<int64_t, int>;  // (offset into node seq, set index)
  // Append-only wavefront lists per node, grouped by diagonal with one
  // sort at consume time: allocation-free in steady state (the previous
  // per-diagonal hash maps spent most of the align time on container
  // churn). Entry = (diagonal key, wave).
  using Entry = std::pair<int64_t, Wave>;
  using Front = std::vector<Entry>;

  const size_t words = (n_nodes + 63) / 64;
  if (words > 16) return -2;  // >1024 nodes: callers use the host fallback
  uint64_t buf[16];
  SetPool pool(words);
  {
    std::memset(buf, 0, words * 8);
    buf[0] |= 1ULL;
    pool.intern(buf);  // set 0 = {node 0}
  }

  std::vector<Front> active(n_nodes), next(n_nodes);
  std::vector<char> active_any(n_nodes, 0), next_any(n_nodes, 0);
  std::vector<std::unordered_map<int64_t, int64_t>> maxfront(n_nodes);
  active[0].push_back({0, {0, 0}});
  active_any[0] = 1;

  int64_t edit_distance = 0;
  int64_t farthest = 0;
  int64_t min_progression = 0;

  for (;;) {
    for (int32_t ni = 0; ni < n_nodes; ++ni) {
      if (!active_any[ni]) continue;
      active_any[ni] = 0;
      // in place: same-step inserts only target successor nodes
      Front& wavefront = active[ni];
      std::sort(wavefront.begin(), wavefront.end(),
                [](const Entry& a, const Entry& b) {
                  return a.first < b.first;
                });
      const uint8_t* seq = node_blob + node_off[ni];
      const int64_t node_len = node_off[ni + 1] - node_off[ni];
      auto& mf = maxfront[ni];

      size_t gi = 0;
      while (gi < wavefront.size()) {
        const int64_t other_start = wavefront[gi].first;
        size_t gj = gi;
        while (gj < wavefront.size() && wavefront[gj].first == other_start)
          ++gj;
        int64_t max_offset = 0;
        for (size_t k = gi; k < gj; ++k) {
          Wave& w = wavefront[k].second;
          int64_t off = w.first;
          int64_t opos = other_start + off;
          // greedy match extension, 8 bytes per probe
          while (off + 8 <= node_len && opos + 8 <= read_len) {
            uint64_t a, b;
            std::memcpy(&a, seq + off, 8);
            std::memcpy(&b, read + opos, 8);
            uint64_t x = a ^ b;
            if (x) {
              int adv = __builtin_ctzll(x) >> 3;
              off += adv;
              opos += adv;
              goto extended;
            }
            off += 8;
            opos += 8;
          }
          while (off < node_len && opos < read_len && seq[off] == read[opos]) {
            ++off;
            ++opos;
          }
        extended:
          w.first = off;
          if (off > max_offset) max_offset = off;
        }
        auto mit = mf.find(other_start);
        int64_t prev_best = (mit == mf.end()) ? 0 : mit->second;
        if (max_offset < prev_best ||
            other_start + max_offset < min_progression) {
          gi = gj;
          continue;  // dominated or pruned
        }
        mf[other_start] = max_offset;
        int64_t progression = other_start + max_offset;
        if (progression > farthest) farthest = progression;

        // union the traversal sets of all ties at the best offset
        int best_set = -1;
        int count = 0;
        for (size_t k = gi; k < gj; ++k) {
          const Wave& w = wavefront[k].second;
          if (w.first != max_offset) continue;
          if (count == 0) {
            best_set = w.second;
          } else {
            if (count == 1)
              std::memcpy(buf, pool.get(best_set), words * 8);
            const uint64_t* other = pool.get(w.second);
            for (size_t q = 0; q < words; ++q) buf[q] |= other[q];
          }
          ++count;
        }
        if (count > 1) best_set = pool.intern(buf);

        if (max_offset == node_len) {
          if (ni == n_nodes - 1) {
            if (other_start + max_offset < read_len) {
              next[ni].push_back({other_start + 1, {max_offset, best_set}});
              next_any[ni] = 1;
            }
          } else {
            int64_t new_offset = other_start + max_offset;
            for (int64_t e = edge_off[ni]; e < edge_off[ni + 1]; ++e) {
              int32_t succ = edge_dst[e];
              std::memcpy(buf, pool.get(best_set), words * 8);
              buf[succ / 64] |= 1ULL << (succ % 64);
              int nsi = pool.intern(buf);
              active[succ].push_back({new_offset, {0, nsi}});
              active_any[succ] = 1;
            }
          }
        } else {
          Front& nf = next[ni];
          nf.push_back({other_start - 1, {max_offset + 1, best_set}});
          next_any[ni] = 1;
          if (other_start + max_offset < read_len) {
            nf.push_back({other_start, {max_offset + 1, best_set}});
            nf.push_back({other_start + 1, {max_offset, best_set}});
          }
        }
        gi = gj;
      }

      if (ni == n_nodes - 1) {
        // final check over the post-extension wavefront
        std::vector<int> finals;
        for (const Entry& en : wavefront) {
          if (en.second.first == node_len &&
              en.first + en.second.first == read_len) {
            finals.push_back(en.second.second);
          }
        }
        if (!finals.empty()) {
          std::memset(buf, 0, words * 8);
          for (int s : finals) {
            const uint64_t* v = pool.get(s);
            for (size_t q = 0; q < words; ++q) buf[q] |= v[q];
          }
          for (int32_t i = 0; i < n_nodes; ++i) {
            traversed[i] = (buf[i / 64] >> (i % 64)) & 1;
          }
          return edit_distance;
        }
      }
    }

    ++edit_distance;
    for (int32_t i = 0; i < n_nodes; ++i) active[i].clear();
    active.swap(next);
    active_any.swap(next_any);
    for (int32_t i = 0; i < n_nodes; ++i) next_any[i] = 0;
    if (farthest > prune_distance) min_progression = farthest - prune_distance;
    if (edit_distance > max_edit_distance) return -1;
  }
}

}  // extern "C"

// ---- WFA graph builder (hiphase_tpu_torch): begin ----
#include "wfa_build.h"
// ---- WFA graph builder (hiphase_tpu_torch): end ----

// ---------------------------------------------------------------------------
// BAM record stream scanner (block-generation span index).
//
// The reference's block generator issues one indexed BAM fetch per candidate
// variant (ref: src/block_gen.rs:630-669), which htslib makes cheap. The TPU
// build instead scans each BAM ONCE into compact per-record span arrays and
// answers the same queries (multispan, next-mapped, supplemental overlap)
// with vectorized host lookups. This function walks a decompressed BAM
// record stream (must begin at a record boundary) and emits one row per
// complete record; the caller carries the trailing partial record into the
// next call.
// ---------------------------------------------------------------------------

namespace {

// Reference-consumed length of a CIGAR op (ops M/D/N/=/X: codes 0,2,3,7,8).
inline bool cigar_consumes_ref(uint32_t op) {
  return op == 0 || op == 2 || op == 3 || op == 7 || op == 8;
}

}  // namespace

extern "C" {

// Scan complete BAM records from `raw` (length `len`).
//   name_blob/name_off/n_ref: reference-name table (for SA rname matching;
//     entry i = name_blob[name_off[i] .. name_off[i+1])).
//   tid/pos/end_/mapq/flag: per-record outputs, capacity `cap`.
//   sa_rec/sa_start/sa_end/sa_mapq: SA-tag intervals whose rname equals the
//     record's own reference name (the only case block generation queries,
//     ref: block_gen.rs:722-799). sa_rec is the record's index within THIS
//     call. sa_start stays 1-based exactly as the tag stores it (parity
//     with the reference's use). Capacity `sa_cap`; count in sa_count[0].
//   consumed[0]: bytes of `raw` consumed (offset of first incomplete rec).
// Returns the number of records emitted; -1 record capacity exceeded;
// -2 SA capacity exceeded; -3 malformed record/SA (caller falls back).
int64_t hn_bam_scan_records(
    const uint8_t* raw, int64_t len,
    const uint8_t* name_blob, const int64_t* name_off, int32_t n_ref,
    int32_t* tid, int32_t* pos, int32_t* end_, uint8_t* mapq, uint16_t* flag,
    int64_t* rec_off, int64_t* rec_size,
    int64_t cap,
    int64_t* sa_rec, int32_t* sa_start, int32_t* sa_end, int32_t* sa_mapq,
    int64_t sa_cap, int64_t* sa_count,
    int64_t* consumed) {
  int64_t off = 0;
  int64_t n = 0;
  int64_t n_sa = 0;
  while (off + 4 <= len) {
    uint32_t block_size;
    std::memcpy(&block_size, raw + off, 4);
    if (block_size < 32) return -3;
    if (off + 4 + block_size > len) break;  // partial record: stop here
    if (n >= cap) return -1;
    rec_off[n] = off + 4;  // record body (without the size prefix)
    rec_size[n] = block_size;
    const uint8_t* rec = raw + off + 4;
    int32_t refid, rpos;
    std::memcpy(&refid, rec, 4);
    std::memcpy(&rpos, rec + 4, 4);
    uint8_t l_read_name = rec[8];
    uint8_t rmapq = rec[9];
    uint16_t n_cigar, rflag;
    std::memcpy(&n_cigar, rec + 12, 2);
    std::memcpy(&rflag, rec + 14, 2);
    uint32_t l_seq;
    std::memcpy(&l_seq, rec + 16, 4);

    int64_t cigar_off = 32 + l_read_name;
    int64_t seq_off = cigar_off + 4LL * n_cigar;
    int64_t qual_off = seq_off + (l_seq + 1) / 2;
    int64_t aux_off = qual_off + l_seq;
    if (aux_off > block_size) return -3;

    int64_t ref_len = 0;
    for (int i = 0; i < n_cigar; ++i) {
      uint32_t v;
      std::memcpy(&v, rec + cigar_off + 4LL * i, 4);
      if (cigar_consumes_ref(v & 0xF)) ref_len += v >> 4;
    }
    tid[n] = refid;
    pos[n] = rpos;
    end_[n] = rpos + static_cast<int32_t>(ref_len);
    mapq[n] = rmapq;
    flag[n] = rflag;

    // aux walk: find SA:Z entries (rare) matching the record's own chrom
    const uint8_t* my_name = nullptr;
    int64_t my_name_len = 0;
    if (refid >= 0 && refid < n_ref) {
      my_name = name_blob + name_off[refid];
      my_name_len = name_off[refid + 1] - name_off[refid];
    }
    int64_t a = aux_off;
    while (a + 3 <= block_size) {
      char t0 = static_cast<char>(rec[a]);
      char t1 = static_cast<char>(rec[a + 1]);
      char tc = static_cast<char>(rec[a + 2]);
      int64_t vs = a + 3;
      int64_t ve;
      switch (tc) {
        case 'A': case 'c': case 'C': ve = vs + 1; break;
        case 's': case 'S': ve = vs + 2; break;
        case 'i': case 'I': case 'f': ve = vs + 4; break;
        case 'Z': case 'H': {
          ve = vs;
          while (ve < block_size && rec[ve] != 0) ++ve;
          if (ve >= block_size) return -3;
          ++ve;  // include NUL
          break;
        }
        case 'B': {
          if (vs + 5 > block_size) return -3;
          char sub = static_cast<char>(rec[vs]);
          uint32_t count;
          std::memcpy(&count, rec + vs + 1, 4);
          int w;
          switch (sub) {
            case 'c': case 'C': w = 1; break;
            case 's': case 'S': w = 2; break;
            case 'i': case 'I': case 'f': w = 4; break;
            default: return -3;
          }
          ve = vs + 5 + static_cast<int64_t>(w) * count;
          break;
        }
        default: return -3;
      }
      if (ve > block_size) return -3;
      if (t0 == 'S' && t1 == 'A' && tc == 'Z' && my_name != nullptr) {
        // parse "rname,pos,strand,cigar,mapQ,NM;..." entries
        int64_t p = vs;
        int64_t zend = ve - 1;  // NUL
        while (p < zend) {
          int64_t entry_end = p;
          while (entry_end < zend && rec[entry_end] != ';') ++entry_end;
          // field 0: rname
          int64_t f = p;
          while (f < entry_end && rec[f] != ',') ++f;
          bool chrom_match =
              (f - p == my_name_len) &&
              std::memcmp(rec + p, my_name, my_name_len) == 0;
          if (chrom_match) {
            if (f >= entry_end) return -3;
            int64_t q = f + 1;
            int64_t spos = 0;
            while (q < entry_end && rec[q] != ',') {
              uint8_t ch = rec[q];
              if (ch < '0' || ch > '9') return -3;
              spos = spos * 10 + (ch - '0');
              ++q;
            }
            if (q >= entry_end) return -3;
            ++q;  // skip strand field
            while (q < entry_end && rec[q] != ',') ++q;
            if (q >= entry_end) return -3;
            ++q;
            // cigar: accumulate reference-consumed ops (M/D/=/X advance,
            // S/I don't, anything else is malformed — parity with the
            // Python/block_gen parser)
            int64_t span = 0;
            int64_t num = 0;
            while (q < entry_end && rec[q] != ',') {
              uint8_t ch = rec[q];
              if (ch >= '0' && ch <= '9') {
                num = num * 10 + (ch - '0');
              } else {
                if (ch == 'M' || ch == 'D' || ch == '=' || ch == 'X') {
                  span += num;
                } else if (ch != 'S' && ch != 'I') {
                  return -3;
                }
                num = 0;
              }
              ++q;
            }
            if (q >= entry_end) return -3;
            ++q;
            int64_t smapq = 0;
            while (q < entry_end && rec[q] != ',') {
              uint8_t ch = rec[q];
              if (ch < '0' || ch > '9') return -3;
              smapq = smapq * 10 + (ch - '0');
              ++q;
            }
            if (n_sa >= sa_cap) return -2;
            sa_rec[n_sa] = n;
            sa_start[n_sa] = static_cast<int32_t>(spos);
            sa_end[n_sa] = static_cast<int32_t>(spos + span);
            sa_mapq[n_sa] = static_cast<int32_t>(smapq);
            ++n_sa;
          }
          p = entry_end + 1;
        }
      }
      a = ve;
    }
    ++n;
    off += 4 + block_size;
  }
  sa_count[0] = n_sa;
  consumed[0] = off;
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Whole-block local realignment (the per-read hot path of prepare).
//
// Replaces the Python record loop: BAM record parse, CIGAR -> coordinate
// map, 4-bit sequence decode, SV-deletion ratio windows + suppression
// (ref: src/read_parsing.rs:354-451), anchor-window allele matching with
// inline edit-distance resolution (ref: read_parsing.rs:196-353), and the
// per-type statistics accumulation — one C call per (block, BAM chunk).
// ---------------------------------------------------------------------------

namespace {

constexpr int kNumVariantTypes = 11;  // VariantType count (variants.rs:9-33)
constexpr int kSvDeletion = 5;

const uint8_t kSeqNt16[16] = {'=', 'A', 'C', 'M', 'G', 'R', 'S', 'V',
                              'T', 'W', 'Y', 'H', 'K', 'D', 'B', 'N'};

struct VarPack {
  int32_t n;
  const int64_t* pos;
  const int64_t* ref_len;
  const int64_t* prefix;
  const int64_t* postfix;
  const uint8_t* ignored;
  const int32_t* vtype;
  const uint8_t* blob;
  const int64_t* a0_off;
  const int64_t* a0_len;
  const int64_t* a1_off;
  const int64_t* a1_len;
  const int32_t* baseline;
};

// One variant's anchor-window match (identical to hn_window_alleles' body).
inline void window_allele_one(
    const int64_t* r2q, int64_t base, int64_t span,
    const uint8_t* seq, const uint8_t* quals,
    int64_t aligned_start, int64_t aligned_end,
    const VarPack& vp, int32_t vi,
    uint8_t* out_a, uint8_t* out_q, uint8_t* out_ex, uint8_t* out_ov) {
  auto lookup = [&](int64_t rc) -> int64_t {
    if (rc < base || rc >= base + span) return -1;
    return r2q[rc - base];
  };
  int64_t pos = vp.pos[vi];
  int64_t ref_len = vp.ref_len[vi];
  int64_t prefix_len = vp.prefix[vi];
  int64_t postfix_len = vp.postfix[vi];
  int64_t first_start = pos - prefix_len;
  int64_t last_start = pos + 1;
  int64_t first_end = pos + ref_len;
  int64_t last_end = first_end + postfix_len + 1;

  *out_a = 3; *out_q = 0; *out_ex = 0; *out_ov = 0;
  if (last_end <= base || first_start >= base + span) {
    // no anchor can exist; outcome depends only on the aligned range
    if (aligned_start <= pos && pos < aligned_end) { *out_a = 2; *out_ov = 1; }
    return;
  }

  int64_t closest_start = -1, closest_end = -1;
  for (int64_t sc = last_start - 1; sc >= first_start; --sc) {
    int64_t si = lookup(sc);
    if (si >= 0) { closest_start = si; break; }
  }
  for (int64_t ec = first_end; ec < last_end; ++ec) {
    int64_t ei = lookup(ec);
    if (ei >= 0) { closest_end = ei; break; }
  }

  int64_t start_coordinate = -1, end_coordinate = -1;
  int64_t start_clip = 0, end_clip = 0;
  if (closest_start >= 0 && closest_end >= 0) {
    for (int64_t sc = first_start; sc < last_start; ++sc) {
      ++start_clip;
      int64_t si = lookup(sc);
      if (si < 0) continue;
      if (closest_start - si > 2 * prefix_len) continue;
      start_coordinate = si;
      for (int64_t ec = last_end - 1; ec >= first_end; --ec) {
        ++end_clip;
        int64_t ei = lookup(ec);
        if (ei < 0) continue;
        if (ei - closest_end > 2 * postfix_len) continue;
        end_coordinate = ei;
        break;
      }
      break;
    }
  }

  if (start_coordinate >= 0 && end_coordinate >= 0) {
    int64_t ss = start_coordinate, se = end_coordinate;
    const uint8_t* obs = seq + ss;
    int64_t obs_len = se - ss;
    const uint8_t* a0 = vp.blob + vp.a0_off[vi];
    const uint8_t* a1 = vp.blob + vp.a1_off[vi];
    int64_t l0 = vp.a0_len[vi], l1 = vp.a1_len[vi];
    uint8_t allele;
    uint8_t exact = 0;
    if (obs_len == l0 && std::memcmp(obs, a0, l0) == 0) {
      allele = 0; exact = 1;
    } else if (obs_len == l1 && std::memcmp(obs, a1, l1) == 0) {
      allele = 1; exact = 1;
    } else {
      int64_t hc = start_clip - 1, tc = end_clip - 1;
      int32_t d0 = levenshtein(obs, obs_len, a0 + hc, l0 - hc - tc);
      int32_t d1 = levenshtein(obs, obs_len, a1 + hc, l1 - hc - tc);
      allele = d0 < d1 ? 0 : (d1 < d0 ? 1 : 2);
    }
    double qual_factor = 1.0;
    if (obs_len > 0) {
      double denom = 0.0;
      bool zero_q = false;
      for (int64_t k = 0; k < obs_len; ++k) {
        uint8_t q = quals[ss + k];
        if (q == 0) { zero_q = true; break; }
        denom += 1.0 / q;
      }
      double harmonic = zero_q ? 0.0 : obs_len / denom;
      qual_factor = std::min(harmonic / 40.0, 1.0);
    }
    double q = vp.baseline[vi] * qual_factor;
    *out_q = static_cast<uint8_t>(q < 1.0 ? 1.0 : q);
    *out_a = allele;
    *out_ex = exact;
    *out_ov = 1;
  } else if (aligned_start <= pos && pos < aligned_end) {
    *out_a = 2; *out_ov = 1;
  }
}

}  // namespace

extern "C" {

// Realign every record of a block chunk against its variant pack.
//   raw/rec_off/rec_size: record bodies (without the 4-byte size prefix)
//   out_alleles/out_quals: [n_recs, n_vars] row-major
//   out_noverlap: per record, count of set (<Ambiguous) overlap alleles
//   out_stats: int64[5*11 + 3]: failed/exact/inexact/allele0/allele1 by
//              VariantType, then num_alleles, skipped_reads, local_aligned
// Returns 0, or -1 on malformed record.
int64_t hn_realign_block(
    const uint8_t* raw, const int64_t* rec_off, const int64_t* rec_size,
    int64_t n_recs,
    int32_t n_vars, const int64_t* var_pos, const int64_t* var_ref_len,
    const int64_t* var_prefix, const int64_t* var_postfix,
    const uint8_t* var_ignored, const int32_t* var_vtype,
    const uint8_t* allele_blob, const int64_t* a0_off, const int64_t* a0_len,
    const int64_t* a1_off, const int64_t* a1_len,
    const int32_t* baseline_qual,
    int32_t sv_indel_qual, int threads,
    uint8_t* out_alleles, uint8_t* out_quals, int32_t* out_noverlap,
    int64_t* out_stats) {
  VarPack vp{n_vars, var_pos, var_ref_len, var_prefix, var_postfix,
             var_ignored, var_vtype, allele_blob, a0_off, a0_len,
             a1_off, a1_len, baseline_qual};
  constexpr int kS = 5 * kNumVariantTypes + 3;
  int n_workers = std::max(1, std::min<int>(threads, 8));
  std::vector<std::vector<int64_t>> tl_stats(
      n_workers, std::vector<int64_t>(kS, 0));
  std::atomic<int64_t> bad(0);

  auto work = [&](int w) {
    int64_t lo = n_recs * w / n_workers;
    int64_t hi = n_recs * (w + 1) / n_workers;
    int64_t* st = tl_stats[w].data();
    std::vector<int64_t> r2q;
    std::vector<uint8_t> seq;
    for (int64_t r = lo; r < hi; ++r) {
      const uint8_t* rec = raw + rec_off[r];
      int64_t rlen = rec_size[r];
      if (rlen < 32) { bad.store(1); return; }
      int32_t rpos32;
      std::memcpy(&rpos32, rec + 4, 4);
      int64_t base = rpos32;
      uint8_t l_read_name = rec[8];
      uint16_t n_cigar;
      std::memcpy(&n_cigar, rec + 12, 2);
      uint32_t l_seq;
      std::memcpy(&l_seq, rec + 16, 4);
      int64_t cigar_off = 32 + l_read_name;
      int64_t seq_off = cigar_off + 4LL * n_cigar;
      int64_t qual_off = seq_off + (l_seq + 1) / 2;
      if (qual_off + l_seq > rlen) { bad.store(1); return; }

      // CIGAR walk: reference span + ref->read coordinate map
      int64_t span = 0;
      for (int i = 0; i < n_cigar; ++i) {
        uint32_t v;
        std::memcpy(&v, rec + cigar_off + 4LL * i, 4);
        if (cigar_consumes_ref(v & 0xF)) span += v >> 4;
      }
      if (span < 1) span = 1;
      r2q.assign(span, -1);
      int64_t qpos = 0, rposn = 0, last_mapped = -1;
      for (int i = 0; i < n_cigar; ++i) {
        uint32_t v;
        std::memcpy(&v, rec + cigar_off + 4LL * i, 4);
        uint32_t op = v & 0xF;
        int64_t len = v >> 4;
        if (op == 0 || op == 7 || op == 8) {        // M/=/X
          for (int64_t k = 0; k < len; ++k) r2q[rposn + k] = qpos + k;
          qpos += len;
          rposn += len;
          last_mapped = rposn - 1;
        } else if (op == 1 || op == 4) {            // I/S
          qpos += len;
        } else if (op == 2 || op == 3) {            // D/N
          rposn += len;
        }
      }
      int64_t aligned_start = base;
      int64_t aligned_end = last_mapped >= 0 ? base + last_mapped + 1
                                             : base + 1;

      // 4-bit sequence decode
      seq.resize(l_seq);
      const uint8_t* packed = rec + seq_off;
      for (uint32_t k = 0; k < l_seq; ++k)
        seq[k] = kSeqNt16[(packed[k / 2] >> ((k & 1) ? 0 : 4)) & 0xF];
      const uint8_t* quals = rec + qual_off;

      uint8_t* oa = out_alleles + r * n_vars;
      uint8_t* oq = out_quals + r * n_vars;
      std::vector<uint8_t> oex(n_vars, 0), oov(n_vars, 0), skip(n_vars, 0);
      std::memset(oa, 3, n_vars);
      std::memset(oq, 0, n_vars);

      // sequential pass: ignored variants, SV deletions (they set the
      // suppression window), suppressed variants (ref: read_parsing.rs:
      // 180-194, 354-451). Only variants inside the aligned span apply.
      int64_t lo_v = std::lower_bound(var_pos, var_pos + n_vars, base)
          - var_pos;
      int64_t hi_v = std::lower_bound(var_pos, var_pos + n_vars, aligned_end)
          - var_pos;
      int64_t last_deletion_end = 0;
      for (int64_t vi = 0; vi < n_vars; ++vi)
        if (var_ignored[vi] || var_vtype[vi] == kSvDeletion) skip[vi] = 1;
      for (int64_t vi = lo_v; vi < hi_v; ++vi) {
        if (var_ignored[vi]) continue;
        int64_t pos = var_pos[vi];
        if (pos < last_deletion_end) {
          oa[vi] = 2; oov[vi] = 1; skip[vi] = 1;
          continue;
        }
        if (var_vtype[vi] != kSvDeletion) continue;
        // SV deletion: deleted-base ratio between anchors
        int64_t ref_len = var_ref_len[vi];
        int64_t last_start = pos + 1;
        int64_t first_end = pos + ref_len;
        if (!(aligned_start <= first_end && first_end < aligned_end)) {
          oa[vi] = 2; oov[vi] = 1;  // partial overlap, far end unreached
          continue;
        }
        int64_t expected_deleted = first_end - last_start;
        auto contains = [&](int64_t rc) {
          return rc >= base && rc - base < span && r2q[rc - base] >= 0;
        };
        int64_t start_anchor = last_start;
        while (!contains(start_anchor)) {
          if (start_anchor <= aligned_start) break;
          --start_anchor;
        }
        int64_t end_anchor = first_end;
        while (!contains(end_anchor)) {
          ++end_anchor;
          if (end_anchor >= aligned_end) break;
        }
        int64_t klo = std::max<int64_t>(start_anchor - base, 0);
        int64_t khi = std::max<int64_t>(end_anchor - base, klo);
        khi = std::min<int64_t>(khi, span);
        int64_t deleted = 0;
        for (int64_t k = klo; k < khi; ++k) deleted += (r2q[k] < 0);
        double ratio = expected_deleted > 0
            ? static_cast<double>(deleted) / expected_deleted : 0.0;
        if (ratio < 0.33) {
          double q = sv_indel_qual * (1.0 - ratio);
          oa[vi] = 0; oq[vi] = static_cast<uint8_t>(q < 1.0 ? 1.0 : q);
          oex[vi] = ratio == 0.0; oov[vi] = 1;
        } else if (ratio > 0.67 && ratio < 1.33) {
          double qf = 1.0 - (ratio > 1.0 ? ratio - 1.0 : 1.0 - ratio);
          double q = sv_indel_qual * qf;
          oa[vi] = 1; oq[vi] = static_cast<uint8_t>(q < 1.0 ? 1.0 : q);
          oex[vi] = ratio == 1.0; oov[vi] = 1;
          last_deletion_end = first_end;
        } else {
          oa[vi] = 2; oov[vi] = 1;
        }
      }

      for (int32_t vi = 0; vi < n_vars; ++vi) {
        if (skip[vi]) continue;
        window_allele_one(r2q.data(), base, span, seq.data(), quals,
                          aligned_start, aligned_end, vp, vi,
                          &oa[vi], &oq[vi], &oex[vi], &oov[vi]);
      }

      // stats (ref: read_parsing.rs:129-133, :459-486)
      int64_t n_overlap_set = 0;
      for (int32_t vi = 0; vi < n_vars; ++vi) {
        if (!oov[vi]) continue;
        int vt = var_vtype[vi];
        if (oa[vi] == 2) {
          st[0 * kNumVariantTypes + vt] += 1;  // failed
        } else if (oa[vi] < 2) {
          st[(oex[vi] ? 1 : 2) * kNumVariantTypes + vt] += 1;
          st[(oa[vi] == 0 ? 3 : 4) * kNumVariantTypes + vt] += 1;
          ++n_overlap_set;
        }
      }
      out_noverlap[r] = static_cast<int32_t>(n_overlap_set);
      st[5 * kNumVariantTypes + 0] += n_overlap_set;        // num_alleles
      st[5 * kNumVariantTypes + 1] += (n_overlap_set == 0); // skipped_reads
      st[5 * kNumVariantTypes + 2] += (n_overlap_set != 0); // local_aligned
    }
  };

  if (n_workers <= 1 || n_recs < 16) {
    work(0);
    for (int w = 1; w < n_workers; ++w) work(w);
  } else {
    std::vector<std::thread> pool;
    for (int w = 0; w < n_workers; ++w) pool.emplace_back(work, w);
    for (auto& th : pool) th.join();
  }
  if (bad.load()) return -1;
  for (int w = 0; w < n_workers; ++w)
    for (int k = 0; k < kS; ++k) out_stats[k] += tl_stats[w][k];
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched global realignment (graph-WFA) over a block's records.
//
// The reference builds one WFA graph per read over the read's het+hom
// overlap window and aligns the read's aligned subsequence
// (ref: src/read_parsing.rs:652-867, wfa_graph.rs:119-650). This driver
// moves the whole per-read loop into C with internal threading: record
// parse, coordinate map, window search, graph build, wavefront alignment,
// and traversed-node -> allele merging. The deterministic failure ladder
// stays host-side: scores come back per record in file order and the host
// applies the fallback decisions in encounter order (CHANGELOG.md:33-46).
// ---------------------------------------------------------------------------

extern "C" {

// Per-record out_score: >=0 edit distance (global success), -1 max-ED
// exceeded (host falls back to local), -2 no het overlap (read skipped),
// -3 scratch capacity exceeded (host uses its per-read path).
// out_alleles: [n_recs, n_hets] u8 — 0/1 assignment, 2 conflict, 3 none.
// Returns 0, or -1 on malformed record.
int64_t hn_wfa_batch(
    const uint8_t* raw, const int64_t* rec_off, const int64_t* rec_size,
    int64_t n_recs,
    const uint8_t* chrom_seq, int64_t chrom_len,
    const int64_t* het_pos, int64_t n_hets,
    int32_t n_pack, const int64_t* pk_pos, const int64_t* pk_ref_len,
    const int32_t* pk_var_index, const uint8_t* pk_a0_is_alt,
    const uint8_t* pk_blob, const int64_t* pk_a0_off, const int64_t* pk_a0_len,
    const int64_t* pk_a1_off, const int64_t* pk_a1_len,
    int64_t prune_distance, int64_t max_edit_distance, int threads,
    int64_t* out_scores, uint8_t* out_alleles) {
  std::atomic<int64_t> bad(0);
  int n_workers = std::max(1, std::min<int>(threads, 8));

  int64_t blob_total = 0;
  for (int32_t i = 0; i < n_pack; ++i)
    blob_total += pk_a0_len[i] + pk_a1_len[i];

  auto work = [&](int w) {
    int64_t lo = n_recs * w / n_workers;
    int64_t hi = n_recs * (w + 1) / n_workers;
    std::vector<int64_t> r2q;
    for (int64_t r = lo; r < hi; ++r) {
      const uint8_t* rec = raw + rec_off[r];
      int64_t rlen = rec_size[r];
      if (rlen < 32) { bad.store(1); return; }
      int32_t rpos32;
      std::memcpy(&rpos32, rec + 4, 4);
      int64_t base = rpos32;
      uint8_t l_read_name = rec[8];
      uint16_t n_cigar;
      std::memcpy(&n_cigar, rec + 12, 2);
      uint32_t l_seq;
      std::memcpy(&l_seq, rec + 16, 4);
      int64_t cigar_off = 32 + l_read_name;
      int64_t seq_off = cigar_off + 4LL * n_cigar;
      int64_t qual_off = seq_off + (l_seq + 1) / 2;
      if (qual_off + l_seq > rlen) { bad.store(1); return; }

      int64_t span = 0;
      for (int i = 0; i < n_cigar; ++i) {
        uint32_t v;
        std::memcpy(&v, rec + cigar_off + 4LL * i, 4);
        if (cigar_consumes_ref(v & 0xF)) span += v >> 4;
      }
      if (span < 1) span = 1;
      r2q.assign(span, -1);
      int64_t qpos = 0, rposn = 0;
      int64_t first_mapped = -1, last_mapped = -1;
      for (int i = 0; i < n_cigar; ++i) {
        uint32_t v;
        std::memcpy(&v, rec + cigar_off + 4LL * i, 4);
        uint32_t op = v & 0xF;
        int64_t len = v >> 4;
        if (op == 0 || op == 7 || op == 8) {
          for (int64_t k = 0; k < len; ++k) r2q[rposn + k] = qpos + k;
          if (first_mapped < 0) first_mapped = rposn;
          last_mapped = rposn + len - 1;
          qpos += len;
          rposn += len;
        } else if (op == 1 || op == 4) {
          qpos += len;
        } else if (op == 2 || op == 3) {
          rposn += len;
        }
      }
      uint8_t* oa = out_alleles + r * n_hets;
      std::memset(oa, 3, n_hets);
      if (first_mapped < 0) { out_scores[r] = -2; continue; }
      int64_t min_position = base + first_mapped;
      int64_t max_position = base + last_mapped;

      // het overlap window (ref: read_parsing.rs:688-712)
      const int64_t* he = het_pos + n_hets;
      int64_t n_ov = std::upper_bound(het_pos, he, max_position)
          - std::lower_bound(het_pos, he, min_position);
      if (n_ov <= 0) { out_scores[r] = -2; continue; }

      // aligned read subsequence
      int64_t read_start = r2q[min_position - base];
      int64_t read_end = r2q[max_position - base];
      std::vector<uint8_t> read_align(read_end + 1 - read_start);
      const uint8_t* packed = rec + seq_off;
      for (int64_t k = read_start; k <= read_end; ++k)
        read_align[k - read_start] =
            kSeqNt16[(packed[k / 2] >> ((k & 1) ? 0 : 4)) & 0xF];

      int64_t ref_start = min_position;
      int64_t ref_end = std::min(max_position + 1, chrom_len);
      int64_t window = ref_end - ref_start;

      // scratch for the graph build (same capacity model as the host)
      int64_t node_cap = 3LL * n_pack + 4;
      int64_t blob_cap = window + blob_total + 16;
      int64_t edge_cap = 8LL * n_pack + 16;
      int64_t alle_cap = 2LL * n_pack + 2;
      std::vector<int64_t> node_off(node_cap + 1);
      std::vector<uint8_t> node_blob(blob_cap);
      std::vector<int64_t> edge_off(std::max<int64_t>(node_cap + 1, edge_cap));
      std::vector<int32_t> edge_dst(edge_cap);
      std::vector<int32_t> alle_node(alle_cap), alle_var(alle_cap);
      std::vector<uint8_t> alle_val(alle_cap);
      int64_t n_alleles = 0;
      int64_t n_nodes = hn_wfa_build(
          chrom_seq, ref_start, ref_end, n_pack, pk_pos, pk_ref_len,
          pk_var_index, pk_a0_is_alt, pk_blob, pk_a0_off, pk_a0_len,
          pk_a1_off, pk_a1_len,
          node_off.data(), node_blob.data(), node_cap, blob_cap,
          edge_off.data(), edge_dst.data(), edge_cap,
          alle_node.data(), alle_var.data(), alle_val.data(), alle_cap,
          &n_alleles);
      if (n_nodes < 0) { out_scores[r] = -3; continue; }

      std::vector<uint8_t> traversed(n_nodes, 0);
      int64_t score = hn_wfa_align(
          node_blob.data(), node_off.data(), static_cast<int32_t>(n_nodes),
          edge_dst.data(), edge_off.data(), read_align.data(),
          static_cast<int64_t>(read_align.size()), prune_distance,
          max_edit_distance, traversed.data());
      if (score == -2) { out_scores[r] = -3; continue; }
      if (score < 0) { out_scores[r] = -1; continue; }
      out_scores[r] = score;
      for (int64_t k = 0; k < n_alleles; ++k) {
        if (!traversed[alle_node[k]]) continue;
        int32_t vi = alle_var[k];
        if (vi < 0) continue;  // hom branch
        uint8_t val = alle_val[k];
        if (oa[vi] == 3) oa[vi] = val;
        else if (oa[vi] != val) oa[vi] = 2;
      }
    }
  };

  if (n_workers <= 1 || n_recs < 4) {
    for (int w = 0; w < n_workers; ++w) work(w);
  } else {
    std::vector<std::thread> pool;
    for (int w = 0; w < n_workers; ++w) pool.emplace_back(work, w);
    for (auto& th : pool) th.join();
  }
  return bad.load() ? -1 : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Lockstep beam diplotype solver — the native host production engine.
//
// Exact host mirror of the device kernel in hiphase_tpu/phasing/beam.py
// (itself a TPU-first redesign of the reference A*, ref: src/astar_phaser.rs):
// a fixed-width beam advances over variant columns; candidates are ranked by
// (MEC cost asc, num_hets desc, insertion order asc) — the reference's
// priority triple (astar_phaser.rs:131-133) — with expansion order
// 0|1, 1|0, 0/0, 1/1 and the 1|0 twin suppressed while a node's haplotypes
// are identical (astar_phaser.rs:535-560). Optimality accounting matches the
// device kernel: a step's cheapest discarded candidate is compared against
// the final cost, so pruned == 0 still proves optimality
// (ref contract: docs/user_guide.md:310).
//
// Differences from the device kernel are representational only: reads are
// interval-packed into reusable slots (same as beam.py's slotted mode) but
// per-column *active lists* replace dense [R] rows, and a slot folds its
// min(c1,c2) into the frozen cost when its read ends (beam.py folds at the
// next occupant's start — cost-equivalent, both fold while the slot is idle).

namespace beam_native {

struct BlockIn {
  int32_t nv;
  const uint8_t* skip;        // [nv] ignored flags
  int32_t n_reads;
  const int32_t* seg_start;   // [n_reads] first variant index
  const int64_t* seg_off;     // [n_reads+1] offsets into allele/qual blobs
  const uint8_t* alleles;     // blob base
  const uint8_t* quals;       // blob base
};

struct SolveOut {
  int32_t cost = 0;
  int32_t hets = 0;
  int32_t pruned = 0;
  int64_t expansions = 0;     // candidate nodes generated (A* analog)
};

// Greedy interval slot allocation (beam.py assign_slots): reads ordered by
// (start, end) reuse the slot whose previous occupant ended earliest.
static int32_t assign_slots(const BlockIn& in, std::vector<int32_t>* order,
                            std::vector<int32_t>* slot_of) {
  int32_t n = in.n_reads;
  order->resize(n);
  for (int32_t i = 0; i < n; ++i) (*order)[i] = i;
  auto end_of = [&](int32_t i) {
    return in.seg_start[i] +
           static_cast<int32_t>(in.seg_off[i + 1] - in.seg_off[i]);
  };
  std::sort(order->begin(), order->end(), [&](int32_t a, int32_t b) {
    if (in.seg_start[a] != in.seg_start[b])
      return in.seg_start[a] < in.seg_start[b];
    if (end_of(a) != end_of(b)) return end_of(a) < end_of(b);
    return a < b;
  });
  slot_of->assign(n, 0);
  using HeapEntry = std::pair<int32_t, int32_t>;  // (end, slot)
  std::priority_queue<HeapEntry, std::vector<HeapEntry>,
                      std::greater<HeapEntry>> free_slots;
  int32_t next_slot = 0;
  for (int32_t i : *order) {
    int32_t s;
    if (!free_slots.empty() && free_slots.top().first <= in.seg_start[i]) {
      s = free_slots.top().second;
      free_slots.pop();
    } else {
      s = next_slot++;
    }
    (*slot_of)[i] = s;
    free_slots.emplace(end_of(i), s);
  }
  return std::max(next_slot, 1);
}

// One active (slot, column) entry: dA/dB are the flip costs against
// haplotype allele 0 / allele 1 at this column.
struct Active {
  int32_t slot;
  int32_t dA;
  int32_t dB;
};

// Solve one block at a single beam width. Returns false when nv is too
// large for the packed 64-bit ranking key at this width (caller falls back).
//
// State layout is [slot][beam] (transposed): per-slot rows are contiguous
// over the beam axis, so the fold, candidate-delta, and survivor-gather
// loops all vectorize; only slots with a live read are touched.
static bool solve_one(const BlockIn& in, int32_t W, uint8_t* h1, uint8_t* h2,
                      SolveOut* out) {
  const int32_t nv = in.nv;
  if (nv == 0) {
    *out = SolveOut();
    return true;
  }
  int shift = 2;
  while ((1 << shift) < 4 * W) ++shift;  // order_bits_for(W)
  if (W > 32767) return false;           // parents stored as int16
  if ((static_cast<uint64_t>(nv) << shift) >= (1ull << 32)) return false;

  std::vector<int32_t> order, slot_of;
  const int32_t S = assign_slots(in, &order, &slot_of);

  // Per-column active lists (CSC layout), fold events, and start events
  // (slot liveness: a slot is live between its first occupant's start and
  // its last fold; dead rows are all-zero and skipped).
  std::vector<int32_t> col_cnt(nv + 1, 0);
  std::vector<int32_t> fold_cnt(nv + 1, 0);
  std::vector<int32_t> start_cnt(nv + 1, 0);
  for (int32_t i = 0; i < in.n_reads; ++i) {
    int32_t st = in.seg_start[i];
    int64_t o0 = in.seg_off[i], o1 = in.seg_off[i + 1];
    for (int64_t o = o0; o < o1; ++o) {
      if (in.alleles[o] < 2 && in.quals[o] > 0)
        ++col_cnt[st + static_cast<int32_t>(o - o0)];
    }
    int32_t end = st + static_cast<int32_t>(o1 - o0);
    if (end < nv) ++fold_cnt[end];
    ++start_cnt[st];
  }
  std::vector<int32_t> col_off(nv + 1, 0), fold_off(nv + 1, 0),
      start_off(nv + 1, 0);
  for (int32_t j = 0; j < nv; ++j) {
    col_off[j + 1] = col_off[j] + col_cnt[j];
    fold_off[j + 1] = fold_off[j] + fold_cnt[j];
    start_off[j + 1] = start_off[j] + start_cnt[j];
  }
  std::vector<Active> active(col_off[nv]);
  std::vector<int32_t> folds(fold_off[nv]);
  std::vector<int32_t> starts(start_off[nv]);
  {
    std::vector<int32_t> cfill(col_off.begin(), col_off.end() - 1);
    std::vector<int32_t> ffill(fold_off.begin(), fold_off.end() - 1);
    std::vector<int32_t> sfill(start_off.begin(), start_off.end() - 1);
    for (int32_t i = 0; i < in.n_reads; ++i) {
      int32_t st = in.seg_start[i];
      int32_t s = slot_of[i];
      int64_t o0 = in.seg_off[i], o1 = in.seg_off[i + 1];
      for (int64_t o = o0; o < o1; ++o) {
        uint8_t a = in.alleles[o];
        int32_t q = in.quals[o];
        if (a < 2 && q > 0) {
          int32_t j = st + static_cast<int32_t>(o - o0);
          active[cfill[j]++] = {s, a != 0 ? q : 0, a != 1 ? q : 0};
        }
      }
      int32_t end = st + static_cast<int32_t>(o1 - o0);
      if (end < nv) folds[ffill[end]++] = s;
      starts[sfill[st]++] = s;
    }
  }

  // Beam state, [slot][beam] transposed, double-buffered.
  std::vector<int32_t> c1(static_cast<size_t>(S) * W, 0);
  std::vector<int32_t> c2(static_cast<size_t>(S) * W, 0);
  std::vector<int32_t> c1n(static_cast<size_t>(S) * W);
  std::vector<int32_t> c2n(static_cast<size_t>(S) * W);
  std::vector<int32_t> frozen(W, 0), fluid(W, 0), cost(W, 0), hets(W, 0);
  std::vector<int32_t> frozen_n(W), fluid_n(W), cost_n(W), hets_n(W);
  std::vector<uint8_t> ident(W, 1), ident_n(W);
  int32_t n_beam = 1;

  std::vector<uint8_t> slot_live(S, 0);
  std::vector<int32_t> live;  // live slot list (unordered)
  live.reserve(S);
  std::vector<uint8_t> slot_active(S, 0);
  std::vector<int32_t> slot_dA(S, 0), slot_dB(S, 0);

  std::vector<int16_t> parents(static_cast<size_t>(nv) * W);
  std::vector<uint8_t> choices(static_cast<size_t>(nv) * W);
  std::vector<int32_t> prune_cnt(nv, 0), prune_min(nv, 0);

  std::vector<uint64_t> keys(static_cast<size_t>(W) * 4);
  std::vector<int32_t> d0(W), d1(W), d2(W), d3(W);
  std::vector<int16_t> sel_par(W);
  std::vector<uint8_t> sel_cho(W);

  for (int32_t j = 0; j < nv; ++j) {
    int16_t* par_j = parents.data() + static_cast<size_t>(j) * W;
    uint8_t* cho_j = choices.data() + static_cast<size_t>(j) * W;
    // slots whose occupant starts here become live; a dead->live row may
    // hold stale values from a previous occupancy epoch (the fold only
    // zeroed the then-current buffer), so clear it on revival. Handoff
    // slots (fold and start at the same column) stay live and keep their
    // data for the fold below.
    for (int32_t si = start_off[j]; si < start_off[j + 1]; ++si) {
      int32_t s = starts[si];
      if (!slot_live[s]) {
        slot_live[s] = 1;
        live.push_back(s);
        std::memset(&c1[static_cast<size_t>(s) * W], 0, sizeof(int32_t) * W);
        std::memset(&c2[static_cast<size_t>(s) * W], 0, sizeof(int32_t) * W);
      }
    }
    // fold finished reads' slots into the frozen cost (vector ops per row)
    for (int32_t fi = fold_off[j]; fi < fold_off[j + 1]; ++fi) {
      int32_t s = folds[fi];
      int32_t* r1 = &c1[static_cast<size_t>(s) * W];
      int32_t* r2 = &c2[static_cast<size_t>(s) * W];
      for (int32_t w = 0; w < n_beam; ++w) {
        int32_t m = std::min(r1[w], r2[w]);
        frozen[w] += m;
        fluid[w] -= m;
      }
      std::memset(r1, 0, sizeof(int32_t) * n_beam);
      std::memset(r2, 0, sizeof(int32_t) * n_beam);
      // remove from live unless another occupant starts at this column
      slot_live[s] = 0;
    }
    if (fold_off[j] != fold_off[j + 1]) {
      // re-add slots whose next occupant starts exactly here
      for (int32_t si = start_off[j]; si < start_off[j + 1]; ++si)
        slot_live[starts[si]] = 1;
      live.erase(std::remove_if(live.begin(), live.end(),
                                [&](int32_t s) { return !slot_live[s]; }),
                 live.end());
    }

    if (in.skip[j]) {
      for (int32_t w = 0; w < n_beam; ++w) {
        par_j[w] = static_cast<int16_t>(w);
        cho_j[w] = 0;
      }
      out->expansions += n_beam;
      continue;
    }

    // candidate deltas, accumulated per active slot over the beam axis
    std::memset(d0.data(), 0, sizeof(int32_t) * n_beam);
    std::memset(d1.data(), 0, sizeof(int32_t) * n_beam);
    std::memset(d2.data(), 0, sizeof(int32_t) * n_beam);
    std::memset(d3.data(), 0, sizeof(int32_t) * n_beam);
    {
      int32_t* __restrict p0 = d0.data();
      int32_t* __restrict p1 = d1.data();
      int32_t* __restrict p2 = d2.data();
      int32_t* __restrict p3 = d3.data();
      for (int32_t ai = col_off[j]; ai < col_off[j + 1]; ++ai) {
        const Active& a = active[ai];
        const int32_t* __restrict r1 = &c1[static_cast<size_t>(a.slot) * W];
        const int32_t* __restrict r2 = &c2[static_cast<size_t>(a.slot) * W];
        const int32_t dA = a.dA, dB = a.dB;
        for (int32_t w = 0; w < n_beam; ++w) {
          int32_t x1 = r1[w], x2 = r2[w];
          int32_t m = std::min(x1, x2);
          p0[w] += std::min(x1 + dA, x2 + dB) - m;
          p1[w] += std::min(x1 + dB, x2 + dA) - m;
          p2[w] += std::min(x1 + dA, x2 + dA) - m;
          p3[w] += std::min(x1 + dB, x2 + dB) - m;
        }
      }
    }

    int32_t n_cand = 0;
    for (int32_t w = 0; w < n_beam; ++w) {
      int32_t base = frozen[w] + fluid[w];
      uint64_t hetp1 = static_cast<uint64_t>(nv - (hets[w] + 1)) << shift;
      uint64_t het0 = static_cast<uint64_t>(nv - hets[w]) << shift;
      uint64_t ord = static_cast<uint64_t>(w) * 4;
      keys[n_cand++] =
          (static_cast<uint64_t>(base + d0[w]) << 32) | hetp1 | (ord + 0);
      if (!ident[w])
        keys[n_cand++] =
            (static_cast<uint64_t>(base + d1[w]) << 32) | hetp1 | (ord + 1);
      keys[n_cand++] =
          (static_cast<uint64_t>(base + d2[w]) << 32) | het0 | (ord + 2);
      keys[n_cand++] =
          (static_cast<uint64_t>(base + d3[w]) << 32) | het0 | (ord + 3);
    }
    out->expansions += n_cand;

    int32_t n_keep = std::min(n_cand, W);
    if (n_cand > W) {
      std::nth_element(keys.begin(), keys.begin() + W, keys.begin() + n_cand);
      prune_cnt[j] = n_cand - W;
      prune_min[j] = static_cast<int32_t>(keys[W] >> 32);
    }
    std::sort(keys.begin(), keys.begin() + n_keep);

    const uint64_t ord_mask = (1ull << shift) - 1;
    for (int32_t i = 0; i < n_keep; ++i) {
      uint64_t k = keys[i];
      int32_t flat = static_cast<int32_t>(k & ord_mask);
      int32_t p = flat >> 2, c = flat & 3;
      par_j[i] = static_cast<int16_t>(p);
      cho_j[i] = static_cast<uint8_t>(c);
      sel_par[i] = static_cast<int16_t>(p);
      sel_cho[i] = static_cast<uint8_t>(c);
      int32_t new_cost = static_cast<int32_t>(k >> 32);
      cost_n[i] = new_cost;
      frozen_n[i] = frozen[p];
      fluid_n[i] = new_cost - frozen[p];
      hets_n[i] = hets[p] + (c < 2 ? 1 : 0);
      ident_n[i] = ident[p] & (c >> 1);
    }
    // survivor gather per live slot row (contiguous writes)
    for (int32_t s : live) slot_active[s] = 0;
    for (int32_t ai = col_off[j]; ai < col_off[j + 1]; ++ai) {
      const Active& a = active[ai];
      slot_active[a.slot] = 1;
      slot_dA[a.slot] = a.dA;
      slot_dB[a.slot] = a.dB;
    }
    for (int32_t s : live) {
      const int32_t* src1 = &c1[static_cast<size_t>(s) * W];
      const int32_t* src2 = &c2[static_cast<size_t>(s) * W];
      int32_t* dst1 = &c1n[static_cast<size_t>(s) * W];
      int32_t* dst2 = &c2n[static_cast<size_t>(s) * W];
      if (slot_active[s]) {
        const int32_t dA = slot_dA[s], dB = slot_dB[s];
        for (int32_t i = 0; i < n_keep; ++i) {
          int32_t p = sel_par[i];
          int32_t c = sel_cho[i];
          // haplotype-1 delta: a1(c) = c&1 -> dA when a1==0 else dB
          // haplotype-2 delta: a2(c)=1-((c&1)^(c>>1)) -> dA when a2==0
          dst1[i] = src1[p] + ((c & 1) ? dB : dA);
          dst2[i] = src2[p] + (((c == 0) | (c == 3)) ? dB : dA);
        }
      } else {
        for (int32_t i = 0; i < n_keep; ++i) {
          int32_t p = sel_par[i];
          dst1[i] = src1[p];
          dst2[i] = src2[p];
        }
      }
      // grown beam: clear the remainder so a later fold of this slot only
      // sees valid entries (entries >= n_keep are never read as parents,
      // but fold sums over n_beam of the NEXT step = n_keep)
    }
    n_beam = n_keep;
    c1.swap(c1n);
    c2.swap(c2n);
    frozen.swap(frozen_n);
    fluid.swap(fluid_n);
    cost.swap(cost_n);
    hets.swap(hets_n);
    ident.swap(ident_n);
  }

  out->cost = frozen[0] + fluid[0];
  out->hets = hets[0];
  out->pruned = 0;
  for (int32_t j = 0; j < nv; ++j) {
    if (prune_cnt[j] > 0 && prune_min[j] <= out->cost)
      out->pruned += prune_cnt[j];
  }
  int32_t slot = 0;
  for (int32_t j = nv - 1; j >= 0; --j) {
    uint8_t c = choices[static_cast<size_t>(j) * W + slot];
    if (in.skip[j]) {
      h1[j] = 2;
      h2[j] = 2;
    } else {
      h1[j] = c & 1;
      h2[j] = 1 - ((c & 1) ^ (c >> 1));
    }
    slot = parents[static_cast<size_t>(j) * W + slot];
  }
  return true;
}

}  // namespace beam_native

extern "C" {

// Solve a batch of phase blocks with the native lockstep beam.
//
// Per-block inputs are concatenated; all offsets are element offsets.
//   nv:         [n_blocks] variant counts
//   skip_off:   [n_blocks+1] offsets into skip/h1/h2 (= cumulative nv)
//   skip:       ignored-variant flags, length skip_off[n_blocks]
//   read_off:   [n_blocks+1] offsets into seg_start (per-block read ranges)
//   seg_start:  [total_reads] first variant index of each read segment
//   seg_off:    [total_reads+1] offsets into alleles/quals
//   alleles:    concatenated segment alleles (0/1 set, 2 ambiguous)
//   quals:      concatenated segment quals (flip costs; 0 = no contribution)
//   fast_width / full_width: escalation schedule — every block solves at
//     fast_width; a block whose result is not provably optimal (pruned > 0)
//     re-solves at full_width (the reference's queue-size budget,
//     ref: cli.rs:214-226)
//   threads:    host worker threads across blocks
// Outputs (caller-allocated):
//   h1/h2:      haplotype alleles, skip_off layout (2 where skipped)
//   cost/hets/pruned: [n_blocks] (pruned from the final width used)
//   expansions: [n_blocks] candidate nodes generated (across both widths)
// Returns 0, or -1 if any block exceeds the ranking-key capacity (callers
// gate such blocks to the host oracle beforehand; nothing is written then).
int32_t hn_beam_solve_batch(
    int32_t n_blocks, const int32_t* nv, const int64_t* skip_off,
    const uint8_t* skip, const int64_t* read_off, const int32_t* seg_start,
    const int64_t* seg_off, const uint8_t* alleles, const uint8_t* quals,
    int32_t fast_width, int32_t full_width, int32_t threads, uint8_t* h1,
    uint8_t* h2, int32_t* cost, int32_t* hets, int32_t* pruned,
    int64_t* expansions) {
  std::atomic<int32_t> failed(0);
  parallel_for(n_blocks, threads, [&](int64_t b) {
    beam_native::BlockIn in;
    in.nv = nv[b];
    in.skip = skip + skip_off[b];
    in.n_reads = static_cast<int32_t>(read_off[b + 1] - read_off[b]);
    in.seg_start = seg_start + read_off[b];
    in.seg_off = seg_off + read_off[b];
    in.alleles = alleles;
    in.quals = quals;
    beam_native::SolveOut out;
    uint8_t* bh1 = h1 + skip_off[b];
    uint8_t* bh2 = h2 + skip_off[b];
    if (!beam_native::solve_one(in, fast_width, bh1, bh2, &out)) {
      failed.store(1);
      return;
    }
    // blocks whose fast-width result is not provably optimal re-solve at
    // the full queue-size width directly (measured: blocks that prune at
    // the fast width almost always still prune at intermediate widths, so
    // a ladder of rungs only adds work)
    if (out.pruned > 0 && full_width > fast_width) {
      beam_native::SolveOut next;
      next.expansions = out.expansions;
      if (!beam_native::solve_one(in, full_width, bh1, bh2, &next)) {
        failed.store(1);
        return;
      }
      out = next;
    }
    cost[b] = out.cost;
    hets[b] = out.hets;
    pruned[b] = out.pruned;
    expansions[b] = out.expansions;
  });
  return failed.load() ? -1 : 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Streaming whole-file BAM span scan.
//
// One pass over a coordinate-sorted BAM: threaded BGZF inflate chunk by
// chunk into a reused buffer, record walk inline (hn_bam_scan_records),
// MAPQ/flag filter applied in-scan. Replaces the Python slab loop in
// io/span_index.py, which materialized the whole decompressed file through
// numpy (hundreds of MB of allocation churn per run — the dominant setup
// cost at WGS scale). Ref: the htslib-backed per-locus fetches this index
// replaces live in src/block_gen.rs:630-799.

namespace span_scan {

struct Result {
  std::vector<int32_t> tid;
  std::vector<int64_t> pos, end;
  std::vector<int64_t> sa_row, sa_start, sa_end, sa_mapq;
};

}  // namespace span_scan

extern "C" {

// Scan `path` from BGZF virtual offset (coffset, skip_u); keep records with
// (flag & filter_mask) == 0, mapq >= min_mapq, tid >= 0. SA entries are
// remapped onto the filtered row numbering. Returns an opaque handle
// (free with hn_span_scan_free) or NULL on I/O or parse failure.
void* hn_span_scan_file(const char* path, int64_t coffset, int32_t skip_u,
                        const uint8_t* name_blob, const int64_t* name_off,
                        int32_t n_ref, int32_t min_mapq, int32_t filter_mask,
                        int32_t threads) {
  FILE* fh = std::fopen(path, "rb");
  if (fh == nullptr) return nullptr;
  if (std::fseek(fh, static_cast<long>(coffset), SEEK_SET) != 0) {
    std::fclose(fh);
    return nullptr;
  }
  auto res = new span_scan::Result();
  constexpr int64_t kChunk = 4 << 20;  // compressed bytes per read (small: the temp buffers scale with it and first-touch page faults are real)
  std::vector<uint8_t> comp(kChunk + (1 << 16));
  int64_t comp_carry = 0;
  std::vector<uint8_t> raw;       // carry + inflated chunk
  int64_t raw_carry = 0;
  std::vector<int64_t> boffs, ooffs;
  // per-chunk scan outputs (pre-filter)
  std::vector<int32_t> t_tid, t_pos, t_end, t_sastart, t_saend, t_samapq;
  std::vector<uint8_t> t_mapq;
  std::vector<uint16_t> t_flag;
  std::vector<int64_t> t_recoff, t_recsize, t_sarec;
  bool first = true;
  bool ok = true;
  for (;;) {
    size_t got = std::fread(comp.data() + comp_carry, 1, kChunk, fh);
    int64_t avail = comp_carry + static_cast<int64_t>(got);
    if (avail == 0) break;
    // trim to whole BGZF blocks
    int64_t end = 0;
    while (end + 18 <= avail) {
      uint16_t bs16;
      std::memcpy(&bs16, comp.data() + end + 16, 2);
      int64_t bsize = static_cast<int64_t>(bs16) + 1;
      if (end + bsize > avail) break;
      end += bsize;
    }
    if (end == 0) {
      if (got == 0) break;  // trailing garbage / EOF remnant
      ok = avail < 18;      // an unsplittable fragment mid-file is an error
      if (!ok) break;
      break;
    }
    // block offsets + output offsets (ISIZE footers)
    boffs.clear();
    ooffs.clear();
    int64_t raw_len = 0;
    for (int64_t o = 0; o < end;) {
      uint16_t bs16;
      std::memcpy(&bs16, comp.data() + o + 16, 2);
      int64_t bsize = static_cast<int64_t>(bs16) + 1;
      uint32_t isize;
      std::memcpy(&isize, comp.data() + o + bsize - 4, 4);
      boffs.push_back(o);
      ooffs.push_back(raw_len);
      raw_len += isize;
      o += bsize;
    }
    boffs.push_back(end);
    ooffs.push_back(raw_len);
    int n_blocks = static_cast<int>(boffs.size()) - 1;
    raw.resize(raw_carry + raw_len);
    if (hn_bgzf_decompress_many(comp.data(), boffs.data(), n_blocks,
                                raw.data() + raw_carry, ooffs.data(),
                                threads) != 0) {
      ok = false;
      break;
    }
    int64_t scan_from = 0;
    if (first) {
      scan_from = skip_u;  // virtual-offset remainder inside first block
      first = false;
    }
    const uint8_t* buf = raw.data() + scan_from;
    int64_t buf_len = raw_carry + raw_len - scan_from;
    int64_t cap = buf_len / 36 + 2;
    t_tid.resize(cap);
    t_pos.resize(cap);
    t_end.resize(cap);
    t_mapq.resize(cap);
    t_flag.resize(cap);
    t_recoff.resize(cap);
    t_recsize.resize(cap);
    int64_t sa_cap = cap;
    t_sarec.resize(sa_cap);
    t_sastart.resize(sa_cap);
    t_saend.resize(sa_cap);
    t_samapq.resize(sa_cap);
    int64_t sa_count = 0, consumed = 0;
    int64_t n = hn_bam_scan_records(
        buf, buf_len, name_blob, name_off, n_ref, t_tid.data(), t_pos.data(),
        t_end.data(), t_mapq.data(), t_flag.data(), t_recoff.data(),
        t_recsize.data(), cap, t_sarec.data(), t_sastart.data(),
        t_saend.data(), t_samapq.data(), sa_cap, &sa_count, &consumed);
    if (n < 0) {
      ok = false;
      break;
    }
    // filter + append (SA rows remap onto filtered numbering)
    std::vector<int64_t> new_row(n, -1);
    for (int64_t i = 0; i < n; ++i) {
      if ((t_flag[i] & filter_mask) != 0) continue;
      if (t_mapq[i] < min_mapq) continue;
      if (t_tid[i] < 0) continue;
      new_row[i] = static_cast<int64_t>(res->tid.size());
      res->tid.push_back(t_tid[i]);
      res->pos.push_back(t_pos[i]);
      res->end.push_back(t_end[i]);
    }
    for (int64_t s = 0; s < sa_count; ++s) {
      int64_t row = new_row[t_sarec[s]];
      if (row < 0) continue;
      res->sa_row.push_back(row);
      res->sa_start.push_back(t_sastart[s]);
      res->sa_end.push_back(t_saend[s]);
      res->sa_mapq.push_back(t_samapq[s]);
    }
    // carries
    int64_t rem_raw = buf_len - consumed;
    std::memmove(raw.data(), buf + consumed, rem_raw);
    raw_carry = rem_raw;
    int64_t rem_comp = avail - end;
    std::memmove(comp.data(), comp.data() + end, rem_comp);
    comp_carry = rem_comp;
    if (got == 0) break;
  }
  if (raw_carry != 0) ok = false;  // truncated record stream
  std::fclose(fh);
  if (!ok) {
    delete res;
    return nullptr;
  }
  return res;
}

void hn_span_scan_counts(void* h, int64_t* n_recs, int64_t* n_sa) {
  auto* res = static_cast<span_scan::Result*>(h);
  n_recs[0] = static_cast<int64_t>(res->tid.size());
  n_sa[0] = static_cast<int64_t>(res->sa_row.size());
}

void hn_span_scan_export(void* h, int32_t* tid, int64_t* pos, int64_t* end,
                         int64_t* sa_row, int64_t* sa_start, int64_t* sa_end,
                         int64_t* sa_mapq) {
  auto* res = static_cast<span_scan::Result*>(h);
  std::memcpy(tid, res->tid.data(), res->tid.size() * 4);
  std::memcpy(pos, res->pos.data(), res->pos.size() * 8);
  std::memcpy(end, res->end.data(), res->end.size() * 8);
  std::memcpy(sa_row, res->sa_row.data(), res->sa_row.size() * 8);
  std::memcpy(sa_start, res->sa_start.data(), res->sa_start.size() * 8);
  std::memcpy(sa_end, res->sa_end.data(), res->sa_end.size() * 8);
  std::memcpy(sa_mapq, res->sa_mapq.data(), res->sa_mapq.size() * 8);
}

void hn_span_scan_free(void* h) {
  delete static_cast<span_scan::Result*>(h);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// One-pass VCF body scan.
//
// Parses decompressed VCF text once per chromosome into dense arrays so the
// three consumers that previously re-parsed records in Python — the block
// generator's merge stream (ref: src/block_gen.rs:823-974), the per-block
// variant loader (ref: src/phaser.rs:27-323), and the ordered writer's
// copy-transform (ref: src/writers/ordered_vcf_writer.rs:291-434) — all run
// from shared arrays. Classification mirrors block_gen.rs:115-312 /
// hiphase_tpu/phasing/block_gen.py exactly; records the Python layer would
// reject get vtype/zyg = -1 and are re-parsed in Python so error messages
// (and parity) are preserved.

namespace vcf_scan {

// VariantType codes (hiphase_tpu/core/variants.py)
enum : int8_t {
  kSnv = 0, kIns = 1, kDel = 2, kIndel = 3, kSvIns = 4, kSvDel = 5,
  kSvDup = 6, kSvInv = 7, kSvBnd = 8, kTr = 9, kUnknown = 10, kErr = -1
};

inline bool token_key(const uint8_t* p, const uint8_t* end, const char* key,
                      int64_t klen, const uint8_t** val, const uint8_t** vend) {
  // INFO token match: KEY=... or bare KEY flag
  if (end - p < klen) return false;
  if (std::memcmp(p, key, klen) != 0) return false;
  if (p + klen == end) {
    *val = end;
    *vend = end;
    return true;  // flag
  }
  if (p[klen] == '=') {
    *val = p + klen + 1;
    *vend = end;
    return true;
  }
  return false;
}

}  // namespace vcf_scan

extern "C" {

// Scan `text` (decompressed VCF body, may start/end mid-chromosome) for
// data lines whose CHROM equals `chrom`. Outputs are caller-allocated with
// capacity `cap` (= number of '\n' + 1 is always enough). Per line:
//   line_off/line_len: byte span of the line (without trailing newline/CR)
//   pos: 0-based POS; ref_len: REF length
//   vtype: VariantType code, or -1 when Python must re-parse (errors)
// Per (line, sample) with stride n_samples:
//   zyg: 0 homref / 1 het / 2 homalt / 3 unknown / -1 GT error-or-absent
//   gt0/gt1: first two GT allele indices (-1 = '.'); gt_phased; ploidy
//   gq / has_gq: GQ value when present
// Returns the number of matching lines, or -1 if outputs would overflow.
int64_t hn_vcf_scan(
    const uint8_t* text, int64_t len, const uint8_t* chrom, int64_t chrom_len,
    int32_t n_samples, int64_t* line_off, int64_t* line_len, int64_t* pos,
    int32_t* ref_len, int64_t* ref_off, int64_t* alt_off, int32_t* alt_len,
    int8_t* vtype, int8_t* zyg, int16_t* gt0, int16_t* gt1,
    uint8_t* gt_phased, uint8_t* ploidy, float* gq, uint8_t* has_gq,
    int64_t cap) {
  using namespace vcf_scan;
  int64_t n = 0;
  int64_t o = 0;
  while (o < len) {
    int64_t eol = o;
    while (eol < len && text[eol] != '\n') ++eol;
    int64_t llen = eol - o;
    if (llen > 0 && text[o + llen - 1] == '\r') --llen;
    const uint8_t* line = text + o;
    int64_t next = eol + 1;
    if (llen == 0 || line[0] == '#') {
      o = next;
      continue;
    }
    // tokenize tabs (fields 0..8 + samples)
    // field 0: CHROM
    int64_t t0 = 0;
    while (t0 < llen && line[t0] != '\t') ++t0;
    if (!(t0 == chrom_len &&
          std::memcmp(line, chrom, chrom_len) == 0)) {
      o = next;
      continue;
    }
    if (n >= cap) return -1;
    line_off[n] = o;
    line_len[n] = llen;

    // walk remaining fields
    const uint8_t* f[10];   // start of fields 0..9 (9 = first sample)
    int64_t flen[10];
    f[0] = line;
    flen[0] = t0;
    int nf = 1;
    int64_t i = t0;
    while (i < llen && nf < 10) {
      ++i;  // skip tab
      int64_t s = i;
      while (i < llen && line[i] != '\t') ++i;
      f[nf] = line + s;
      flen[nf] = i - s;
      ++nf;
    }
    // defaults
    pos[n] = -1;
    ref_len[n] = 0;
    ref_off[n] = o;
    alt_off[n] = o;
    alt_len[n] = 0;
    vtype[n] = kErr;
    for (int32_t s = 0; s < n_samples; ++s) {
      int64_t idx = n * n_samples + s;
      zyg[idx] = -1;
      gt0[idx] = -1;
      gt1[idx] = -1;
      gt_phased[idx] = 0;
      ploidy[idx] = 0;
      gq[idx] = 0;
      has_gq[idx] = 0;
    }
    if (nf < 8) {
      o = next;
      ++n;
      continue;  // malformed: Python re-parse
    }
    // POS (1-based int)
    int64_t p = 0;
    bool pos_ok = flen[1] > 0;
    for (int64_t k = 0; k < flen[1]; ++k) {
      uint8_t c = f[1][k];
      if (c < '0' || c > '9') {
        pos_ok = false;
        break;
      }
      p = p * 10 + (c - '0');
    }
    if (!pos_ok) {
      o = next;
      ++n;
      continue;
    }
    pos[n] = p - 1;
    ref_len[n] = static_cast<int32_t>(flen[3]);
    ref_off[n] = o + (f[3] - line);
    alt_off[n] = o + (f[4] - line);
    alt_len[n] = static_cast<int32_t>(flen[4]);

    // ALT lengths
    const uint8_t* alt = f[4];
    int64_t alen = flen[4];
    bool alt_missing = (alen == 1 && alt[0] == '.');
    int alt_count = 0;
    int64_t max_alt = 0, first_alt_len = 0;
    bool first_sym = false;
    if (!alt_missing && alen > 0) {
      int64_t s = 0;
      for (int64_t k = 0; k <= alen; ++k) {
        if (k == alen || alt[k] == ',') {
          int64_t this_len = k - s;
          if (alt_count == 0) {
            first_alt_len = this_len;
            first_sym = this_len >= 2 && alt[s] == '<' && alt[k - 1] == '>';
          }
          if (this_len > max_alt) max_alt = this_len;
          ++alt_count;
          s = k + 1;
        }
      }
    }

    // INFO: SVTYPE / TRID
    int8_t sv = -2;  // -2 = absent, -1 = unhandled value
    bool has_trid = false;
    if (flen[7] != 1 || f[7][0] != '.') {
      const uint8_t* q = f[7];
      const uint8_t* qend = q + flen[7];
      while (q < qend) {
        const uint8_t* tend = q;
        while (tend < qend && *tend != ';') ++tend;
        const uint8_t *val, *vend;
        if (token_key(q, tend, "SVTYPE", 6, &val, &vend)) {
          int64_t vl = vend - val;
          if (vl == 3 && std::memcmp(val, "DEL", 3) == 0) sv = kSvDel;
          else if (vl == 3 && std::memcmp(val, "INS", 3) == 0) sv = kSvIns;
          else if (vl == 3 && std::memcmp(val, "DUP", 3) == 0) sv = kSvDup;
          else if (vl == 3 && std::memcmp(val, "INV", 3) == 0) sv = kSvInv;
          else if (vl == 3 && std::memcmp(val, "BND", 3) == 0) sv = kSvBnd;
          else sv = -1;
        } else if (token_key(q, tend, "TRID", 4, &val, &vend)) {
          has_trid = true;
        }
        q = tend + 1;
      }
    }

    // classification (block_gen.rs:222-312)
    if (sv != -2) {
      if (alt_count != 1) vtype[n] = kErr;          // needs exactly one ALT
      else if (first_sym) vtype[n] = kUnknown;      // <DEL> placeholder
      else if (sv == -1) vtype[n] = kErr;           // unhandled SVTYPE value
      else vtype[n] = sv;
    } else if (has_trid) {
      vtype[n] = kTr;
    } else if (alt_missing || alt_count == 0) {
      vtype[n] = kUnknown;
    } else if (flen[3] == 1) {
      vtype[n] = (max_alt == 1) ? kSnv : kIns;
    } else {
      vtype[n] = (max_alt == 1) ? kDel : kIndel;
    }
    (void)first_alt_len;

    // FORMAT: GT / GQ positions
    if (nf >= 10 && n_samples > 0) {
      int gt_idx = -1, gq_idx = -1, fidx = 0;
      {
        const uint8_t* q = f[8];
        const uint8_t* qend = q + flen[8];
        while (q < qend) {
          const uint8_t* tend = q;
          while (tend < qend && *tend != ':') ++tend;
          int64_t tl = tend - q;
          if (tl == 2 && q[0] == 'G' && q[1] == 'T') gt_idx = fidx;
          if (tl == 2 && q[0] == 'G' && q[1] == 'Q') gq_idx = fidx;
          ++fidx;
          q = tend + 1;
        }
      }
      // sample columns: fields 9.. (f[] only holds up to index 9; walk on)
      const uint8_t* scol = f[9];
      int64_t scol_len = flen[9];
      int64_t walk = (f[9] - line) + flen[9];
      for (int32_t s = 0; s < n_samples; ++s) {
        if (s > 0) {
          if (walk >= llen) break;  // fewer columns than samples
          ++walk;                   // tab
          int64_t st = walk;
          while (walk < llen && line[walk] != '\t') ++walk;
          scol = line + st;
          scol_len = walk - st;
        }
        int64_t idx = n * n_samples + s;
        // split sample column by ':'
        int fi = 0;
        const uint8_t* q = scol;
        const uint8_t* qend = scol + scol_len;
        while (q <= qend) {
          const uint8_t* tend = q;
          while (tend < qend && *tend != ':') ++tend;
          int64_t tl = tend - q;
          if (fi == gt_idx && gt_idx >= 0) {
            // parse GT: a[/|b]...; '.'/'' -> -1; non-numeric -> error
            int16_t a[2] = {-1, -1};
            int pl = 0;
            bool phased = false, err = (tl == 0);
            const uint8_t* g = q;
            while (g <= tend && !err) {
              const uint8_t* ge = g;
              while (ge < tend && *ge != '/' && *ge != '|') ++ge;
              if (ge < tend && *ge == '|') phased = true;
              int64_t gl = ge - g;
              int16_t v = -1;
              if (gl == 0 || (gl == 1 && *g == '.')) {
                v = -1;
              } else {
                int64_t acc = 0;
                for (const uint8_t* c = g; c < ge; ++c) {
                  if (*c < '0' || *c > '9') {
                    err = true;
                    break;
                  }
                  acc = acc * 10 + (*c - '0');
                }
                v = static_cast<int16_t>(acc);
              }
              if (pl < 2) a[pl] = v;
              ++pl;
              if (ge >= tend) break;
              g = ge + 1;
            }
            if (!err && pl > 0) {
              gt0[idx] = a[0];
              gt1[idx] = (pl > 1) ? a[1] : a[0];
              ploidy[idx] = static_cast<uint8_t>(pl > 3 ? 3 : pl);  // >2 detectable
              gt_phased[idx] = phased ? 1 : 0;
              if (a[0] == -1 || (pl > 1 && a[1] == -1)) zyg[idx] = 3;
              else if (gt0[idx] == gt1[idx])
                zyg[idx] = (gt0[idx] == 0) ? 0 : 2;
              else zyg[idx] = 1;
            }
          } else if (fi == gq_idx && gq_idx >= 0) {
            if (!(tl == 0 || (tl == 1 && *q == '.'))) {
              // float parse (GQ may be fractional); a malformed value must
              // surface the Python parser's exception -> re-parse marker
              char buf[32];
              bool ok = false;
              if (tl < 31) {
                std::memcpy(buf, q, tl);
                buf[tl] = 0;
                char* endp = nullptr;
                double v = std::strtod(buf, &endp);
                if (endp == buf + tl) {
                  gq[idx] = static_cast<float>(v);
                  has_gq[idx] = 1;
                  ok = true;
                }
              }
              if (!ok) zyg[idx] = -1;
            }
          }
          ++fi;
          if (tend >= qend) break;
          q = tend + 1;
        }
      }
    }
    ++n;
    o = next;
  }
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Bulk VCF record copy-transform for the ordered writer.
//
// For each selected line: drop PS/PF from FORMAT and every sample column,
// rewrite GT per the solver's decision (phased h1|h2, or unphase+sort with
// missing first), and append PS/PF values when any sample in the row gets
// them. Mirrors writers/vcf_writer.py transform_record / the reference's
// strip+rewrite (ref: src/writers/ordered_vcf_writer.rs:291-434). Lines the
// parser cannot handle are flagged for Python re-parse so error behavior is
// identical.

extern "C" {

// modes per (line, sample): 0 = strip/unphase only, 1 = phased (h1|h2 + PS),
// 2 = PF=TR_OVERLAP flag.
// Outputs: `out` (capacity out_cap) receives the transformed lines, each
// newline-terminated; out_off[k] = start of line k in `out`,
// out_off[n_lines] = total. line_err[k] = 1 when Python must re-do line k
// (its bytes are then NOT in `out`; out_off still advances by 0).
// Returns total bytes written, or -1 when out_cap is insufficient.
int64_t hn_vcf_transform(
    const uint8_t* text, const int64_t* line_off, const int64_t* line_len,
    int64_t n_lines, int32_t n_samples, const uint8_t* mode,
    const uint8_t* h1, const uint8_t* h2, const int64_t* ps,
    uint8_t* out, int64_t out_cap, int64_t* out_off, uint8_t* line_err) {
  int64_t w = 0;
  for (int64_t k = 0; k < n_lines; ++k) {
    out_off[k] = w;
    line_err[k] = 0;
    const uint8_t* line = text + line_off[k];
    int64_t llen = line_len[k];
    // locate the 9 fixed fields; fx[i] = start offset of field i
    int64_t fx[10];
    int nf = 0;
    fx[nf++] = 0;
    for (int64_t i = 0; i < llen && nf < 10; ++i) {
      if (line[i] == '\t') fx[nf++] = i + 1;
    }
    if (nf < 10) {  // fewer than 9 tabs: no FORMAT/sample columns
      line_err[k] = 1;
      continue;
    }
    int64_t fmt_beg = fx[8];
    int64_t fmt_end = fx[9] - 1;
    // FORMAT keys: find GT; note PS/PF positions to drop
    int gt_idx = -1;
    int drop_idx[8];
    int n_drop = 0;
    int fidx = 0;
    bool bad = false;
    {
      int64_t q = fmt_beg;
      while (q <= fmt_end) {
        int64_t e = q;
        while (e < fmt_end && line[e] != ':') ++e;
        int64_t tl = e - q;
        if (tl == 2 && line[q] == 'G' && line[q + 1] == 'T') gt_idx = fidx;
        if (tl == 2 && line[q] == 'P' &&
            (line[q + 1] == 'S' || line[q + 1] == 'F')) {
          if (n_drop < 8) drop_idx[n_drop++] = fidx;
          else bad = true;
        }
        ++fidx;
        if (e >= fmt_end) break;
        q = e + 1;
      }
    }
    int n_keys = fidx;
    if (gt_idx < 0 || bad) {
      line_err[k] = 1;
      continue;
    }
    // row-level: does any sample get PS / PF?
    bool add_ps = false, add_pf = false;
    for (int32_t s = 0; s < n_samples; ++s) {
      uint8_t m = mode[k * n_samples + s];
      if (m == 1) add_ps = true;
      if (m == 2) add_pf = true;
    }
    int gt_out_idx = gt_idx;
    for (int d = 0; d < n_drop; ++d)
      if (drop_idx[d] < gt_idx) --gt_out_idx;
    int n_base = n_keys - n_drop;

    // capacity bound for this line
    if (w + llen + 8 + static_cast<int64_t>(n_samples) * 48 > out_cap)
      return -1;

    // copy fields 0..7 verbatim (through the tab before FORMAT)
    int64_t pre = fmt_beg;
    std::memcpy(out + w, line, pre);
    w += pre;
    // FORMAT: keys minus PS/PF, plus appended PS/PF
    {
      int64_t q = fmt_beg;
      int idx = 0, emitted = 0;
      while (q <= fmt_end) {
        int64_t e = q;
        while (e < fmt_end && line[e] != ':') ++e;
        bool dropped = false;
        for (int d = 0; d < n_drop; ++d)
          if (drop_idx[d] == idx) dropped = true;
        if (!dropped) {
          if (emitted) out[w++] = ':';
          std::memcpy(out + w, line + q, e - q);
          w += e - q;
          ++emitted;
        }
        ++idx;
        if (e >= fmt_end) break;
        q = e + 1;
      }
      if (emitted == 0) out[w++] = '.';
      if (add_ps) {
        out[w++] = ':';
        out[w++] = 'P';
        out[w++] = 'S';
      }
      if (add_pf) {
        out[w++] = ':';
        out[w++] = 'P';
        out[w++] = 'F';
      }
    }
    // sample columns
    int64_t col_beg = fx[9];
    for (int32_t s = 0; s < n_samples; ++s) {
      int64_t col_end = col_beg;
      while (col_end < llen && line[col_end] != '\t') ++col_end;
      out[w++] = '\t';
      uint8_t m = mode[k * n_samples + s];
      // split by ':', drop PS/PF positions, rewrite GT
      int64_t q = col_beg;
      int idx = 0, emitted = 0;
      int n_vals = 0;
      {  // count values for the gt_idx < len(vals) check + padding
        int64_t t = col_beg;
        n_vals = 1;
        while (t < col_end) {
          if (line[t] == ':') ++n_vals;
          ++t;
        }
      }
      while (q <= col_end) {
        int64_t e = q;
        while (e < col_end && line[e] != ':') ++e;
        bool dropped = false;
        for (int d = 0; d < n_drop; ++d)
          if (drop_idx[d] == idx) dropped = true;
        if (!dropped) {
          if (emitted) out[w++] = ':';
          int out_idx = emitted;
          if (out_idx == gt_out_idx && idx == gt_idx) {
            int64_t tl = e - q;
            if (tl == 0) {
              line_err[k] = 1;  // empty GT -> Python raises
              break;
            }
            if (m == 1) {
              int64_t ps_v = ps[k * n_samples + s];
              w += std::snprintf(reinterpret_cast<char*>(out + w), 32,
                                 "%d|%d",
                                 static_cast<int>(h1[k * n_samples + s]),
                                 static_cast<int>(h2[k * n_samples + s]));
              (void)ps_v;
            } else {
              // unphase + sort (missing '.' first)
              int64_t sep = q;
              while (sep < e && line[sep] != '/' && line[sep] != '|') ++sep;
              if (sep >= e) {
                // haploid: copy as-is
                std::memcpy(out + w, line + q, tl);
                w += tl;
              } else {
                int64_t a0 = q, a0e = sep, a1 = sep + 1, a1e = a1;
                while (a1e < e && line[a1e] != '/' && line[a1e] != '|') ++a1e;
                if (a1e != e) {
                  line_err[k] = 1;  // ploidy > 2 -> Python raises
                  break;
                }
                auto parse = [&](int64_t b, int64_t ee, long* v) -> bool {
                  if (b == ee || (ee - b == 1 && line[b] == '.')) {
                    *v = -1;
                    return true;
                  }
                  long acc = 0;
                  for (int64_t c = b; c < ee; ++c) {
                    if (line[c] < '0' || line[c] > '9') return false;
                    acc = acc * 10 + (line[c] - '0');
                  }
                  *v = acc;
                  return true;
                };
                long v0, v1;
                if (!parse(a0, a0e, &v0) || !parse(a1, a1e, &v1)) {
                  line_err[k] = 1;
                  break;
                }
                int64_t lo_b = a0, lo_e = a0e, hi_b = a1, hi_e = a1e;
                if (v1 < v0) {
                  lo_b = a1; lo_e = a1e; hi_b = a0; hi_e = a0e;
                }
                std::memcpy(out + w, line + lo_b, lo_e - lo_b);
                w += lo_e - lo_b;
                out[w++] = '/';
                std::memcpy(out + w, line + hi_b, hi_e - hi_b);
                w += hi_e - hi_b;
              }
            }
          } else {
            std::memcpy(out + w, line + q, e - q);
            w += e - q;
          }
          ++emitted;
        }
        ++idx;
        if (e >= col_end) break;
        q = e + 1;
      }
      if (line_err[k]) break;
      if (add_ps || add_pf) {
        // pad trailing-dropped values up to the base key count
        int kept = emitted;
        while (kept < n_base && kept < n_keys - n_drop) {
          if (kept > 0 || true) out[w++] = ':';
          out[w++] = '.';
          ++kept;
        }
        if (add_ps) {
          out[w++] = ':';
          if (m == 1) {
            w += std::snprintf(reinterpret_cast<char*>(out + w), 24, "%lld",
                               static_cast<long long>(ps[k * n_samples + s]));
          } else {
            out[w++] = '.';
          }
        }
        if (add_pf) {
          out[w++] = ':';
          if (m == 2) {
            std::memcpy(out + w, "TR_OVERLAP", 10);
            w += 10;
          } else {
            out[w++] = '.';
          }
        }
      }
      col_beg = col_end + 1;
    }
    if (line_err[k]) {
      w = out_off[k];  // discard partial bytes
      continue;
    }
    out[w++] = '\n';
  }
  out_off[n_lines] = w;
  return w;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// rANS 4x8 decoder (CRAM 3.0 spec §13) — the block compression method
// real-world CRAMs use for external data series. Order-0 and order-1,
// 4 interleaved 32-bit states, 12-bit frequencies. The Python module
// hiphase_tpu/io/rans.py is the specification oracle this is tested
// against (and provides the encoder).

namespace rans4x8 {

constexpr uint32_t kTotFreq = 4096;
constexpr uint32_t kShift = 12;
constexpr uint32_t kLow = 1u << 23;

struct Table {
  uint16_t freq[256] = {0};
  uint16_t cum[257] = {0};
  uint8_t lookup[kTotFreq];
  bool used = false;

  bool finish() {
    uint32_t c = 0;
    for (int s = 0; s < 256; ++s) {
      cum[s] = static_cast<uint16_t>(c);
      c += freq[s];
      if (c > kTotFreq) return false;
    }
    cum[256] = static_cast<uint16_t>(c);
    for (int s = 0; s < 256; ++s) {
      for (uint32_t k = cum[s]; k < cum[s] + freq[s]; ++k)
        lookup[k] = static_cast<uint8_t>(s);
    }
    // slots beyond the cumulative total are invalid; zero-fill so a
    // corrupt stream decodes deterministically instead of reading junk
    for (uint32_t k = c; k < kTotFreq; ++k) lookup[k] = 0;
    used = true;
    return true;
  }
};

// Reads one order-0-style frequency list into `t` (without finish()).
// Returns new position or -1 on overrun.
static int64_t read_freqs(const uint8_t* buf, int64_t pos, int64_t len,
                          Table* t) {
  if (pos >= len) return -1;
  int sym = buf[pos++];
  int last = -2;
  int rle = 0;
  for (;;) {
    if (pos >= len) return -1;
    uint32_t f = buf[pos++];
    if (f >= 128) {
      if (pos >= len) return -1;
      f = ((f & 0x7F) << 8) | buf[pos++];
    }
    t->freq[sym] = static_cast<uint16_t>(f);
    last = sym;
    if (rle > 0) {
      --rle;
      sym = last + 1;
      if (sym > 255) return -1;
    } else {
      if (pos >= len) return -1;
      sym = buf[pos++];
      if (sym == 0) break;
      if (sym == last + 1) {
        if (pos >= len) return -1;
        rle = buf[pos++];
      }
    }
  }
  return pos;
}

}  // namespace rans4x8

extern "C" {

// Decode a full rans4x8 stream (9-byte header + payload) into `out`
// (capacity out_cap). Returns the decoded size, or -1 on malformed input
// / capacity mismatch.
int64_t hn_rans_uncompress(const uint8_t* in, int64_t in_len, uint8_t* out,
                           int64_t out_cap) {
  using namespace rans4x8;
  if (in_len < 9) return -1;
  uint8_t order = in[0];
  uint32_t comp_size, out_size;
  std::memcpy(&comp_size, in + 1, 4);
  std::memcpy(&out_size, in + 5, 4);
  if (out_size == 0) return 0;
  if (static_cast<int64_t>(out_size) > out_cap) return -1;
  if (9 + static_cast<int64_t>(comp_size) > in_len) return -1;
  const uint8_t* buf = in;
  int64_t len = 9 + static_cast<int64_t>(comp_size);
  int64_t pos = 9;

  auto read_states = [&](uint32_t R[4]) -> bool {
    if (pos + 16 > len) return false;
    for (int k = 0; k < 4; ++k) {
      std::memcpy(&R[k], buf + pos, 4);
      pos += 4;
    }
    return true;
  };

  if (order == 0) {
    Table t;
    pos = read_freqs(buf, pos, len, &t);
    if (pos < 0 || !t.finish()) return -1;
    uint32_t R[4];
    if (!read_states(R)) return -1;
    for (uint32_t i = 0; i < out_size; ++i) {
      uint32_t& x = R[i & 3];
      uint32_t m = x & (kTotFreq - 1);
      uint8_t s = t.lookup[m];
      out[i] = s;
      uint32_t f = t.freq[s];
      if (f == 0) return -1;
      x = f * (x >> kShift) + m - t.cum[s];
      while (x < kLow && pos < len) x = (x << 8) | buf[pos++];
    }
    return out_size;
  }
  if (order == 1) {
    auto tables = std::make_unique<Table[]>(256);
    if (pos >= len) return -1;
    int ctx = buf[pos++];
    int last = -2;
    int rle = 0;
    for (;;) {
      pos = read_freqs(buf, pos, len, &tables[ctx]);
      if (pos < 0 || !tables[ctx].finish()) return -1;
      last = ctx;
      if (rle > 0) {
        --rle;
        ctx = last + 1;
        if (ctx > 255) return -1;
      } else {
        if (pos >= len) return -1;
        ctx = buf[pos++];
        if (ctx == 0) break;
        if (ctx == last + 1) {
          if (pos >= len) return -1;
          rle = buf[pos++];
        }
      }
    }
    uint32_t R[4];
    if (!read_states(R)) return -1;
    uint32_t isz4 = out_size >> 2;
    uint8_t L[4] = {0, 0, 0, 0};
    for (uint32_t i = 0; i < isz4; ++i) {
      for (int k = 0; k < 4; ++k) {
        uint32_t& x = R[k];
        uint32_t m = x & (kTotFreq - 1);
        const Table& t = tables[L[k]];
        if (!t.used) return -1;
        uint8_t s = t.lookup[m];
        out[k * isz4 + i] = s;
        uint32_t f = t.freq[s];
        if (f == 0) return -1;
        x = f * (x >> kShift) + m - t.cum[s];
        while (x < kLow && pos < len) x = (x << 8) | buf[pos++];
        L[k] = s;
      }
    }
    for (uint32_t i = 4 * isz4; i < out_size; ++i) {
      uint32_t& x = R[3];
      uint32_t m = x & (kTotFreq - 1);
      const Table& t = tables[L[3]];
      if (!t.used) return -1;
      uint8_t s = t.lookup[m];
      out[i] = s;
      uint32_t f = t.freq[s];
      if (f == 0) return -1;
      x = f * (x >> kShift) + m - t.cum[s];
      while (x < kLow && pos < len) x = (x << 8) | buf[pos++];
      L[3] = s;
    }
    return out_size;
  }
  return -1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Bulk BAM record retag for the ordered haplotag writer
// (ref: src/writers/ordered_bam_writer.rs:197-237): strip existing HP/PS
// aux tags and append fresh PS/HP for records whose read name is in the
// block's haplotag table. Emits serialized records (int32 size prefix +
// body) ready for the BGZF batch writer — replaces the per-record Python
// parse/strip/retag that dominated haplotagged-BAM output time.

namespace bam_retag {

// end offset of the aux entry starting at `a` (relative to rec), or -1
static int64_t aux_end(const uint8_t* rec, int64_t a, int64_t block_size) {
  if (a + 3 > block_size) return -1;
  char tc = static_cast<char>(rec[a + 2]);
  int64_t vs = a + 3;
  switch (tc) {
    case 'A': case 'c': case 'C': return vs + 1;
    case 's': case 'S': return vs + 2;
    case 'i': case 'I': case 'f': return vs + 4;
    case 'Z': case 'H': {
      int64_t ve = vs;
      while (ve < block_size && rec[ve] != 0) ++ve;
      if (ve >= block_size) return -1;
      return ve + 1;
    }
    case 'B': {
      if (vs + 5 > block_size) return -1;
      char sub = static_cast<char>(rec[vs]);
      uint32_t count;
      std::memcpy(&count, rec + vs + 1, 4);
      int w;
      switch (sub) {
        case 'c': case 'C': w = 1; break;
        case 's': case 'S': w = 2; break;
        case 'i': case 'I': case 'f': w = 4; break;
        default: return -1;
      }
      return vs + 5 + static_cast<int64_t>(w) * count;
    }
    default: return -1;
  }
}

}  // namespace bam_retag

extern "C" {

// tag table: n_tags read names (blob + offsets) with parallel ps/hp values.
// Returns total bytes written to `out`, or -1 (capacity) / -2 (malformed).
int64_t hn_bam_retag(const uint8_t* raw, const int64_t* rec_off,
                     const int64_t* rec_size, int64_t n_recs,
                     const uint8_t* tag_names, const int64_t* tag_name_off,
                     int32_t n_tags, const int32_t* tag_ps,
                     const uint8_t* tag_hp, uint8_t* out, int64_t out_cap,
                     int64_t* out_off) {
  std::unordered_map<std::string, int32_t> table;
  table.reserve(static_cast<size_t>(n_tags) * 2);
  for (int32_t t = 0; t < n_tags; ++t) {
    table.emplace(std::string(
                      reinterpret_cast<const char*>(tag_names) +
                          tag_name_off[t],
                      static_cast<size_t>(tag_name_off[t + 1] -
                                          tag_name_off[t])),
                  t);
  }
  int64_t w = 0;
  for (int64_t i = 0; i < n_recs; ++i) {
    out_off[i] = w;
    const uint8_t* rec = raw + rec_off[i];
    int64_t bs = rec_size[i];
    if (bs < 32) return -2;
    uint8_t l_read_name = rec[8];
    uint16_t n_cigar;
    std::memcpy(&n_cigar, rec + 12, 2);
    uint32_t l_seq;
    std::memcpy(&l_seq, rec + 16, 4);
    int64_t aux_off = 32 + l_read_name + 4LL * n_cigar +
                      (l_seq + 1) / 2 + l_seq;
    if (aux_off > bs) return -2;

    // locate the record in the tag table by read name (NUL-terminated)
    int32_t tag_idx = -1;
    {
      std::string name(reinterpret_cast<const char*>(rec) + 32,
                       l_read_name > 0 ? static_cast<size_t>(l_read_name - 1)
                                       : 0);
      auto it = table.find(name);
      if (it != table.end()) tag_idx = it->second;
    }

    // bound: original + size prefix + two appended tags (<= 7 bytes each)
    if (w + 4 + bs + 16 > out_cap) return -1;
    uint8_t* dst = out + w + 4;  // fill size prefix afterwards
    std::memcpy(dst, rec, aux_off);
    int64_t dlen = aux_off;
    int64_t a = aux_off;
    while (a + 3 <= bs) {
      int64_t e = bam_retag::aux_end(rec, a, bs);
      if (e < 0 || e > bs) return -2;
      bool is_hp_ps = (rec[a] == 'H' && rec[a + 1] == 'P') ||
                      (rec[a] == 'P' && rec[a + 1] == 'S');
      if (!is_hp_ps) {
        std::memcpy(dst + dlen, rec + a, e - a);
        dlen += e - a;
      }
      a = e;
    }
    if (a < bs) {
      // 1-2 trailing bytes the scanner tolerated: preserve them verbatim
      // (the Python per-record path copies them, and byte parity between
      // the two writer paths is the contract)
      std::memcpy(dst + dlen, rec + a, bs - a);
      dlen += bs - a;
    }
    if (tag_idx >= 0) {
      // PS then HP, width by value (matches BamRecord.with_int_tags)
      int32_t ps = tag_ps[tag_idx];
      if (ps >= 0 && ps <= 255) {
        dst[dlen++] = 'P';
        dst[dlen++] = 'S';
        dst[dlen++] = 'C';
        dst[dlen++] = static_cast<uint8_t>(ps);
      } else {
        dst[dlen++] = 'P';
        dst[dlen++] = 'S';
        dst[dlen++] = 'i';
        std::memcpy(dst + dlen, &ps, 4);
        dlen += 4;
      }
      dst[dlen++] = 'H';
      dst[dlen++] = 'P';
      dst[dlen++] = 'C';
      dst[dlen++] = tag_hp[tag_idx];
    }
    uint32_t sz = static_cast<uint32_t>(dlen);
    std::memcpy(out + w, &sz, 4);
    w += 4 + dlen;
  }
  out_off[n_recs] = w;
  return w;
}

}  // extern "C"
