// Pass 1 of the device WFA: every read of a block, from its raw BAM record
// (io/bam.py's BamReader.fetch_raw), to the window the graph WFA aligns it
// in and the bases it aligns, in one call a block with no Python object
// per read.
//
// For each record it does what these do in Python, and gives the same
// values:
//   * read_parsing.py::build_r2q and global_realign.py::_read_overlaps:
//     one walk of the CIGAR finds the first and the last reference base of
//     an M/=/X op (min_position, max_position) and the query positions of
//     those two bases; the read has a window when a het lies in
//     [min_position, max_position] (np.searchsorted over the block's het
//     positions: left at the minimum, right at the maximum);
//   * global_realign.py::_aligned_span: BamRecord.query_sequence sliced to
//     the bases from the first to the last of those query positions,
//     decoded from the 4-bit codes (SEQ_NT16) and nothing else of the read.
// A read with a window gets ref_start = min_position, ref_end =
// max_position + 1 and its bases read_blob[read_off[i], read_off[i + 1]);
// a read without one gets an empty range.
//
// The call refuses the whole block where the Python would not answer the
// same way for certain: a record too short for its fields, a CIGAR op past
// X, a read with no aligned base (the Python asserts), an aligned query
// position past l_seq, or het positions out of order. The caller then runs
// the Python pass 1, which raises or answers as it always has.
//
// Plain C ABI for ctypes (which releases the interpreter lock for the
// call). Build: g++ -O3 -std=c++17 -fPIC -shared.

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

constexpr char kSeqNt16[] = "=ACMGRSVTWYHKDBN";

// two bases of one packed byte, high nibble first
struct PairTable {
  uint8_t pair[256][2];
  PairTable() {
    for (int b = 0; b < 256; ++b) {
      pair[b][0] = static_cast<uint8_t>(kSeqNt16[b >> 4]);
      pair[b][1] = static_cast<uint8_t>(kSeqNt16[b & 0xF]);
    }
  }
};

const PairTable kPairs;

// Bases [q0, q1] of the packed sequence seq into out.
void decode(const uint8_t* seq, int64_t q0, int64_t q1, uint8_t* out) {
  int64_t q = q0;
  if (q & 1) {
    *out++ = kPairs.pair[seq[q >> 1]][1];
    ++q;
  }
  for (; q + 1 <= q1; q += 2, out += 2) {
    std::memcpy(out, kPairs.pair[seq[q >> 1]], 2);
  }
  if (q == q1) *out = kPairs.pair[seq[q >> 1]][0];
}

template <typename T>
T load(const uint8_t* p) {
  T v;
  std::memcpy(&v, p, sizeof v);
  return v;
}

}  // namespace

extern "C" {

// Pass 1 over a block's records. Chunk c is the buffer chunk_ptr[c] of
// chunk_len[c] bytes; its records are chunk_first[c] .. chunk_first[c + 1]
// - 1, record i's body (no size prefix) at rec_off[i] of rec_size[i]
// bytes. het_pos: the block's n_het het positions. Outputs, for every
// record i: has_window[i], ref_start[i] and ref_end[i] (set where it has
// a window), read_off[i + 1] (read_off[0] = 0); the bases go to read_blob,
// of blob_cap bytes.
//
// Returns the number of reads with a window; -1 when an input is out of
// range, -2 for a malformed record or a CIGAR op past X, -3 for a read
// with no aligned base, -4 for a query position past the read's bases, -5
// for het positions out of order (nothing is then promised of the
// outputs).
int64_t hn_wfa_windows(int64_t n_chunks, const uint64_t* chunk_ptr,
                       const int64_t* chunk_len, const int64_t* chunk_first,
                       const int64_t* rec_off, const int64_t* rec_size,
                       int64_t n_het, const int64_t* het_pos,
                       uint8_t* has_window, int64_t* ref_start,
                       int64_t* ref_end, uint8_t* read_blob, int64_t blob_cap,
                       int64_t* read_off) {
  if (n_chunks < 0 || n_het < 0 || blob_cap < 0 || chunk_first[0] != 0) {
    return -1;
  }
  for (int64_t v = 1; v < n_het; ++v) {
    if (het_pos[v] < het_pos[v - 1]) return -5;
  }
  const int64_t* het_end = het_pos + n_het;
  int64_t n_windows = 0;
  int64_t blob = 0;
  read_off[0] = 0;
  for (int64_t c = 0; c < n_chunks; ++c) {
    const uint8_t* buf = reinterpret_cast<const uint8_t*>(chunk_ptr[c]);
    if (chunk_first[c + 1] < chunk_first[c]) return -1;
    for (int64_t i = chunk_first[c]; i < chunk_first[c + 1]; ++i) {
      const int64_t size = rec_size[i];
      if (rec_off[i] < 0 || size < 32 || rec_off[i] + size > chunk_len[c]) {
        return -1;
      }
      const uint8_t* rec = buf + rec_off[i];
      const int64_t pos = load<int32_t>(rec + 4);
      const int64_t cigar_off = 32 + int64_t{rec[8]};
      const int64_t n_cigar = load<uint16_t>(rec + 12);
      const int64_t l_seq = load<uint32_t>(rec + 16);
      const int64_t seq_off = cigar_off + 4 * n_cigar;
      if (seq_off + (l_seq + 1) / 2 + l_seq > size) return -2;

      // the first and the last aligned base, and their query positions
      int64_t qpos = 0, rpos = pos;
      int64_t min_position = -1, max_position = -1, q_min = -1, q_max = -1;
      for (int64_t k = 0; k < n_cigar; ++k) {
        const uint32_t v = load<uint32_t>(rec + cigar_off + 4 * k);
        const int64_t len = v >> 4;
        switch (v & 0xF) {
          case 0: case 7: case 8:  // M = X
            if (len > 0) {
              if (q_min < 0) {
                min_position = rpos;
                q_min = qpos;
              }
              max_position = rpos + len - 1;
              q_max = qpos + len - 1;
            }
            qpos += len;
            rpos += len;
            break;
          case 1: case 4:  // I S
            qpos += len;
            break;
          case 2: case 3:  // D N
            rpos += len;
            break;
          case 5: case 6:  // H P
            break;
          default:
            return -2;
        }
      }
      if (q_min < 0) return -3;

      const int64_t* lo = std::lower_bound(het_pos, het_end, min_position);
      const int64_t* hi = std::upper_bound(het_pos, het_end, max_position);
      if (hi > lo) {
        if (q_max >= l_seq) return -4;
        const int64_t n = q_max - q_min + 1;
        if (blob + n > blob_cap) return -1;
        decode(rec + seq_off, q_min, q_max, read_blob + blob);
        blob += n;
        has_window[i] = 1;
        ref_start[i] = min_position;
        ref_end[i] = max_position + 1;
        ++n_windows;
      } else {
        has_window[i] = 0;
      }
      read_off[i + 1] = blob;
    }
  }
  return n_windows;
}

}  // extern "C"
