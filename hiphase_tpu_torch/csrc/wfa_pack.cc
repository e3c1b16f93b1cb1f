// The device WFA's window packer: every read window of a block built as a
// graph (hn_wfa_build, wfa_build.h) and laid out straight into the batch
// that the graph-WFA kernel reads (align/wfa_device.py's PairBatch), in
// one call per pass with no Python object per read.
//
// For each read it does what these do in Python, and gives the same words:
//   * global_realign.py::read_window: the window graph over the block's
//     variants inside [ref_start, ref_end) (WFAGraph's native route, with
//     its capacities);
//   * wfa_device.py::linearize_graph: minpath and maxpath of every node,
//     the spread, one position a base and one for an eps node, each
//     position's band center after it (c_out), the parents' shifts;
//   * wfa_device.py::_padded_arrays: G to a multiple of 64, the parent
//     count P to a multiple of 2, the nodes N to a multiple of 16;
//   * wfa_device.py::_graph_record: a position as (c_out, code) with
//     code = char | eps << 8 | start << 9 | end << 10 | node << 11, and the
//     parent tables by node.
// A read's node-to-allele triples carry the block's variant index.
//
// Two passes over the same inputs, each one call: the sizing pass (flat
// null) writes each read's sizes; the caller lays the batch out from them
// and the writing pass builds every graph again (the build is a small part
// of the work) and writes it there. A read whose build is refused (over
// the builder's capacities, 2^20 nodes or more, or a window past the
// chromosome's end) is marked and left to the caller, as are the words
// of its graph; its read bytes are written.
//
// Plain C ABI for ctypes (which releases the interpreter lock for the
// call). Build: g++ -O3 -std=c++17 -fPIC -shared.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include "wfa_build.h"

namespace {

// a read's row of sizes: built (1) or refused (0), G, N, P (padded),
// last node, band center at the end, spread, node-to-allele triples
constexpr int kInfo = 8;
constexpr int64_t kMaxNodes = int64_t{1} << 20;

int64_t pad_up(int64_t n, int64_t mult) {
  return std::max(mult, (n + mult - 1) / mult * mult);
}

struct Block {
  const uint8_t* reference;
  int64_t reference_len;
  int32_t n_variants;
  const int64_t* var_pos;
  const int64_t* var_ref_len;
  const int32_t* var_index;
  const uint8_t* a0_is_alt;
  const uint8_t* a_blob;
  const int64_t* a0_off;
  const int64_t* a0_len;
  const int64_t* a1_off;
  const int64_t* a1_len;
};

// One read's window graph with its parents and path lengths.
struct Window {
  std::vector<int64_t> node_off;
  std::vector<uint8_t> node_blob;
  std::vector<int64_t> edge_off;
  std::vector<int32_t> edge_dst;
  std::vector<int32_t> alle_node, alle_var;
  std::vector<uint8_t> alle_val;
  int64_t n_nodes = 0, n_alleles = 0;
  std::vector<int64_t> par_off;     // parents of node i: par[par_off[i]..]
  std::vector<int32_t> par;         // ascending, as WFAGraph lists them
  std::vector<int64_t> minpath;
  int64_t row[kInfo] = {0};

  int64_t len(int64_t i) const { return node_off[i + 1] - node_off[i]; }

  // Build the graph of [ref_start, ref_end) and size it; false when
  // refused.
  bool build(const Block& b, int64_t ref_start, int64_t ref_end) {
    std::fill(row, row + kInfo, 0);
    if (ref_start < 0 || ref_end < ref_start || ref_end > b.reference_len) {
      return false;
    }
    // the variants inside the window: those WFAGraph's native route gets
    // from read_window's het and hom slices, so the same capacities
    const int64_t* lo = std::lower_bound(b.var_pos, b.var_pos + b.n_variants,
                                         ref_start);
    const int64_t* hi = std::upper_bound(lo, b.var_pos + b.n_variants,
                                         ref_end - 1);
    const int64_t v0 = lo - b.var_pos;
    const int64_t n = hi - lo;
    int64_t allele_bytes = 0;
    for (int64_t v = v0; v < v0 + n; ++v) {
      allele_bytes += b.a0_len[v] + b.a1_len[v];
    }
    const int64_t node_cap = 3 * n + 4;
    const int64_t blob_cap = (ref_end - ref_start) + allele_bytes + 16;
    const int64_t edge_cap = 8 * n + 16;
    const int64_t alle_cap = 2 * n + 2;
    node_off.assign(node_cap + 1, 0);
    node_blob.resize(blob_cap);
    edge_off.assign(node_cap + 1, 0);
    edge_dst.resize(edge_cap);
    alle_node.resize(alle_cap);
    alle_var.resize(alle_cap);
    alle_val.resize(alle_cap);
    n_nodes = hn_wfa_build(
        b.reference, ref_start, ref_end, static_cast<int32_t>(n),
        b.var_pos + v0, b.var_ref_len + v0, b.var_index + v0,
        b.a0_is_alt + v0, b.a_blob, b.a0_off + v0, b.a0_len + v0,
        b.a1_off + v0, b.a1_len + v0, node_off.data(), node_blob.data(),
        node_cap, blob_cap, edge_off.data(), edge_dst.data(), edge_cap,
        alle_node.data(), alle_var.data(), alle_val.data(), alle_cap,
        &n_alleles);
    if (n_nodes < 1 || n_nodes >= kMaxNodes) return false;

    // parents from the successor lists, in ascending parent order
    par_off.assign(n_nodes + 1, 0);
    for (int64_t e = 0; e < edge_off[n_nodes]; ++e) ++par_off[edge_dst[e] + 1];
    for (int64_t i = 0; i < n_nodes; ++i) par_off[i + 1] += par_off[i];
    par.resize(par_off[n_nodes]);
    std::vector<int64_t> fill(par_off.begin(), par_off.end() - 1);
    for (int64_t p = 0; p < n_nodes; ++p) {
      for (int64_t e = edge_off[p]; e < edge_off[p + 1]; ++e) {
        par[fill[edge_dst[e]]++] = static_cast<int32_t>(p);
      }
    }

    minpath.assign(n_nodes, 0);
    std::vector<int64_t> maxpath(n_nodes, 0);
    int64_t spread = 0, total = 0, most_parents = 1;
    for (int64_t i = 0; i < n_nodes; ++i) {
      if (i > 0) {
        int64_t mn = INT64_MAX, mx = INT64_MIN;
        for (int64_t e = par_off[i]; e < par_off[i + 1]; ++e) {
          const int64_t p = par[e];
          mn = std::min(mn, minpath[p] + len(p));
          mx = std::max(mx, maxpath[p] + len(p));
        }
        minpath[i] = mn;
        maxpath[i] = mx;
      }
      spread = std::max(spread, maxpath[i] - minpath[i]);
      total += std::max<int64_t>(len(i), 1);
      most_parents = std::max(most_parents, par_off[i + 1] - par_off[i]);
    }
    row[0] = 1;
    row[1] = pad_up(total, 64);
    row[2] = pad_up(n_nodes, 16);
    row[3] = pad_up(most_parents, 2);
    row[4] = n_nodes - 1;
    row[5] = minpath[n_nodes - 1] + len(n_nodes - 1);
    row[6] = spread;
    row[7] = n_alleles;
    return true;
  }

  // The graph's positions at pos ([G, 2] int32) and its parent tables at
  // pidx / psh ([N, P] int32).
  void write(int32_t* pos, int32_t* pidx, int32_t* psh, int64_t P) const {
    const int64_t last = n_nodes - 1;
    int64_t g = 0;
    for (int64_t i = 0; i < n_nodes; ++i) {
      const int64_t L = len(i);
      const int32_t flags = (i > 0 ? 1 << 9 : 0)
                            | static_cast<int32_t>(i << 11);
      if (L == 0) {
        pos[2 * g] = static_cast<int32_t>(minpath[i]);
        pos[2 * g + 1] = flags | 0xFF | 1 << 8 | 1 << 10;
        ++g;
        continue;
      }
      const uint8_t* seq = node_blob.data() + node_off[i];
      for (int64_t j = 0; j < L; ++j, ++g) {
        int32_t code = seq[j] | static_cast<int32_t>(i << 11);
        if (j == 0 && i > 0) code |= 1 << 9;
        if (j == L - 1) code |= 1 << 10;
        pos[2 * g] = static_cast<int32_t>(minpath[i] + j + 1);
        pos[2 * g + 1] = code;
      }
    }
    // pad positions: eps pass-throughs of the final column
    for (; g < row[1]; ++g) {
      pos[2 * g] = static_cast<int32_t>(row[5]);
      pos[2 * g + 1] = 0xFF | 1 << 8 | static_cast<int32_t>(last << 11);
    }
    std::fill(pidx, pidx + row[2] * P, -1);
    std::fill(psh, psh + row[2] * P, 0);
    for (int64_t i = 1; i < n_nodes; ++i) {
      for (int64_t e = par_off[i]; e < par_off[i + 1]; ++e) {
        const int64_t p = par[e];
        pidx[i * P + (e - par_off[i])] = static_cast<int32_t>(p);
        psh[i * P + (e - par_off[i])] =
            static_cast<int32_t>(minpath[p] + len(p) - minpath[i]);
      }
    }
  }
};

}  // namespace

extern "C" {

// Pack the windows of n_reads reads against one block's variants.
//
// The block (global_realign.py's WfaBlockPack): n_variants het and hom
// variants sorted by position, hets with their block index in var_index
// and homs with -1, their truncated alleles in a_blob; the chromosome
// reference[0, reference_len). Read k: the window [ref_start[k],
// ref_end[k]) and its aligned bases read_blob[read_off[k], read_off[k+1]).
//
// Sizing pass (flat null): info [n_reads, 8] gets each read's row (built,
// G, N, P, last node, c_end, spread, triples). Writing pass: the caller
// passes the rows back with the batch's layout: P, each read's position
// offset goff, node offset gnoff and read-byte offset roff, the four
// section starts in words (sections[0..4], the fifth the end) and the
// int32 buffer flat of sections[4] words, zeroed; and tri_off, each built
// read's first triple in tri_node / tri_var / tri_val.
//
// Returns 0, or -1 when an input is out of range or a rebuilt window does
// not match its row (nothing is then promised of the outputs).
int64_t hn_wfa_pack_windows(
    const uint8_t* reference, int64_t reference_len, int32_t n_variants,
    const int64_t* var_pos, const int64_t* var_ref_len,
    const int32_t* var_index, const uint8_t* a0_is_alt, const uint8_t* a_blob,
    const int64_t* a0_off, const int64_t* a0_len, const int64_t* a1_off,
    const int64_t* a1_len, int64_t n_reads, const int64_t* ref_start,
    const int64_t* ref_end, const uint8_t* read_blob, const int64_t* read_off,
    int64_t* info, int64_t P, const int64_t* goff, const int64_t* gnoff,
    const int64_t* roff, const int64_t* sections, int32_t* flat,
    const int64_t* tri_off, int32_t* tri_node, int32_t* tri_var,
    uint8_t* tri_val) {
  if (n_reads < 0 || n_variants < 0 || reference_len < 0) return -1;
  const Block block{reference, reference_len, n_variants, var_pos,
                    var_ref_len, var_index, a0_is_alt, a_blob,
                    a0_off, a0_len, a1_off, a1_len};
  Window w;
  if (flat == nullptr) {
    for (int64_t k = 0; k < n_reads; ++k) {
      w.build(block, ref_start[k], ref_end[k]);
      std::copy(w.row, w.row + kInfo, info + kInfo * k);
    }
    return 0;
  }
  if (P < 2) return -1;
  uint8_t* reads = reinterpret_cast<uint8_t*>(flat + sections[3]);
  const int64_t read_bytes = 4 * (sections[4] - sections[3]);
  for (int64_t k = 0; k < n_reads; ++k) {
    const int64_t* row = info + kInfo * k;
    const int64_t rlen = read_off[k + 1] - read_off[k];
    if (rlen < 0 || roff[k] < 0 || roff[k] + rlen > read_bytes) return -1;
    std::memcpy(reads + roff[k], read_blob + read_off[k], rlen);
    if (!row[0]) continue;
    if (!w.build(block, ref_start[k], ref_end[k]) ||
        !std::equal(w.row, w.row + kInfo, row) || row[3] > P ||
        goff[k] < 0 || 2 * (goff[k] + row[1]) > sections[1] ||
        gnoff[k] < 0 ||
        sections[1] + (gnoff[k] + row[2]) * P > sections[2] ||
        sections[2] + (gnoff[k] + row[2]) * P > sections[3]) {
      return -1;
    }
    w.write(flat + 2 * goff[k], flat + sections[1] + gnoff[k] * P,
            flat + sections[2] + gnoff[k] * P, P);
    for (int64_t t = 0; t < w.n_alleles; ++t) {
      tri_node[tri_off[k] + t] = w.alle_node[t];
      tri_var[tri_off[k] + t] = w.alle_var[t];
      tri_val[tri_off[k] + t] = w.alle_val[t];
    }
  }
  return 0;
}

}  // extern "C"
